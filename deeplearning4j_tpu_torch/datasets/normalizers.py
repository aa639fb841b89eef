"""Data normalizers — fit on training data, transform DataSets.

Port of deeplearning4j_tpu/datasets/normalizers.py. The statistics and the
host transforms are the reference's numpy code; the device transform
(`device_apply`, `as_device_transform`) is plain torch on tensors, with
each constant rounded to the input's dtype first, as the reference's
jax.numpy does, and each affine map rounded as the reference's compiled
one (`Normalizer._affine`).

TPU-native equivalent of ND4J's DataNormalization family used by the
reference (NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessing
scaler), persisted as `normalizer.bin` inside ModelSerializer zips
(reference util/ModelSerializer.java — normalizer entry).
"""
from __future__ import annotations

import numpy as np
import torch

from .iterators import DataSetIterator, _torch_dtype

NORMALIZER_REGISTRY = {}


def _register(name):
    def deco(cls):
        NORMALIZER_REGISTRY[name] = cls
        cls.kind = name
        return cls
    return deco


class Normalizer:
    def fit(self, data):
        """data: DataSet or DataSetIterator."""
        raise NotImplementedError

    def transform(self, ds):
        raise NotImplementedError

    def pre_process(self, ds):
        return self.transform(ds)

    preProcess = pre_process

    def to_dict(self):
        raise NotImplementedError

    def device_apply(self, x):
        """The transform of a features tensor on its device, so
        AsyncDataSetIterator can ship raw uint8 pixels over the wire (4x
        fewer bytes than float32) and normalize on the card. Any input
        dtype: integer inputs are promoted to float32 (`_float_input`)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no device-side transform")

    @staticmethod
    def _float_input(x):
        """Promote integer/bool tensors (raw uint8 pixels on the wire) to
        float32 so scale constants don't truncate to 0."""
        return x if x.is_floating_point() else x.to(torch.float32)

    @staticmethod
    def _const(c, x):
        """A constant (numpy or Python) rounded to x's dtype: a scalar stays
        a 0-d CPU tensor (an operand of a CUDA op without a copy), an array
        goes to x's device."""
        t = torch.as_tensor(np.asarray(c))
        return t.to(x.dtype) if t.ndim == 0 else t.to(x.device, x.dtype)

    @classmethod
    def _affine(cls, x, a, b):
        """x * a + b, rounded as the reference's compiled transform is:
        XLA fuses a float32 (or float64) x * a + b into one multiply-add,
        so here the product and the sum run in float64, where the product
        of two float32 values is exact, and the result is rounded once to
        x's type; it runs bf16 and fp16 arithmetic op by op in float32,
        rounding each op's result, as torch does."""
        x = cls._float_input(x)
        a, b = cls._const(a, x), cls._const(b, x)
        if x.dtype in (torch.bfloat16, torch.float16):
            return x * a + b
        return (x.double() * a.double() + b.double()).to(x.dtype)

    def as_device_transform(self, dtype=None):
        """Callable for AsyncDataSetIterator(device_transform=...).
        dtype=None applies device_apply directly (integer wire formats are
        promoted to float32); a compute dtype (e.g. "bfloat16" for a bf16
        model) also casts on the device first, halving the staged batch's
        bytes, which is only safe where the step would cast anyway.
        Memoized per dtype (re-fitting clears the memo). The statistics
        are read when the function is called."""
        dt = None if dtype is None else _torch_dtype(dtype)
        cache = self.__dict__.setdefault("_device_transform_cache", {})
        if dt not in cache:
            if dt is None:
                cache[dt] = self.device_apply
            else:
                cache[dt] = lambda x: self.device_apply(x.to(dt))
        return cache[dt]

    @staticmethod
    def from_dict(d):
        kind = d["kind"]
        if kind not in NORMALIZER_REGISTRY:
            raise ValueError(f"Unknown normalizer '{kind}'")
        return NORMALIZER_REGISTRY[kind]._from_dict(d)


def _iter_features(data):
    if isinstance(data, DataSetIterator):
        data.reset()
        while data.has_next():
            yield data.next_batch().features
        data.reset()
    else:
        yield data.features


@_register("standardize")
class NormalizerStandardize(Normalizer):
    """Zero-mean unit-variance per feature (ND4J NormalizerStandardize)."""

    def __init__(self, mean=None, std=None):
        self.mean = mean
        self.std = std

    def fit(self, data):
        self.__dict__.pop("_device_transform_cache", None)
        n, s, s2 = 0, None, None
        for f in _iter_features(data):
            f = f.reshape(-1, f.shape[-1]).astype(np.float64)
            if s is None:
                s = f.sum(axis=0)
                s2 = (f * f).sum(axis=0)
            else:
                s += f.sum(axis=0)
                s2 += (f * f).sum(axis=0)
            n += f.shape[0]
        self.mean = (s / n).astype(np.float32)
        var = s2 / n - (s / n) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        return self

    def transform(self, ds):
        ds.features = ((ds.features - self.mean) / self.std).astype(
            ds.features.dtype)
        return ds

    def device_apply(self, x):
        x = self._float_input(x)
        mean = np.asarray(self.mean)
        inv = 1.0 / np.asarray(self.std)
        return (x - self._const(mean, x)) * self._const(inv, x)

    def to_dict(self):
        return {"kind": "standardize", "mean": self.mean.tolist(),
                "std": self.std.tolist()}

    @classmethod
    def _from_dict(cls, d):
        return cls(np.asarray(d["mean"], np.float32),
                   np.asarray(d["std"], np.float32))


@_register("minmax")
class NormalizerMinMaxScaler(Normalizer):
    """Scale features into [min_range, max_range] (ND4J NormalizerMinMaxScaler)."""

    def __init__(self, min_range=0.0, max_range=1.0, data_min=None,
                 data_max=None):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.data_min = data_min
        self.data_max = data_max

    def fit(self, data):
        self.__dict__.pop("_device_transform_cache", None)
        lo, hi = None, None
        for f in _iter_features(data):
            f = f.reshape(-1, f.shape[-1])
            fl, fh = f.min(axis=0), f.max(axis=0)
            lo = fl if lo is None else np.minimum(lo, fl)
            hi = fh if hi is None else np.maximum(hi, fh)
        self.data_min = lo.astype(np.float32)
        self.data_max = hi.astype(np.float32)
        return self

    def transform(self, ds):
        span = np.maximum(self.data_max - self.data_min, 1e-12)
        scaled = (ds.features - self.data_min) / span
        ds.features = (scaled * (self.max_range - self.min_range)
                       + self.min_range).astype(ds.features.dtype)
        return ds

    def device_apply(self, x):
        span = np.maximum(self.data_max - self.data_min, 1e-12)
        a = ((self.max_range - self.min_range) / span).astype(np.float32)
        b = (self.min_range - self.data_min * a).astype(np.float32)
        return self._affine(x, a, b)

    def to_dict(self):
        return {"kind": "minmax", "minRange": self.min_range,
                "maxRange": self.max_range,
                "dataMin": self.data_min.tolist(),
                "dataMax": self.data_max.tolist()}

    @classmethod
    def _from_dict(cls, d):
        return cls(d.get("minRange", 0.0), d.get("maxRange", 1.0),
                   np.asarray(d["dataMin"], np.float32),
                   np.asarray(d["dataMax"], np.float32))


@_register("imagescaler")
class ImagePreProcessingScaler(Normalizer):
    """Scale pixel values [0, max_pixel] -> [0,1] (ND4J ImagePreProcessingScaler)."""

    def __init__(self, min_range=0.0, max_range=1.0, max_pixel=255.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.max_pixel = float(max_pixel)

    def fit(self, data):
        return self

    def transform(self, ds):
        scaled = ds.features / self.max_pixel
        ds.features = (scaled * (self.max_range - self.min_range)
                       + self.min_range).astype(np.float32)
        return ds

    def device_apply(self, x):
        a = (self.max_range - self.min_range) / self.max_pixel
        return self._affine(x, a, self.min_range)

    def to_dict(self):
        return {"kind": "imagescaler", "minRange": self.min_range,
                "maxRange": self.max_range, "maxPixel": self.max_pixel}

    @classmethod
    def _from_dict(cls, d):
        return cls(d.get("minRange", 0.0), d.get("maxRange", 1.0),
                   d.get("maxPixel", 255.0))
