"""Dataset fetchers: CIFAR-10, Curves, LFW.

The port's copy of deeplearning4j_tpu/datasets/fetchers.py (numpy; PIL is
imported only to read real LFW images).

TPU-native equivalent of reference deeplearning4j-core
datasets/fetchers/ + datasets/iterator/impl/ (CifarDataSetIterator,
CurvesDataSetIterator, LFWDataSetIterator). Like the MNIST fetcher
(mnist.py), each resolves a local data directory first and falls back to a
deterministic synthetic stand-in (flagged `.synthetic`) because this
environment has no network egress.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator


class _ArrayIterator(DataSetIterator):
    def __init__(self, x, y, batch_size, shuffle=True, seed=123):
        if shuffle:
            idx = np.random.default_rng(seed).permutation(len(x))
            x, y = x[idx], y[idx]
        self._x, self._y = x, y
        self.batch_size = int(batch_size)
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._x)

    def next_batch(self):
        i, j = self._pos, self._pos + self.batch_size
        self._pos = j
        return DataSet(self._x[i:j], self._y[i:j])

    def reset(self):
        self._pos = 0

    def batch(self):
        return self.batch_size

    def total_outcomes(self):
        return int(self._y.shape[-1])

    def input_columns(self):
        return int(np.prod(self._x.shape[1:]))


def _data_dir(name, env):
    return os.environ.get(env, os.path.join(
        os.path.expanduser("~"), ".deeplearning4j_tpu", name))


def _synthetic_images(n, h, w, c, classes, seed):
    protos = np.random.default_rng(555).random((classes, h, w, c)).astype(
        np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    x = np.clip(protos[labels]
                + rng.normal(0, 0.3, (n, h, w, c)).astype(np.float32), 0, 1)
    y = np.eye(classes, dtype=np.float32)[labels]
    return x, y


class CifarDataSetIterator(_ArrayIterator):
    """CIFAR-10 NHWC [32,32,3] in [0,1].
    reference: datasets/iterator/impl/CifarDataSetIterator.java. Reads the
    python-pickle batches from `$DL4J_TPU_CIFAR_DIR` (cifar-10-batches-py);
    synthetic fallback otherwise."""

    def __init__(self, batch_size, num_examples=None, train=True,
                 shuffle=True, seed=123):
        self.synthetic = False
        try:
            x, y = self._load_real(train)
        except (FileNotFoundError, OSError):
            self.synthetic = True
            n = num_examples or (50000 if train else 10000)
            x, y = _synthetic_images(min(n, 50000), 32, 32, 3, 10,
                                     seed if train else seed + 1)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, batch_size, shuffle, seed)

    @staticmethod
    def _load_real(train):
        d = _data_dir("cifar10", "DL4J_TPU_CIFAR_DIR")
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        xs, ys = [], []
        for fn in files:
            with open(os.path.join(d, fn), "rb") as fh:
                batch = pickle.load(fh, encoding="bytes")
            data = batch[b"data"].reshape(-1, 3, 32, 32)
            xs.append(data.transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
            ys.append(np.asarray(batch[b"labels"]))
        x = np.concatenate(xs)
        y = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
        return x, y


class CurvesDataSetIterator(_ArrayIterator):
    """Curves dataset (deep-autoencoder benchmark: synthetic curve images).
    reference: datasets/fetchers/CurvesDataFetcher.java (downloads a
    serialized DataSet; here curves are generated: random cubic Bezier
    rasterized to 28x28)."""

    def __init__(self, batch_size, num_examples=2000, seed=123):
        self.synthetic = True
        rng = np.random.default_rng(seed)
        n = int(num_examples)
        imgs = np.zeros((n, 28, 28), np.float32)
        ts = np.linspace(0, 1, 60)
        basis = np.stack([(1 - ts) ** 3, 3 * ts * (1 - ts) ** 2,
                          3 * ts ** 2 * (1 - ts), ts ** 3], axis=1)
        for i in range(n):
            pts = rng.random((4, 2)) * 27          # control points
            curve = basis @ pts                     # [60, 2]
            xi = np.clip(curve[:, 0].round().astype(int), 0, 27)
            yi = np.clip(curve[:, 1].round().astype(int), 0, 27)
            imgs[i, yi, xi] = 1.0
        x = imgs.reshape(n, 784)
        super().__init__(x, x.copy(), batch_size, shuffle=False, seed=seed)


class LFWDataSetIterator(_ArrayIterator):
    """LFW faces. reference: datasets/iterator/impl/LFWDataSetIterator.java /
    fetchers/LFWDataFetcher.java. Reads per-person image directories under
    `$DL4J_TPU_LFW_DIR` (requires pillow if real data is used); synthetic
    face-blob fallback otherwise."""

    def __init__(self, batch_size, num_examples=None, image_shape=(64, 64, 3),
                 num_classes=10, shuffle=True, seed=123):
        self.synthetic = False
        h, w, c = image_shape
        try:
            x, y = self._load_real(h, w, num_classes)
        except Exception:
            self.synthetic = True
            n = num_examples or 400
            x, y = _synthetic_images(n, h, w, c, num_classes, seed)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, batch_size, shuffle, seed)

    @staticmethod
    def _load_real(h, w, num_classes):
        from PIL import Image
        d = _data_dir("lfw", "DL4J_TPU_LFW_DIR")
        people = sorted(os.listdir(d))[:num_classes]
        if not people:
            raise FileNotFoundError(d)
        xs, ys = [], []
        for ci, person in enumerate(people):
            pd = os.path.join(d, person)
            for fn in sorted(os.listdir(pd)):
                img = Image.open(os.path.join(pd, fn)).convert("RGB")
                img = img.resize((w, h))
                xs.append(np.asarray(img, np.float32) / 255.0)
                ys.append(ci)
        x = np.stack(xs)
        y = np.eye(len(people), dtype=np.float32)[np.asarray(ys)]
        return x, y
