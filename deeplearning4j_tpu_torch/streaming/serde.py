"""Array / DataSet / record wire serde for streaming transport.

The port of deeplearning4j_tpu/streaming/serde.py. The port's `DataSet`
keeps its arrays as it was given them, numpy arrays or tensors on any
device, so the encoders bring a tensor to the host as it is
(`detach().cpu().numpy()`, no layout change) where the reference calls
`np.asarray`. The wire carries numpy arrays under the reference's npz keys,
and each package decodes the other's payloads. The text below is the
reference's.

TPU-native equivalent of reference dl4j-streaming serde
(streaming/serde/RecordSerializer.java + conversion/NDArrayConverter — the
reference ships base64'd ND4J binary inside Camel messages). Here: npz bytes
for arrays and DataSets (the same container ModelSerializer/export use) and
UTF-8 CSV lines for records.
"""
from __future__ import annotations

import io

import numpy as np
import torch

from ..datasets.dataset import DataSet


def _host(a):
    """A numpy array or a tensor (on any device) as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def encode_array(arr) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, array=_host(arr))
    return buf.getvalue()


def decode_array(payload: bytes):
    with np.load(io.BytesIO(payload)) as z:
        return z["array"]


def encode_dataset(ds: DataSet) -> bytes:
    buf = io.BytesIO()
    arrs = {"features": _host(ds.features)}
    if ds.labels is not None:
        arrs["labels"] = _host(ds.labels)
    if ds.features_mask is not None:
        arrs["features_mask"] = _host(ds.features_mask)
    if ds.labels_mask is not None:
        arrs["labels_mask"] = _host(ds.labels_mask)
    np.savez_compressed(buf, **arrs)
    return buf.getvalue()


def decode_dataset(payload: bytes) -> DataSet:
    with np.load(io.BytesIO(payload)) as z:
        return DataSet(z["features"],
                       z["labels"] if "labels" in z else None,
                       z["features_mask"] if "features_mask" in z else None,
                       z["labels_mask"] if "labels_mask" in z else None)


def encode_record(values) -> bytes:
    return ",".join(str(float(v)) for v in values).encode("utf-8")


def decode_record(payload: bytes):
    return [float(v) for v in payload.decode("utf-8").split(",") if v]
