"""MNIST dataset: IDX binary parser + DataSetIterator.

The port's copy of deeplearning4j_tpu/datasets/mnist.py (numpy). The
reference reads IDX files with its native C++ parser when that library is
built (common/native_ops.py); the port's ctypes loader for it is ROADMAP.md
queue 1 item 21, so here `read_idx` is the reference's Python parser, whose
arrays give the same images and labels.

TPU-native equivalent of reference base/MnistFetcher.java +
datasets/mnist/MnistManager (binary IDX parsing) +
datasets/iterator/impl/MnistDataSetIterator.java.

The reference downloads the IDX files on first use; this environment has no
network egress, so the fetcher resolves, in order:
1. `$DL4J_TPU_MNIST_DIR` or `~/.deeplearning4j_tpu/mnist/` containing the
   standard IDX files (train-images-idx3-ubyte etc., optionally .gz)
2. a deterministic synthetic stand-in (class-conditional digit blobs) so tests
   and benchmarks run hermetically. Synthetic mode is clearly flagged via
   `.synthetic`.

Images are returned as flat [N, 784] float32 in [0,1] (matching the
reference's binarize=false normalization), labels one-hot [N, 10]; reshape to
NHWC happens in the network via InputType.convolutional_flat.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _open_maybe_gz(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def read_idx(path):
    """Parse an IDX file (reference: datasets/mnist/MnistImageFile /
    MnistLabelFile binary readers), optionally gzipped."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">HBB", f.read(4))
        _, dtype_code, ndim = magic
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                  0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        data = np.frombuffer(f.read(), dtype=dtypes[dtype_code])
        return data.reshape(dims)


def _mnist_dir():
    return os.environ.get(
        "DL4J_TPU_MNIST_DIR",
        os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu", "mnist"))


def _load_real(train):
    d = _mnist_dir()
    imgs = read_idx(os.path.join(d, _FILES["train_images" if train else "test_images"]))
    labels = read_idx(os.path.join(d, _FILES["train_labels" if train else "test_labels"]))
    x = imgs.reshape(imgs.shape[0], -1).astype(np.float32) / 255.0
    y = np.eye(10, dtype=np.float32)[labels.astype(np.int64)]
    return x, y


def _synthetic(n, seed):
    """Deterministic class-conditional 28x28 digit-blob images. Linearly
    separable enough that LeNet/MLP convergence tests are meaningful.

    Class prototypes come from a FIXED seed so train and test splits share
    the same class-conditional distribution; only the noise varies per split.
    """
    protos = np.random.default_rng(977).random((10, 784)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    noise = rng.normal(0, 0.35, (n, 784)).astype(np.float32)
    x = np.clip(protos[labels] + noise, 0.0, 1.0)
    y = np.eye(10, dtype=np.float32)[labels]
    return x, y


class MnistDataSetIterator(DataSetIterator):
    """reference: datasets/iterator/impl/MnistDataSetIterator.java"""

    def __init__(self, batch_size, num_examples=None, train=True, shuffle=True,
                 seed=123, binarize=False):
        self.batch_size = int(batch_size)
        self.train = train
        self.synthetic = False
        try:
            x, y = _load_real(train)
        except (FileNotFoundError, OSError):
            self.synthetic = True
            n = num_examples or (60000 if train else 10000)
            n = min(n, 60000 if train else 10000)
            x, y = _synthetic(n, seed if train else seed + 1)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        if binarize:
            x = (x > 0.5).astype(np.float32)
        if shuffle:
            rng = np.random.default_rng(seed)
            idx = rng.permutation(len(x))
            x, y = x[idx], y[idx]
        self._x, self._y = x, y
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
        return 10

    def input_columns(self):
        return 784


class IrisDataSetIterator(DataSetIterator):
    """Iris dataset, generated from the canonical Fisher measurement
    distributions (reference: datasets/iterator/impl/IrisDataSetIterator.java /
    base/IrisUtils — the reference bundles the CSV; here the 150 samples are
    synthesized deterministically from per-class Gaussian stats of the classic
    dataset so no file is needed)."""

    _STATS = {  # (mean, std) per feature per class from Fisher's iris
        0: ([5.006, 3.428, 1.462, 0.246], [0.352, 0.379, 0.174, 0.105]),
        1: ([5.936, 2.770, 4.260, 1.326], [0.516, 0.314, 0.470, 0.198]),
        2: ([6.588, 2.974, 5.552, 2.026], [0.636, 0.322, 0.552, 0.275]),
    }

    def __init__(self, batch_size=150, num_examples=150, seed=6):
        rng = np.random.default_rng(seed)
        xs, ys = [], []
        per = max(1, num_examples // 3)
        for c, (mean, std) in self._STATS.items():
            xs.append(rng.normal(mean, std, (per, 4)))
            y = np.zeros((per, 3))
            y[:, c] = 1.0
            ys.append(y)
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys).astype(np.float32)
        idx = rng.permutation(len(x))
        self._x, self._y = x[idx], y[idx]
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
        return 3

    def input_columns(self):
        return 4
