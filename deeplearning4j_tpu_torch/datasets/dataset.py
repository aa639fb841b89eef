"""DataSet / MultiDataSet containers: a copy of
deeplearning4j_tpu/datasets/dataset.py (numpy only).

Arrays stay on the host; the containers move each batch to their device.
"""
from __future__ import annotations

import numpy as np


def _as_array(a):
    """Keep ndarray-like inputs (numpy arrays or tensors) as they are;
    only coerce plain Python data."""
    if a is None or (hasattr(a, "dtype") and hasattr(a, "shape")):
        return a
    return np.asarray(a)


class DataSet:
    def __init__(self, features, labels, features_mask=None, labels_mask=None):
        self.features = _as_array(features)
        self.labels = _as_array(labels)
        self.features_mask = _as_array(features_mask)
        self.labels_mask = _as_array(labels_mask)

    def num_examples(self):
        return int(self.features.shape[0])

    def shallow_copy(self):
        """New DataSet sharing the same arrays — lets a pre-processor
        rebind .features without mutating a cached original. Per-example
        metadata (Prediction error-analysis queries) rides along."""
        out = DataSet.__new__(DataSet)
        out.features = self.features
        out.labels = self.labels
        out.features_mask = self.features_mask
        out.labels_mask = self.labels_mask
        metas = getattr(self, "example_metas", None)
        if metas is not None:
            out.example_metas = metas
        return out

    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def split_test_and_train(self, n_train):
        tr = DataSet(self.features[:n_train], self.labels[:n_train])
        te = DataSet(self.features[n_train:], self.labels[n_train:])
        return tr, te

    def shuffle(self, seed=None):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def batch_by(self, batch_size):
        n = self.num_examples()
        for i in range(0, n, batch_size):
            yield DataSet(
                self.features[i:i + batch_size],
                self.labels[i:i + batch_size] if self.labels is not None else None,
                self.features_mask[i:i + batch_size] if self.features_mask is not None else None,
                self.labels_mask[i:i + batch_size] if self.labels_mask is not None else None,
            )

    @staticmethod
    def merge(datasets):
        def cat(attr):
            vals = [getattr(d, attr) for d in datasets]
            if vals[0] is None:
                return None
            return np.concatenate([np.asarray(v) for v in vals], axis=0)
        return DataSet(cat("features"), cat("labels"),
                       cat("features_mask"), cat("labels_mask"))

    def save(self, path):
        """Persist to an .npz file (reference: ND4J DataSet.save — the unit
        the Export training approach writes to distributed storage)."""
        arrs = {"features": np.asarray(self.features)}
        if self.labels is not None:
            arrs["labels"] = np.asarray(self.labels)
        if self.features_mask is not None:
            arrs["features_mask"] = np.asarray(self.features_mask)
        if self.labels_mask is not None:
            arrs["labels_mask"] = np.asarray(self.labels_mask)
        np.savez(path, **arrs)

    @staticmethod
    def load(path):
        """reference: ND4J DataSet.load."""
        with np.load(path) as z:
            return DataSet(z["features"],
                           z["labels"] if "labels" in z.files else None,
                           z["features_mask"] if "features_mask" in z.files
                           else None,
                           z["labels_mask"] if "labels_mask" in z.files
                           else None)


class MultiDataSet:
    """Multi-input / multi-output container (reference: ND4J MultiDataSet,
    consumed by ComputationGraph.fit)."""

    def __init__(self, features, labels, features_masks=None, labels_masks=None):
        self.features = [_as_array(f) for f in _as_list(features)]
        self.labels = [_as_array(l) for l in _as_list(labels)]
        self.features_masks = ([_as_array(m) for m in features_masks]
                               if features_masks else None)
        self.labels_masks = ([_as_array(m) for m in labels_masks]
                             if labels_masks else None)

    def num_examples(self):
        return int(self.features[0].shape[0])

    def shallow_copy(self):
        out = MultiDataSet.__new__(MultiDataSet)
        out.features = list(self.features)
        out.labels = list(self.labels)
        out.features_masks = (list(self.features_masks)
                              if self.features_masks else self.features_masks)
        out.labels_masks = (list(self.labels_masks)
                            if self.labels_masks else self.labels_masks)
        # symmetric with DataSet.shallow_copy: per-example metadata rides
        # along through pre-processor/staging rebuilds
        metas = getattr(self, "example_metas", None)
        if metas is not None:
            out.example_metas = metas
        return out


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]
