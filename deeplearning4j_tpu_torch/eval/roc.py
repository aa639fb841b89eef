"""ROC evaluation: binary ROC + one-vs-all multiclass.

The port's copy of deeplearning4j_tpu/eval/roc.py (numpy only), held against it
by tests/test_torch_*.py; the text below is the reference's.

TPU-native equivalent of reference eval/ROC.java (thresholded TPR/FPR curve,
AUC via trapezoid, merge() for distributed aggregation) and
eval/ROCMultiClass.java. Counts accumulate in threshold bins so merge()
across workers is exact, as in the reference.
"""
from __future__ import annotations

import numpy as np


class ROC:
    """Binary ROC. probabilities: P(class=1); labels: 0/1 (or one-hot [N,2])."""

    def __init__(self, threshold_steps=100):
        self.threshold_steps = int(threshold_steps)
        if self.threshold_steps < 1:
            raise ValueError("threshold_steps must be >= 1")
        n = self.threshold_steps + 1
        # per-threshold counts: predicted-positive at threshold t
        self._tp = np.zeros(n, np.int64)
        self._fp = np.zeros(n, np.int64)
        self._pos = 0
        self._neg = 0

    def _thresholds(self):
        return np.linspace(0.0, 1.0, self.threshold_steps + 1)

    def eval(self, labels, probabilities, mask=None):
        labels = np.asarray(labels)
        probs = np.asarray(probabilities)
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
        if probs.ndim == 2 and probs.shape[1] == 2:
            probs = probs[:, 1]
        labels = labels.ravel()
        probs = probs.ravel()
        if mask is not None:
            m = np.asarray(mask).astype(bool).ravel()
            labels, probs = labels[m], probs[m]
        pos = labels > 0.5
        self._pos += int(pos.sum())
        self._neg += int((~pos).sum())
        # single pass: bin each score, histogram per class, reversed cumsum
        # gives predicted-positive counts at every threshold at once.
        # bin i counts scores in [t_i, t_{i+1}); prob >= t_i <=> bin >= i.
        S = self.threshold_steps
        bins = np.clip(np.floor(probs * S).astype(np.int64), 0, S)
        pos_hist = np.bincount(bins[pos], minlength=S + 1)
        neg_hist = np.bincount(bins[~pos], minlength=S + 1)
        self._tp += np.cumsum(pos_hist[::-1])[::-1]
        self._fp += np.cumsum(neg_hist[::-1])[::-1]
        return self

    def get_roc_curve(self):
        """-> list of (threshold, fpr, tpr), threshold ascending."""
        out = []
        for i, t in enumerate(self._thresholds()):
            tpr = self._tp[i] / self._pos if self._pos else 0.0
            fpr = self._fp[i] / self._neg if self._neg else 0.0
            out.append((float(t), float(fpr), float(tpr)))
        return out

    getRocCurve = get_roc_curve

    def calculate_auc(self):
        """Trapezoidal AUC over the (fpr, tpr) curve."""
        pts = sorted((fpr, tpr) for _, fpr, tpr in self.get_roc_curve())
        pts = [(1.0, 1.0)] + sorted(pts, reverse=True)  # fpr descending
        auc = 0.0
        for (x1, y1), (x0, y0) in zip(pts, pts[1:]):
            auc += (x1 - x0) * (y1 + y0) / 2.0
        return float(auc)

    calculateAUC = calculate_auc

    def merge(self, other):
        if other.threshold_steps != self.threshold_steps:
            raise ValueError("Cannot merge ROC with different threshold_steps")
        self._tp += other._tp
        self._fp += other._fp
        self._pos += other._pos
        self._neg += other._neg
        return self


class ROCMultiClass:
    """One-vs-all ROC per class. reference: eval/ROCMultiClass.java."""

    def __init__(self, threshold_steps=100):
        self.threshold_steps = int(threshold_steps)
        self._rocs = {}

    def eval(self, labels, probabilities, mask=None):
        labels = np.asarray(labels)
        probs = np.asarray(probabilities)
        if labels.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).astype(bool).reshape(-1)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[m]
            probs = probs.reshape(-1, probs.shape[-1])[m]
            mask = None
        C = labels.shape[-1]
        for c in range(C):
            roc = self._rocs.setdefault(c, ROC(self.threshold_steps))
            roc.eval(labels[:, c], probs[:, c], mask)
        return self

    def calculate_auc(self, c):
        return self._rocs[c].calculate_auc()

    calculateAUC = calculate_auc

    def calculate_average_auc(self):
        if not self._rocs:
            return 0.0
        return float(np.mean([r.calculate_auc()
                              for r in self._rocs.values()]))

    calculateAverageAUC = calculate_average_auc

    def get_roc_curve(self, c):
        return self._rocs[c].get_roc_curve()

    def merge(self, other):
        for c, roc in other._rocs.items():
            # merge into a fresh/owned ROC — aliasing the source object
            # would let later eval() calls corrupt both aggregators
            mine = self._rocs.setdefault(c, ROC(self.threshold_steps))
            mine.merge(roc)
        return self
