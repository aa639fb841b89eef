"""Regression evaluation.

The port's copy of deeplearning4j_tpu/eval/regression.py (numpy only), held against it
by tests/test_torch_*.py; the text below is the reference's.

TPU-native equivalent of reference eval/RegressionEvaluation.java: per-column
MSE, MAE, RMSE, relative squared error, correlation (R), with merge() for
distributed aggregation.
"""
from __future__ import annotations

import numpy as np


class RegressionEvaluation:
    def __init__(self, n_columns, column_names=None):
        n = int(n_columns)
        self.n_columns = n
        self.column_names = column_names or [f"col_{i}" for i in range(n)]
        self.n = np.zeros(n, np.int64)
        self.sum_abs_err = np.zeros(n)
        self.sum_sq_err = np.zeros(n)
        self.sum_label = np.zeros(n)
        self.sum_sq_label = np.zeros(n)
        self.sum_pred = np.zeros(n)
        self.sum_sq_pred = np.zeros(n)
        self.sum_label_pred = np.zeros(n)

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                m = np.asarray(mask).astype(bool).reshape(-1)
                labels, predictions = labels[m], predictions[m]
        err = predictions - labels
        self.n += labels.shape[0]
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_sq_err += (err ** 2).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_sq_label += (labels ** 2).sum(0)
        self.sum_pred += predictions.sum(0)
        self.sum_sq_pred += (predictions ** 2).sum(0)
        self.sum_label_pred += (labels * predictions).sum(0)
        return self

    # -- metrics per column (reference RegressionEvaluation getters) ----
    def mean_squared_error(self, c):
        return self.sum_sq_err[c] / max(self.n[c], 1)

    def mean_absolute_error(self, c):
        return self.sum_abs_err[c] / max(self.n[c], 1)

    def root_mean_squared_error(self, c):
        return float(np.sqrt(self.mean_squared_error(c)))

    def relative_squared_error(self, c):
        n = max(self.n[c], 1)
        mean_label = self.sum_label[c] / n
        ss_tot = self.sum_sq_label[c] - n * mean_label ** 2
        return float(self.sum_sq_err[c] / ss_tot) if ss_tot else float("inf")

    def correlation_r2(self, c):
        n = max(self.n[c], 1)
        cov = self.sum_label_pred[c] - self.sum_label[c] * self.sum_pred[c] / n
        var_l = self.sum_sq_label[c] - self.sum_label[c] ** 2 / n
        var_p = self.sum_sq_pred[c] - self.sum_pred[c] ** 2 / n
        denom = np.sqrt(var_l * var_p)
        return float(cov / denom) if denom else 0.0

    def average_mean_squared_error(self):
        return float(np.mean([self.mean_squared_error(c)
                              for c in range(self.n_columns)]))

    def average_mean_absolute_error(self):
        return float(np.mean([self.mean_absolute_error(c)
                              for c in range(self.n_columns)]))

    def averagerootMeanSquaredError(self):
        return float(np.mean([self.root_mean_squared_error(c)
                              for c in range(self.n_columns)]))

    average_root_mean_squared_error = averagerootMeanSquaredError

    def merge(self, other):
        for attr in ("n", "sum_abs_err", "sum_sq_err", "sum_label",
                     "sum_sq_label", "sum_pred", "sum_sq_pred",
                     "sum_label_pred"):
            setattr(self, attr, getattr(self, attr) + getattr(other, attr))
        return self

    def stats(self):
        lines = [f"{'column':<12}{'MSE':>12}{'MAE':>12}{'RMSE':>12}{'RSE':>12}{'R':>8}"]
        for c in range(self.n_columns):
            lines.append(
                f"{self.column_names[c]:<12}{self.mean_squared_error(c):>12.5g}"
                f"{self.mean_absolute_error(c):>12.5g}"
                f"{self.root_mean_squared_error(c):>12.5g}"
                f"{self.relative_squared_error(c):>12.5g}"
                f"{self.correlation_r2(c):>8.4f}")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()
