"""Classification evaluation.

The port's copy of deeplearning4j_tpu/eval/evaluation.py (numpy only), held against it
by tests/test_torch_*.py; the text below is the reference's.

TPU-native equivalent of reference eval/Evaluation.java:46-780 (eval():191
accumulates confusion counts; stats():352 renders; merge() supports
distributed aggregation as used by Spark eval —
spark/impl/multilayer/evaluation/IEvaluateFlatMapFunction.java).
"""
from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    """reference: eval/ConfusionMatrix.java"""

    def __init__(self, num_classes):
        self.num_classes = int(num_classes)
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual, predicted, count=1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual, predicted):
        return int(self.matrix[actual, predicted])

    def merge(self, other):
        self.matrix += other.matrix
        return self


class Prediction:
    """Per-example prediction record for error analysis — reference
    eval/meta/Prediction.java (actualClass, predictedClass, recordMetaData).
    Only recorded when eval() is called with `meta` (the reference's
    eval(INDArray, INDArray, List<Serializable>) overload)."""

    def __init__(self, actual_class, predicted_class, record_meta_data):
        self.actual_class = int(actual_class)
        self.predicted_class = int(predicted_class)
        self.record_meta_data = record_meta_data

    def get_actual_class(self):
        return self.actual_class

    getActualClass = get_actual_class

    def get_predicted_class(self):
        return self.predicted_class

    getPredictedClass = get_predicted_class

    def get_record_meta_data(self):
        return self.record_meta_data

    getRecordMetaData = get_record_meta_data

    def __repr__(self):
        return (f"Prediction(actualClass={self.actual_class},"
                f"predictedClass={self.predicted_class},"
                f"RecordMetaData={self.record_meta_data})")

    def __eq__(self, other):
        return (isinstance(other, Prediction)
                and self.actual_class == other.actual_class
                and self.predicted_class == other.predicted_class
                and self.record_meta_data == other.record_meta_data)


class Evaluation:
    def __init__(self, num_classes=None, labels=None, top_n=1):
        self.label_names = labels
        self.num_classes = num_classes or (len(labels) if labels else None)
        self.confusion = (ConfusionMatrix(self.num_classes)
                          if self.num_classes else None)
        self.top_n = int(top_n)
        self.top_n_correct = 0
        self.num_examples = 0
        # (actual, predicted) -> [meta, ...] — reference
        # Evaluation.addToMetaConfusionMatrix:938
        self._meta_confusion = {}

    # ------------------------------------------------------------------
    def eval(self, labels, predictions, mask=None, meta=None):
        """labels: one-hot [N,C] (or [N,T,C] sequences); predictions same shape
        of probabilities. reference: Evaluation.eval:191 (+ evalTimeSeries for
        the RNN reshape). `meta`: optional per-example metadata list (len N)
        enabling the Prediction error-analysis queries (reference
        eval(INDArray, INDArray, List<? extends Serializable>))."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if meta is not None and len(meta) != labels.shape[0]:
            raise ValueError(f"meta length {len(meta)} != batch "
                             f"{labels.shape[0]}")
        if labels.ndim == 3:  # [N,T,C] sequence -> flatten valid timesteps
            if meta is not None:  # expand per-sequence meta to timesteps
                meta = [md for md in meta for _ in range(labels.shape[1])]
            if mask is not None:
                m = np.asarray(mask).astype(bool).reshape(-1)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
            if meta is not None:
                meta = [x for x, keep in zip(meta, m) if keep]
        elif mask is not None:  # [N,C] with per-example mask
            m = np.asarray(mask).astype(bool).reshape(-1)
            labels = labels[m]
            predictions = predictions[m]
            if meta is not None:
                meta = [x for x, keep in zip(meta, m) if keep]
        if self.num_classes is None:
            self.num_classes = labels.shape[-1]
            self.confusion = ConfusionMatrix(self.num_classes)
        actual = np.argmax(labels, axis=-1)
        pred = np.argmax(predictions, axis=-1)
        np.add.at(self.confusion.matrix, (actual, pred), 1)
        self.num_examples += len(actual)
        if self.top_n > 1:
            top = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self.top_n_correct += int(np.sum(top == actual[:, None]))
        if meta is not None:
            for a, p, md in zip(actual.tolist(), pred.tolist(), meta):
                self._meta_confusion.setdefault((a, p), []).append(md)
        return self

    # -- Prediction queries (meta-eval only) ---------------------------
    def _predictions(self, pred_filter):
        if not self._meta_confusion:
            return None   # reference returns null without recorded metadata
        out = []
        for (a, p), metas in sorted(self._meta_confusion.items()):
            if pred_filter(a, p):
                out.extend(Prediction(a, p, md) for md in metas)
        return out

    def get_prediction_errors(self):
        """reference Evaluation.getPredictionErrors:961"""
        return self._predictions(lambda a, p: a != p)

    getPredictionErrors = get_prediction_errors

    def get_predictions(self, actual_class, predicted_class):
        """reference Evaluation.getPredictions:1056"""
        return self._predictions(
            lambda a, p: a == actual_class and p == predicted_class)

    getPredictions = get_predictions

    def get_predictions_by_actual_class(self, actual_class):
        return self._predictions(lambda a, p: a == actual_class)

    getPredictionsByActualClass = get_predictions_by_actual_class

    def get_predictions_by_predicted_class(self, predicted_class):
        return self._predictions(lambda a, p: p == predicted_class)

    getPredictionsByPredictedClass = get_predictions_by_predicted_class

    # ------------------------------------------------------------------
    def _tp(self, c):
        return int(self.confusion.matrix[c, c])

    def _fp(self, c):
        return int(self.confusion.matrix[:, c].sum() - self.confusion.matrix[c, c])

    def _fn(self, c):
        return int(self.confusion.matrix[c, :].sum() - self.confusion.matrix[c, c])

    def true_positives(self):
        return {c: self._tp(c) for c in range(self.num_classes)}

    def false_positives(self):
        return {c: self._fp(c) for c in range(self.num_classes)}

    def false_negatives(self):
        return {c: self._fn(c) for c in range(self.num_classes)}

    def accuracy(self):
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def top_n_accuracy(self):
        return (self.top_n_correct / self.num_examples) if self.num_examples else 0.0

    def precision(self, c=None):
        if c is not None:
            tp, fp = self._tp(c), self._fp(c)
            return tp / (tp + fp) if (tp + fp) else 0.0
        vals = [self.precision(i) for i in range(self.num_classes)
                if (self._tp(i) + self._fn(i)) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c=None):
        if c is not None:
            tp, fn = self._tp(c), self._fn(c)
            return tp / (tp + fn) if (tp + fn) else 0.0
        vals = [self.recall(i) for i in range(self.num_classes)
                if (self._tp(i) + self._fn(i)) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, c=None):
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    # ------------------------------------------------------------------
    def merge(self, other):
        """Distributed aggregation (reference Evaluation.merge)."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(self.num_classes)
        self.confusion.merge(other.confusion)
        self.num_examples += other.num_examples
        self.top_n_correct += other.top_n_correct
        for key, metas in other._meta_confusion.items():
            self._meta_confusion.setdefault(key, []).extend(metas)
        return self

    def stats(self):
        """Render summary (reference Evaluation.stats():352)."""
        lines = ["==========================Scores========================================"]
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append("========================================================================")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()
