"""Streaming inference / training pipelines.

The port of deeplearning4j_tpu/streaming/pipelines.py, on the port's
containers: the worker thread calls the model's own `output` (which returns
numpy) or `fit` and `score`, so it runs the model on the model's device.
A worker's error is kept: `stop()` raises it, and the inference pipeline's
`error()` returns it. The text below is the reference's.

TPU-native equivalent of reference dl4j-streaming pipeline/
(SparkStreamingPipeline.java — train from a Kafka topic — and
SparkStreamingInferencePipeline.java — Kafka features in, predictions out,
wired through Camel routes). Here a pipeline owns a Broker subscription and
a worker thread; batching happens host-side and every consumed batch goes
through the same jitted fit/output paths as offline training.
"""
from __future__ import annotations

import threading

from . import serde


class StreamingInferencePipeline:
    """Consume feature arrays from `input_topic`, publish predictions to
    `output_topic`. reference: SparkStreamingInferencePipeline.java."""

    def __init__(self, model, broker, input_topic="features",
                 output_topic="predictions"):
        self.model = model
        self.broker = broker
        self.input_topic = input_topic
        self.output_topic = output_topic
        self._sub = None
        self._thread = None
        self._stop = threading.Event()
        self.processed = 0
        self._error = None

    def start(self):
        self._sub = self.broker.subscribe(self.input_topic)
        self._stop.clear()
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        try:
            while not self._stop.is_set():
                payload = self._sub.get(timeout=0.1)
                if payload is None:
                    continue
                x = serde.decode_array(payload)
                out = self.model.output(x)
                if isinstance(out, (list, tuple)):   # CG outputs
                    out = out[0]
                self.broker.publish(self.output_topic,
                                    serde.encode_array(out))
                self.processed += 1
        except Exception as e:   # surfaced by error()/stop(), not swallowed
            self._error = e

    def error(self):
        """Worker-thread failure, if any (a bad payload or model error
        stops consumption; callers can poll this between publishes)."""
        return self._error

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._error is not None:
            raise self._error


class StreamingTrainingPipeline:
    """Consume serialized DataSets from `input_topic` and fit the model on
    each (mini-batch online training). reference:
    SparkStreamingPipeline.java (kafka -> RDD -> fit per micro-batch)."""

    def __init__(self, model, broker, input_topic="train",
                 score_topic=None):
        self.model = model
        self.broker = broker
        self.input_topic = input_topic
        self.score_topic = score_topic
        self._sub = None
        self._thread = None
        self._stop = threading.Event()
        self.batches_fit = 0
        self._error = None

    def start(self):
        self._sub = self.broker.subscribe(self.input_topic)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        import numpy as np
        try:
            while not self._stop.is_set():
                payload = self._sub.get(timeout=0.1)
                if payload is None:
                    continue
                ds = serde.decode_dataset(payload)
                self.model.fit(ds)
                self.batches_fit += 1
                if self.score_topic is not None:
                    self.broker.publish(
                        self.score_topic,
                        np.float64(self.model.score()).tobytes())
        except Exception as e:
            self._error = e

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._error is not None:
            raise self._error
