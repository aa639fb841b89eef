"""Training listeners: port of deeplearning4j_tpu/optimize/listeners.py
(the reference's optimize/api IterationListener and TrainingListener, and
the stock ScoreIterationListener, PerformanceListener,
CollectScoresIterationListener and ComposableIterationListener).

The containers call `iteration_done(net, iteration)` on the host after
each optimizer step (`nn.multilayer.Network`). `model.score()` reads the
step's score from the device: a listener that calls it pays one host
sync a step; one that does not (PerformanceListener without
`report_score`) reads nothing. PerformanceListener times the host's wall
clock between two calls, as the reference's does: with kernels queued
asynchronously that is the host's pace, which matches the device's once
the queue is full.
"""
from __future__ import annotations

import logging
import time

log = logging.getLogger(__name__)


class IterationListener:
    """reference: optimize/api/IterationListener.java"""

    def iteration_done(self, model, iteration):
        pass


class TrainingListener(IterationListener):
    """reference: optimize/api/TrainingListener.java (epoch, forward and
    backward hooks; the containers call the epoch hooks)."""

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_gradient_calculation(self, model):
        pass

    def on_backward_pass(self, model):
        pass


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations (reference:
    optimize/listeners/ScoreIterationListener.java)."""

    def __init__(self, print_iterations=10):
        self.print_iterations = max(1, int(print_iterations))

    def iteration_done(self, model, iteration):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration,
                     float(model.score()))


class PerformanceListener(IterationListener):
    """Throughput instrumentation (reference:
    optimize/listeners/PerformanceListener.java: time a batch, samples/s,
    batches/s), from the host's wall clock between two calls and the
    network's `_last_batch_size`."""

    def __init__(self, frequency=1, report_score=False):
        self.frequency = max(1, int(frequency))
        self.report_score = report_score
        self.last_time = None
        self.samples_per_sec = 0.0
        self.batches_per_sec = 0.0
        self.history = []

    def iteration_done(self, model, iteration):
        now = time.perf_counter()
        if self.last_time is not None:
            dt = now - self.last_time
            batch_size = getattr(model, "_last_batch_size", 0)
            if dt > 0:
                self.samples_per_sec = batch_size / dt
                self.batches_per_sec = 1.0 / dt
                self.history.append((iteration, dt, self.samples_per_sec))
            if iteration % self.frequency == 0:
                msg = (f"iteration {iteration}; iteration time: "
                       f"{dt * 1000:.2f} ms; samples/sec: "
                       f"{self.samples_per_sec:.2f}; batches/sec: "
                       f"{self.batches_per_sec:.2f}")
                if self.report_score:
                    msg += f"; score: {float(model.score())}"
                log.info(msg)
        self.last_time = now


class CollectScoresIterationListener(IterationListener):
    """reference: optimize/listeners/CollectScoresIterationListener.java"""

    def __init__(self, frequency=1):
        self.frequency = max(1, int(frequency))
        self.scores = []

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(model.score())))


class ComposableIterationListener(IterationListener):
    """reference: optimize/listeners/ComposableIterationListener.java"""

    def __init__(self, *listeners):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration):
        for listener in self.listeners:
            listener.iteration_done(model, iteration)
