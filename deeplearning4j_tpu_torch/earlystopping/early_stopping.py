"""Early stopping: port of deeplearning4j_tpu/earlystopping/early_stopping.py
(configuration, terminations, savers, trainer, result), the reference's
earlystopping/:
- EarlyStoppingConfiguration (builder: scoreCalculator, terminations, saver,
  evaluateEveryNEpochs)
- score calculators (DataSetLossCalculator)
- epoch termination conditions (MaxEpochsTerminationCondition,
  ScoreImprovementEpochTerminationCondition, BestScoreEpochTerminationCondition)
- iteration termination conditions (MaxTimeIterationTerminationCondition,
  MaxScoreIterationTerminationCondition, InvalidScoreIterationTerminationCondition)
- model savers (InMemoryModelSaver, LocalFileModelSaver)
- BaseEarlyStoppingTrainer.fit() (:76) -> EarlyStoppingResult

The trainer reads `float(net.score())` after every batch (one host sync a
step, the reference's semantics) and fits batch by batch, so fused groups
never form under it. LocalFileModelSaver writes the port's model zips
(`util.model_serializer`), which the reference restores, and restores them
on the device of the network it saved.
"""
from __future__ import annotations

import math
import os
import time

from ..datasets.iterators import next_processed


# ---------------------------------------------------------------------------
# Score calculators
# ---------------------------------------------------------------------------

class DataSetLossCalculator:
    """Average loss over a held-out iterator.
    reference: earlystopping/scorecalc/DataSetLossCalculator.java."""

    def __init__(self, iterator, average=True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net):
        self.iterator.reset()
        total, count = 0.0, 0
        while self.iterator.has_next():
            ds = next_processed(self.iterator)
            n = ds.num_examples()
            total += net.score(ds) * n
            count += n
        self.iterator.reset()
        if count == 0:
            return float("nan")
        return total / count if self.average else total

    calculateScore = calculate_score


# ---------------------------------------------------------------------------
# Epoch termination conditions
# ---------------------------------------------------------------------------

class MaxEpochsTerminationCondition:
    """reference: earlystopping/termination/MaxEpochsTerminationCondition.java"""

    def __init__(self, max_epochs):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition:
    """Stop after N epochs with no score improvement (optionally requiring a
    minimal improvement). reference:
    termination/ScoreImprovementEpochTerminationCondition.java."""

    def __init__(self, max_epochs_without_improvement, min_improvement=0.0):
        self.max_epochs = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self._best = None
        self._since = 0

    def terminate(self, epoch, score):
        if self._best is None or (self._best - score) > self.min_improvement:
            self._best = score
            self._since = 0
            return False
        self._since += 1
        return self._since >= self.max_epochs

    def __str__(self):
        return (f"ScoreImprovementEpochTerminationCondition("
                f"{self.max_epochs}, {self.min_improvement})")


class BestScoreEpochTerminationCondition:
    """Stop as soon as the score is at/below a target value.
    reference: termination/BestScoreEpochTerminationCondition.java."""

    def __init__(self, best_expected_score):
        self.target = float(best_expected_score)

    def terminate(self, epoch, score):
        return score <= self.target

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.target})"


# ---------------------------------------------------------------------------
# Iteration termination conditions
# ---------------------------------------------------------------------------

class MaxTimeIterationTerminationCondition:
    """reference: termination/MaxTimeIterationTerminationCondition.java"""

    def __init__(self, max_seconds):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, last_score):
        if self._start is None:
            self.initialize()
        return (time.monotonic() - self._start) >= self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition:
    """Stop if the score explodes past a bound.
    reference: termination/MaxScoreIterationTerminationCondition.java."""

    def __init__(self, max_score):
        self.max_score = float(max_score)

    def initialize(self):
        pass

    def terminate(self, last_score):
        return last_score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition:
    """Stop on NaN/Inf score. reference:
    termination/InvalidScoreIterationTerminationCondition.java (used by the
    reference as its only NaN guard, SURVEY.md §5.3)."""

    def initialize(self):
        pass

    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"


# ---------------------------------------------------------------------------
# Model savers
# ---------------------------------------------------------------------------

class InMemoryModelSaver:
    """reference: earlystopping/saver/InMemoryModelSaver.java"""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score):
        self._best = net.clone()

    def save_latest_model(self, net, score):
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest

    saveBestModel = save_best_model
    getBestModel = get_best_model


class LocalFileModelSaver:
    """Zip checkpoints via ModelSerializer.
    reference: earlystopping/saver/LocalFileModelSaver.java."""

    def __init__(self, directory):
        self.directory = str(directory)
        self._device = None      # the device of the network last saved
        os.makedirs(self.directory, exist_ok=True)

    @property
    def best_path(self):
        return os.path.join(self.directory, "bestModel.bin")

    @property
    def latest_path(self):
        return os.path.join(self.directory, "latestModel.bin")

    def save_best_model(self, net, score):
        from ..util.model_serializer import write_model
        self._device = net.device
        write_model(net, self.best_path)

    def save_latest_model(self, net, score):
        from ..util.model_serializer import write_model
        self._device = net.device
        write_model(net, self.latest_path)

    def get_best_model(self):
        from ..util.model_serializer import restore_model
        return restore_model(self.best_path, device=self._device)

    def get_latest_model(self):
        from ..util.model_serializer import restore_model
        return restore_model(self.latest_path, device=self._device)

    saveBestModel = save_best_model
    getBestModel = get_best_model


# ---------------------------------------------------------------------------
# Configuration + result + trainer
# ---------------------------------------------------------------------------

class EarlyStoppingConfiguration:
    """reference: earlystopping/EarlyStoppingConfiguration.java (Builder)."""

    class Builder:
        def __init__(self):
            self._score_calculator = None
            self._epoch_terminations = []
            self._iteration_terminations = []
            self._saver = None
            self._eval_every_n = 1
            self._save_last = False
            self._terminate_on_invalid_score = True

        def score_calculator(self, sc):
            self._score_calculator = sc; return self

        scoreCalculator = score_calculator

        def epoch_termination_conditions(self, *conds):
            self._epoch_terminations.extend(conds); return self

        epochTerminationConditions = epoch_termination_conditions

        def iteration_termination_conditions(self, *conds):
            self._iteration_terminations.extend(conds); return self

        iterationTerminationConditions = iteration_termination_conditions

        def model_saver(self, saver):
            self._saver = saver; return self

        modelSaver = model_saver

        def evaluate_every_n_epochs(self, n):
            self._eval_every_n = int(n); return self

        evaluateEveryNEpochs = evaluate_every_n_epochs

        def save_last_model(self, v):
            self._save_last = bool(v); return self

        saveLastModel = save_last_model

        def terminate_on_invalid_score(self, v):
            """Default True: a NaN/Inf score stops training (the guard the
            reference makes opt-in via
            InvalidScoreIterationTerminationCondition). Pass False for
            reference parity — training then survives transient non-finite
            scores unless an explicit condition is configured."""
            self._terminate_on_invalid_score = bool(v); return self

        terminateOnInvalidScore = terminate_on_invalid_score

        def build(self):
            c = EarlyStoppingConfiguration()
            c.score_calculator = self._score_calculator
            c.epoch_terminations = list(self._epoch_terminations)
            c.iteration_terminations = list(self._iteration_terminations)
            c.saver = self._saver or InMemoryModelSaver()
            c.eval_every_n = self._eval_every_n
            c.save_last = self._save_last
            c.terminate_on_invalid_score = self._terminate_on_invalid_score
            return c


class EarlyStoppingResult:
    """reference: earlystopping/EarlyStoppingResult.java"""

    class TerminationReason:
        Error = "Error"
        IterationTerminationCondition = "IterationTerminationCondition"
        EpochTerminationCondition = "EpochTerminationCondition"

    def __init__(self, reason, details, score_vs_epoch, best_epoch, best_score,
                 total_epochs, best_model):
        self.termination_reason = reason
        self.termination_details = details
        self.score_vs_epoch = score_vs_epoch
        self.best_model_epoch = best_epoch
        self.best_model_score = best_score
        self.total_epochs = total_epochs
        self.best_model = best_model

    def get_best_model(self):
        return self.best_model

    getBestModel = get_best_model

    def __str__(self):
        return (f"EarlyStoppingResult(reason={self.termination_reason}, "
                f"details={self.termination_details}, "
                f"bestEpoch={self.best_model_epoch}, "
                f"bestScore={self.best_model_score}, "
                f"totalEpochs={self.total_epochs})")


class EarlyStoppingTrainer:
    """reference: earlystopping/trainer/BaseEarlyStoppingTrainer.fit():76.

    Per epoch: fit one pass over the training iterator (checking iteration
    terminations on the model score), then every `eval_every_n` epochs compute
    the held-out score, save best model, check epoch terminations.
    """

    def __init__(self, es_conf, net, train_iterator):
        self.conf = es_conf
        self.net = net
        self.train_iterator = train_iterator

    def _fit_batch(self, ds):
        """Per-batch hook: how one training batch is executed (the
        ParallelWrapper trainer routes this through the sharded step)."""
        self.net.fit(ds)

    @staticmethod
    def _check_iteration_termination(c, last):
        """Shared iteration-termination check + divergence guard: by
        default a non-finite score (NaN or +/-Inf) terminates — the
        reference InvalidScoreIterationTerminationCondition role, on by
        default here because a non-finite score can never recover
        information for best-model selection. Builders that need the
        reference's opt-in semantics pass
        terminate_on_invalid_score(False). Returns (reason, details)
        or None."""
        if getattr(c, "terminate_on_invalid_score", True) \
                and not math.isfinite(last):
            return (EarlyStoppingResult.TerminationReason
                    .IterationTerminationCondition,
                    f"score is non-finite ({last})")
        for t in c.iteration_terminations:
            if t.terminate(last):
                return (EarlyStoppingResult.TerminationReason
                        .IterationTerminationCondition, str(t))
        return None

    def _fit_epoch(self, c):
        """Template method: train one epoch, checking iteration
        terminations; returns (reason, details) on termination else None.
        Subclasses (the TrainingMaster trainer) override the epoch body."""
        self.train_iterator.reset()
        while self.train_iterator.has_next():
            ds = next_processed(self.train_iterator)
            self._fit_batch(ds)
            stop = self._check_iteration_termination(c,
                                                     float(self.net.score()))
            if stop is not None:
                return stop
        return None

    def fit(self):
        c = self.conf
        for t in c.iteration_terminations:
            t.initialize()
        score_vs_epoch = {}
        best_score, best_epoch = None, -1
        epoch = 0
        reason, details = None, None
        while True:
            stop = self._fit_epoch(c)
            terminated = stop is not None
            if terminated:
                reason, details = stop
                break
            if epoch % c.eval_every_n == 0:
                if c.score_calculator is not None:
                    score = c.score_calculator.calculate_score(self.net)
                else:
                    score = self.net.score()
                score_vs_epoch[epoch] = score
                if best_score is None or score < best_score:
                    best_score, best_epoch = score, epoch
                    c.saver.save_best_model(self.net, score)
                if c.save_last:
                    c.saver.save_latest_model(self.net, score)
                for t in c.epoch_terminations:
                    if t.terminate(epoch, score):
                        reason = EarlyStoppingResult.TerminationReason.\
                            EpochTerminationCondition
                        details = str(t)
                        terminated = True
                        break
            if terminated:
                break
            epoch += 1
        best_model = c.saver.get_best_model()
        return EarlyStoppingResult(
            reason or EarlyStoppingResult.TerminationReason.Error,
            details or "", score_vs_epoch, best_epoch,
            best_score if best_score is not None else float("nan"),
            epoch + 1, best_model)


EarlyStoppingGraphTrainer = EarlyStoppingTrainer
