"""Early stopping over the TrainingMaster and the ParallelWrapper: port of
deeplearning4j_tpu/parallel/early_stopping.py, the reference's dl4j-spark
spark/earlystopping/SparkEarlyStoppingTrainer.java (+
SparkDataSetLossCalculator.java): each "epoch" is one
TrainingMaster.execute_training pass over the data; scoring, best-model
saving (same EarlyStoppingModelSaver SPI), and termination conditions are
inherited unchanged from EarlyStoppingTrainer — only the epoch body is
cluster-shaped (the template-method seam `_fit_epoch`).
"""
from __future__ import annotations

from ..earlystopping.early_stopping import (DataSetLossCalculator,
                                            EarlyStoppingResult,  # noqa: F401
                                            EarlyStoppingTrainer)


class MasterDataSetLossCalculator(DataSetLossCalculator):
    """Held-out loss for cluster runs — reference
    spark/earlystopping/SparkDataSetLossCalculator.java. The reference maps
    partitions to (loss*n, n) pairs and reduces; that map/reduce is
    arithmetically identical to the example-weighted running mean
    DataSetLossCalculator already computes, so this is the same calculator
    under the reference's cluster-side name."""

    def __init__(self, iterator, average=True, num_shards=None):
        super().__init__(iterator, average)
        self.num_shards = num_shards   # accepted for API compat; unused


class TpuEarlyStoppingTrainer(EarlyStoppingTrainer):
    """reference: SparkEarlyStoppingTrainer.java — fit(JavaRDD) per epoch
    through the TrainingMaster, then score/save/terminate (inherited)."""

    def __init__(self, es_conf, training_master, net, data):
        super().__init__(es_conf, net, train_iterator=None)
        self.master = training_master
        self.data = data

    def _fit_epoch(self, c):
        """One epoch = one execute_training pass. Iteration terminations are
        checked at split-result granularity (the reference checks per
        averaging round on the driver); the shared check includes the NaN
        divergence guard."""
        self.master.execute_training(self.net, self.data)
        return self._check_iteration_termination(c, float(self.net.score()))


SparkEarlyStoppingTrainer = TpuEarlyStoppingTrainer   # reference name


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over the data-parallel ParallelWrapper — reference
    deeplearning4j-scaleout-parallelwrapper
    parallelism/EarlyStoppingParallelTrainer.java:46 (the reference wraps
    replicas+averaging around the model and routes scores back through a
    listener; here the wrapper's step over the process group is the
    trainer's step). `tensor_parallel=True` splits the big layers over
    the mesh's "model" axis while each fit runs, as the wrapper does.

    averaging_frequency == 1: the inherited epoch loop feeds batches
    through the wrapper one at a time (per-batch termination checks).
    averaging_frequency k > 1: the whole epoch iterator goes to
    `ParallelWrapper.fit` in one call so the k-local-steps batching
    actually forms k-batch groups; terminations are then checked once per
    epoch (the reference's per-averaging-round granularity)."""

    def __init__(self, es_conf, net, train_iterator, workers=None,
                 averaging_frequency=1, tensor_parallel=False, mesh=None):
        super().__init__(es_conf, net, train_iterator)
        from .parallel_wrapper import ParallelWrapper
        self.wrapper = ParallelWrapper(
            net, workers=workers, averaging_frequency=averaging_frequency,
            tensor_parallel=tensor_parallel, mesh=mesh)

    def _fit_batch(self, ds):
        self.wrapper.fit(ds)

    def _fit_epoch(self, c):
        if self.wrapper.averaging_frequency == 1:
            return super()._fit_epoch(c)
        self.wrapper.fit(self.train_iterator)   # fit() resets the iterator
        return self._check_iteration_termination(c, float(self.net.score()))
