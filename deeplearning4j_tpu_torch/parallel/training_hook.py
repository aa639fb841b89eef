"""TrainingHook SPI: intercept TrainingMaster workers.

Port of deeplearning4j_tpu/parallel/training_hook.py (reference
spark/api/TrainingHook.java, and dl4j-spark-parameterserver's
ParameterServerTrainingHook.java, which routes worker gradients through
the parameter server instead of the parameter average). The
parameter-server hook trains each TrainingMaster split through the async
`GradientsAccumulator`: worker threads pull version-tagged snapshots,
compute gradients and push them to the apply loop, bounded staleness and
all, while the master keeps its split, stats and export semantics.
"""
from __future__ import annotations

from .parameter_server import GradientsAccumulator, run_workers, worker_pool


class TrainingHook:
    """Observer hook (reference TrainingHook.java: preUpdate/postUpdate).
    Subclasses that take over the split's training set
    `handles_training = True` and implement process_split()."""

    handles_training = False

    def pre_update(self, minibatch, model):
        pass

    preUpdate = pre_update

    def post_update(self, minibatch, model):
        pass

    postUpdate = post_update


class ParameterServerTrainingHook(TrainingHook):
    """reference: ParameterServerTrainingHook.java: worker gradients go to
    the parameter server, parameters come back from it."""

    handles_training = True

    def __init__(self, workers=2, queue_size=8, max_staleness=None):
        self.workers = int(workers)
        self.queue_size = int(queue_size)
        self.max_staleness = max_staleness
        self.last_stats = None
        self._acc = None
        self._net = None
        self._splits = 0
        self._pool = None      # the worker threads, kept across splits

    def close(self):
        """End the worker threads (a later split starts new ones)."""
        self.detach()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- accumulator lifecycle (one per execute_training call) ----------
    def attach(self, net):
        if self._acc is None or self._net is not net:
            self.detach()
            self._net = net
            self._acc = GradientsAccumulator(net, self.queue_size,
                                             self.max_staleness)
        return self._acc

    def detach(self):
        if self._acc is not None:
            self._acc.shutdown()
            self.last_stats = self._acc.stats()
            self._acc = None
            self._net = None

    def process_split(self, net, batches):
        """Train one TrainingMaster split asynchronously: shard the split's
        batches over worker threads, each pulling snapshots and pushing
        gradients (reference ExecuteWorkerFlatMap + PS hook path)."""
        acc = self.attach(net)
        if self._pool is None:
            self._pool = worker_pool(self.workers)
        self._splits += 1
        shards = [batches[i::self.workers] for i in range(self.workers)]
        run_workers(net, acc, shards, self._splits, self._pool, hook=self)
        return net
