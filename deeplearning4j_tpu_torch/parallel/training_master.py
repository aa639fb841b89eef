"""TrainingMaster: cluster-style data-parallel training over the ranks of a
process group.

Port of deeplearning4j_tpu/parallel/training_master.py (reference dl4j-spark:
the TrainingMaster SPI, ParameterAveragingTrainingMaster, the
SparkDl4jMultiLayer facade, SparkTrainingStats):
- ParameterAveragingTrainingMaster splits the data stream into splits of
  workers * batchSize * averagingFrequency examples; each split is one
  averaging round of `ParallelWrapper`'s k-local-steps mode (k =
  averagingFrequency): every rank trains on its rows of the split's global
  batches, then the parameters (and the updater state) are averaged over
  the group. Each split starts from the last averaged parameters, so a
  failed split is simply re-run (the reference's failure semantics).
- the "export" approach (the reference's default) streams the source once
  into one .npz file per global batch and trains each split from disk;
  "direct" holds every example in host memory.
- TpuDl4jMultiLayer / TpuComputationGraph: the user facade.
- TrainingMasterStats: the phase timeline, exported as JSON or HTML.
- a TrainingHook observes each split; a hook with handles_training (the
  parameter-server hook) trains the split through the async accumulator.

`workers=None` means the process group's size (1 without one). Every rank
runs the same master over the same data, and the wrapper gives each rank
its rows. Not ported yet (NotImplementedError naming the ROADMAP.md queue
1 item): `checkpoint_directory` (crash-resume, item 20) and
`health_policy` (item 17).
"""
from __future__ import annotations

import json
import time

from ..datasets.dataset import DataSet
from ..datasets.iterators import ListDataSetIterator, next_processed
from .parallel_wrapper import ParallelWrapper
from .sharding import not_ported


class TrainingMasterStats:
    """Phase timeline (reference: SparkTrainingStats / EventStats)."""

    def __init__(self):
        self.events = []

    def record(self, phase, start, duration_s, meta=None):
        self.events.append({"phase": phase, "startMs": int(start * 1000),
                            "durationMs": duration_s * 1000.0,
                            **(meta or {})})

    def phase_total(self, phase):
        return sum(e["durationMs"] for e in self.events
                   if e["phase"] == phase)

    def to_json(self):
        return json.dumps({"events": self.events}, indent=2)

    def export_html(self, path):
        """Minimal timeline export (reference: StatsUtils.exportStatsAsHtml)."""
        rows = "".join(
            f"<tr><td>{e['phase']}</td><td>{e['startMs']}</td>"
            f"<td>{e['durationMs']:.1f}</td></tr>" for e in self.events)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("<html><body><h1>Training phases</h1><table border=1>"
                     "<tr><th>phase</th><th>start(ms)</th><th>duration(ms)"
                     "</th></tr>" + rows + "</table></body></html>")


class ParameterAveragingTrainingMaster:
    """reference: spark/impl/paramavg/ParameterAveragingTrainingMaster.java"""

    class Builder:
        def __init__(self, batch_size_per_worker=16):
            self._batch = int(batch_size_per_worker)
            self._workers = None
            self._avg_freq = 5
            self._collect_stats = False
            self._avg_updaters = True
            self._mesh = None
            self._approach = "export"
            self._export_dir = None
            self._training_hook = None
            self._checkpoint_dir = None
            self._checkpoint_freq = 1
            self._keep_checkpoints = 3
            self._fault_injector = None
            self._health_policy = None

        def rdd_training_approach(self, v):
            """'export' (reference default: batch to disk, stream per split —
            ParameterAveragingTrainingMaster.java:98-103) or 'direct'
            (materialize in host RAM)."""
            v = str(v).lower()
            if v not in ("export", "direct"):
                raise ValueError(f"Unknown training approach '{v}'")
            self._approach = v; return self

        rddTrainingApproach = rdd_training_approach

        def export_directory(self, v):
            self._export_dir = str(v); return self

        exportDirectory = export_directory

        def batch_size_per_worker(self, v):
            self._batch = int(v); return self

        batchSizePerWorker = batch_size_per_worker

        def averaging_frequency(self, v):
            self._avg_freq = max(1, int(v)); return self

        averagingFrequency = averaging_frequency

        def workers(self, v):
            self._workers = int(v); return self

        def average_updaters(self, v):
            self._avg_updaters = bool(v); return self

        def collect_training_stats(self, v):
            self._collect_stats = bool(v); return self

        collectTrainingStats = collect_training_stats

        def mesh(self, m):
            self._mesh = m; return self

        def training_hook(self, hook):
            """Install a TrainingHook (reference spark/api/TrainingHook +
            addHook). A hook with handles_training=True (the parameter-
            server hook) takes over split training: workers push gradients
            to the async GradientsAccumulator instead of parameter
            averaging."""
            self._training_hook = hook; return self

        trainingHook = training_hook

        def checkpoint_directory(self, d):
            raise not_ported("TrainingMaster.checkpoint_directory "
                             "(round checkpoints and crash-resume)", 20)

        checkpointDirectory = checkpoint_directory

        def checkpoint_frequency(self, n):
            """Save every n averaging rounds (default 1)."""
            self._checkpoint_freq = max(1, int(n)); return self

        checkpointFrequency = checkpoint_frequency

        def keep_checkpoints(self, k):
            """Retention for the checkpoint manager (last k + best)."""
            self._keep_checkpoints = max(1, int(k)); return self

        def fault_injector(self, inj):
            """Install a `common.resilience.FaultInjector`; the master
            fires site "master.round" before each averaging round
            trains (crash-injection point for resume tests). The
            injector is also handed to the inner ParallelWrapper, whose
            "wrapper.batch" site is the data-corruption seam."""
            self._fault_injector = inj; return self

        def health_policy(self, policy):
            raise not_ported("TrainingMaster.health_policy (the "
                             "training-health watchdog)", 17)

        def build(self):
            return ParameterAveragingTrainingMaster(
                self._batch, self._workers, self._avg_freq,
                self._avg_updaters, self._collect_stats, self._mesh,
                self._approach, self._export_dir, self._training_hook,
                self._checkpoint_dir, self._checkpoint_freq,
                self._keep_checkpoints, self._fault_injector,
                self._health_policy)

    def __init__(self, batch_size_per_worker=16, workers=None,
                 averaging_frequency=5, average_updaters=True,
                 collect_stats=False, mesh=None, approach="export",
                 export_dir=None, training_hook=None, checkpoint_dir=None,
                 checkpoint_frequency=1, keep_checkpoints=3,
                 fault_injector=None, health_policy=None):
        if checkpoint_dir is not None:
            raise not_ported("TrainingMaster checkpointing", 20)
        if health_policy is not None:
            raise not_ported("TrainingMaster's training-health watchdog", 17)
        import torch.distributed as dist
        self.batch_size = int(batch_size_per_worker)
        self.num_workers = int(workers or (
            dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1))
        self.averaging_frequency = int(averaging_frequency)
        self.average_updaters = average_updaters
        self.collect_stats = collect_stats
        self.mesh = mesh
        self.approach = approach
        self.export_dir = export_dir
        self.stats = TrainingMasterStats() if collect_stats else None
        self.training_hook = training_hook
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_frequency = max(1, int(checkpoint_frequency))
        self.keep_checkpoints = max(1, int(keep_checkpoints))
        self.fault_injector = fault_injector
        self.health_policy = health_policy
        # the round counter, monotonic across execute_training calls (the
        # facade calls once per epoch)
        from ..util.sharded_checkpoint import RoundCheckpointer
        self._gate = RoundCheckpointer(None, owner="training master")
        self._pw = None
        # (data object, [paths], owned_tmpdir) — holds a strong reference to
        # the source and compares with `is`: an id() key could collide when
        # CPython reuses a freed object's address (reference keys by RDD id)
        self._export_cache = None

    # -- config serde (reference: toJson:242) ---------------------------
    def to_json(self):
        return json.dumps({
            "type": "ParameterAveragingTrainingMaster",
            "batchSizePerWorker": self.batch_size,
            "workers": self.num_workers,
            "averagingFrequency": self.averaging_frequency,
            "averageUpdaters": self.average_updaters,
            "rddTrainingApproach": self.approach,
            "exportDirectory": self.export_dir,
            "checkpointDirectory": self.checkpoint_dir,
            "checkpointFrequency": self.checkpoint_frequency,
            "keepCheckpoints": self.keep_checkpoints,
        })

    toJson = to_json

    @staticmethod
    def from_json(s):
        d = json.loads(s)
        return ParameterAveragingTrainingMaster(
            d.get("batchSizePerWorker", 16), d.get("workers"),
            d.get("averagingFrequency", 5), d.get("averageUpdaters", True),
            approach=d.get("rddTrainingApproach", "export"),
            export_dir=d.get("exportDirectory"),
            checkpoint_dir=d.get("checkpointDirectory"),
            checkpoint_frequency=d.get("checkpointFrequency", 1),
            keep_checkpoints=d.get("keepCheckpoints", 3))

    fromJson = from_json

    # ------------------------------------------------------------------
    def _ensure_pw(self, net):
        from .sharding import make_mesh
        if self._pw is None:
            mesh = self.mesh or make_mesh(n_data=self.num_workers,
                                          device=net.device)
            b = (ParallelWrapper.Builder(net)
                 .mesh(mesh)
                 .averaging_frequency(self.averaging_frequency)
                 .average_updaters(self.average_updaters))
            if self.fault_injector is not None:
                b = b.fault_injector(self.fault_injector)
            self._pw = b.build()
        return self._pw

    # -- checkpoint / crash-resume (resilience layer) -------------------
    @property
    def _round(self):
        return self._gate.round

    @property
    def _resume_round(self):
        return self._gate.resume_round

    def _run_round(self, net, batches, hook, hook_trains):
        """One averaging round with the round gate and fault injection.
        Returns True when the round trained."""
        if not self._gate.round_starts():
            return False
        if self.fault_injector is not None:
            self.fault_injector.fire("master.round")
        self._train_split(net, batches, hook, hook_trains)
        self._gate.round_done(net)
        return True

    def execute_training(self, net, data):
        """data: list[DataSet] | DataSetIterator | one big DataSet.
        reference: executeTraining:344 — split, broadcast, map, aggregate.

        approach='export' (default, matching the reference's
        RDDTrainingApproach.Export): the source is streamed ONCE into
        global-batch .npz files (one per ParallelWrapper step), then splits
        stream batch-by-batch from disk — host memory holds at most one
        global batch, so datasets larger than RAM train. approach='direct'
        materializes everything in memory (the reference's Direct mode).

        Every rank of the group runs it over the same data; the wrapper
        gives each its rows."""
        hook = self.training_hook
        hook_trains = hook is not None and getattr(hook, "handles_training",
                                                   False)
        self._gate.maybe_resume(net)
        global_batch = self.num_workers * self.batch_size
        if not hook_trains:
            self._ensure_pw(net)
        try:
            if self.approach == "export":
                paths = self._export_if_required(data, global_batch)
                k = self.averaging_frequency
                for s0 in range(0, len(paths), k):
                    t1 = time.time()
                    split_paths = paths[s0:s0 + k]
                    from ..datasets.iterators import FileDataSetIterator
                    trained = self._run_round(
                        net, FileDataSetIterator(split_paths), hook,
                        hook_trains)
                    if self.stats and trained:
                        self.stats.record("fit", t1, time.time() - t1,
                                          {"minibatches": len(split_paths)})
                return net

            examples = self._collect_examples(data)
            # one "split" = numWorkers*batchSize*averagingFrequency examples
            split_size = global_batch * self.averaging_frequency
            n = examples.num_examples()
            for s0 in range(0, n, split_size):
                t0 = time.time()
                split = DataSet(
                    examples.features[s0:s0 + split_size],
                    examples.labels[s0:s0 + split_size],
                    (examples.features_mask[s0:s0 + split_size]
                     if examples.features_mask is not None else None),
                    (examples.labels_mask[s0:s0 + split_size]
                     if examples.labels_mask is not None else None))
                if self.stats:
                    self.stats.record("split", t0, time.time() - t0,
                                      {"examples": split.num_examples()})
                t1 = time.time()
                batches = list(split.batch_by(global_batch))
                trained = self._run_round(net, batches, hook, hook_trains)
                if self.stats and trained:
                    self.stats.record("fit", t1, time.time() - t1,
                                      {"minibatches": len(batches)})
            return net
        finally:
            if hook_trains:
                hook.detach()   # flush accumulator, capture PS stats

    def _train_split(self, net, batches, hook, hook_trains):
        """One split. Default: one round of the wrapper's k local steps
        per rank and the average over the group. With a handles_training
        hook installed (reference ParameterServerTrainingHook), the split's
        workers push gradients to the async accumulator instead. Observer
        hooks fire at split granularity, as in the reference."""
        if hook_trains:
            if not isinstance(batches, list):
                batches = self._drain(batches)
            hook.process_split(net, batches)
            return
        if hook is not None:
            hook.pre_update(None, net)
        self._pw.fit(batches if not isinstance(batches, list)
                     else ListDataSetIterator(batches))
        if hook is not None:
            hook.post_update(None, net)

    @staticmethod
    def _drain(it):
        out = []
        it.reset()
        while it.has_next():
            out.append(next_processed(it))
        return out

    executeTraining = execute_training

    def _export_if_required(self, data, global_batch):
        """Stream `data` into one .npz per global batch, once per source
        (reference: exportIfRequired:351 — saves batched DataSets to temp
        storage, caches by RDD id, streams paths thereafter)."""
        import os
        import tempfile
        if self._export_cache is not None and \
                self._export_cache[0] is data:
            return self._export_cache[1]
        t0 = time.time()
        if self.export_dir:
            d = self.export_dir
            os.makedirs(d, exist_ok=True)
        else:
            d = tempfile.mkdtemp(prefix="dl4j_tpu_export_")
        paths = []
        pending = []        # list of row-chunks not yet one global batch
        pending_rows = 0

        def flush(chunks):
            p = os.path.join(d, f"dataset_{len(paths)}.npz")
            (chunks[0] if len(chunks) == 1
             else DataSet.merge(chunks)).save(p)
            paths.append(p)

        for ds in self._iter_source(data):
            start = 0
            n = ds.num_examples()
            while start < n:
                take = min(global_batch - pending_rows, n - start)
                pending.append(DataSet(
                    ds.features[start:start + take],
                    ds.labels[start:start + take]
                    if ds.labels is not None else None,
                    ds.features_mask[start:start + take]
                    if ds.features_mask is not None else None,
                    ds.labels_mask[start:start + take]
                    if ds.labels_mask is not None else None))
                pending_rows += take
                start += take
                if pending_rows == global_batch:
                    flush(pending)
                    pending, pending_rows = [], 0
        if pending:
            flush(pending)
        if self.stats:
            self.stats.record("export", t0, time.time() - t0,
                              {"files": len(paths)})
        self._export_cache = (data, paths, d)
        return paths

    @staticmethod
    def _iter_source(data):
        if isinstance(data, DataSet):
            yield data
        elif isinstance(data, (list, tuple)):
            yield from data
        else:
            data.reset()
            while data.has_next():
                yield next_processed(data)

    @staticmethod
    def _collect_examples(data):
        if isinstance(data, DataSet):
            return data
        if isinstance(data, (list, tuple)):
            return DataSet.merge(list(data))
        # iterator
        data.reset()
        items = []
        while data.has_next():
            items.append(next_processed(data))
        return DataSet.merge(items)


class TpuDl4jMultiLayer:
    """User facade (reference: SparkDl4jMultiLayer.java: fit/evaluate over
    the cluster; here the cluster is the process group)."""

    def __init__(self, network, training_master):
        self.network = network
        self.training_master = training_master

    def fit(self, data, num_epochs=1):
        for _ in range(num_epochs):
            self.training_master.execute_training(self.network, data)
        return self.network

    def evaluate(self, data):
        if isinstance(data, (list, tuple)):
            data = ListDataSetIterator(list(data))
        return self.network.evaluate(data)

    def get_network(self):
        return self.network

    getNetwork = get_network


TpuComputationGraph = TpuDl4jMultiLayer   # the same facade serves graphs
