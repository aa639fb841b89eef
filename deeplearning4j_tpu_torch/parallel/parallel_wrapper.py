"""ParallelWrapper: data-parallel training over a `torch.distributed` group.

Port of deeplearning4j_tpu/parallel/parallel_wrapper.py. The reference
partitions one jitted step over a device mesh; here every rank of a process
group runs the wrapper on the same stream of global batches (SPMD), takes
its own rows of each (`sharding.put_sharded`: rank order is row order), and
the collectives are explicit (`sharding.all_reduce_mean`):

- averaging_frequency == 1 (all-reduce mode, the reference's GSPMD step):
  each rank computes its local mean loss and gradients; the gradients and
  the score go as ONE flat buffer per dtype through an all-reduce (sum,
  then divide by n, in at least f32: gloo has no `ReduceOp.AVG`); only then
  the updaters normalise and clip them (the reference normalises the
  global gradient, and clipping is not linear) and apply them, the same on
  every rank. BatchNorm's statistics span the group
  (`Network.batch_stats_over`), as the reference's mean over a batch
  sharded on "data" is a mean over the global batch. The score is the mean
  of the ranks' scores.

- averaging_frequency k > 1 (the reference's shard_map program): each rank
  runs k local steps on its rows of each of k batches, BatchNorm's
  statistics local, then the parameters, the layer state and, with
  `average_updaters` (the default), the updater state are averaged over the
  group, again one flat buffer per dtype. The score is the mean over the
  ranks of the mean of the k step scores. A ragged tail batch is padded to
  the group's batch size B by wrapping its rows (`_pad_to`), and a short
  last round runs only the batches that remain, as the reference does.

Counters: `iteration_count` advances by 1 a batch (by k a round), and
`_last_batch_size` is the global batch size. The network's listeners hear
`iteration_done` once a round (a batch, or k local steps), as the
reference's. The fault injector fires
"wrapper.round" before each round and "wrapper.batch" on each batch's
features (`common.resilience`, `datasets.iterators.inject_features`).

`.health_policy()` arms the training-health watchdog on the network
(`common.health`). In all-reduce mode the health scalars are those of the
reduced gradient and score, so every rank gates alike; in k-step mode each
rank gates each local step on its own gradient, and the round's health is
the group's: the skipped steps summed (`bad_steps` of `steps`), the
largest gradient norms, the mean of the finite step scores (a partial
round counts its skips and applies the average). A divergence rolls back
through the round checkpoints (`.checkpointing()`, or a seam the master
installs as `_ext_rollback`); a skipped or diverged round is never
checkpointed. `.checkpointing()` also gives crash-resume: re-running the
same fit on a fresh network restores the newest round and skips the rounds
it covers (`util.sharded_checkpoint.RoundCheckpointer`).

The process group is the caller's: start the ranks with torch.distributed
(torchrun, or `init_process_group` on each; `parallel.distributed.
initialize` picks NCCL where each rank has its own card, gloo otherwise).
Gloo carries CPU tensors only, so on it a CUDA buffer goes through the
host; that is how several ranks share one card. `workers(n)` with n > 1
raises unless the group has n ranks: nothing ever trains on one rank in
place of n. On one rank without a group the wrapper is plain `fit`, bit for
bit, in both modes.

Not ported yet (NotImplementedError naming the ROADMAP.md queue 1 item):
`.tensor_parallel(True)`, `.sharded_updater_state(True)`, `lower_step` and
`lower_kstep` (item 20).
"""
from __future__ import annotations


import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..common import health as H
from ..datasets.dataset import DataSet, MultiDataSet
from ..datasets.iterators import ListDataSetIterator, next_processed
from ..util.sharded_checkpoint import RoundCheckpointer
from .sharding import (all_reduce_mean, all_reduce_op, all_reduce_sum,
                       make_mesh, not_ported, put_sharded, replicate)


class ParallelWrapper:
    class Builder:
        def __init__(self, model):
            self.model = model
            self._workers = None
            self._avg_freq = 1
            self._prefetch = 2
            self._avg_updaters = True
            self._mesh = None
            self._checkpoint = None
            self._fault_injector = None
            self._health_policy = None

        def checkpointing(self, directory, every_n_rounds=1, keep_last=3,
                          resume=True):
            """Save the network's whole training state every
            `every_n_rounds` averaging rounds (all-reduce mode: a batch;
            k-step mode: a k-group) under `directory`; with `resume` (the
            default) a fit on a fresh network restores the newest round and
            skips the rounds it covers, so re-running a crashed command
            resumes mid-epoch. Use a fresh directory for a new run."""
            self._checkpoint = {"directory": str(directory),
                                "every": max(1, int(every_n_rounds)),
                                "keep_last": max(1, int(keep_last)),
                                "resume": bool(resume)}
            return self

        def fault_injector(self, inj):
            """A `common.resilience.FaultInjector`: site "wrapper.round"
            fires before each averaging round, "wrapper.batch" on every
            batch's features before it is split over the ranks."""
            self._fault_injector = inj; return self

        def health_policy(self, policy):
            """Arm the training-health watchdog (a TrainingHealthPolicy,
            or True for its defaults): non-finite steps are skipped on the
            device, a divergence rolls back to the last checkpointed round
            (with `.checkpointing(...)`, or a master's seam), N consecutive
            bad rounds abort naming them."""
            self._health_policy = policy; return self

        def workers(self, n):
            self._workers = int(n); return self

        def averaging_frequency(self, k):
            self._avg_freq = max(1, int(k)); return self

        averagingFrequency = averaging_frequency

        def prefetch_buffer(self, n):
            self._prefetch = int(n); return self

        prefetchBuffer = prefetch_buffer

        def average_updaters(self, v):
            self._avg_updaters = bool(v); return self

        averageUpdaters = average_updaters

        def report_score_after_averaging(self, v):
            return self  # scores always reported

        reportScoreAfterAveraging = report_score_after_averaging

        def tensor_parallel(self, v):
            if v:
                raise not_ported("ParallelWrapper.tensor_parallel(True)", 20)
            return self

        def sharded_updater_state(self, v):
            if v:
                raise not_ported("ParallelWrapper.sharded_updater_state"
                                 "(True) (ZeRO-style optimizer state)", 20)
            return self

        def mesh(self, mesh):
            """A `sharding.DataMesh` (`make_mesh`), in place of the world
            group."""
            self._mesh = mesh; return self

        def build(self):
            return ParallelWrapper(self.model, self._workers, self._avg_freq,
                                   self._avg_updaters, mesh=self._mesh,
                                   checkpoint=self._checkpoint,
                                   fault_injector=self._fault_injector,
                                   health_policy=self._health_policy)

    def __init__(self, model, workers=None, averaging_frequency=1,
                 average_updaters=True, tensor_parallel=False, mesh=None,
                 sharded_updater_state=False, checkpoint=None,
                 fault_injector=None, health_policy=None):
        if tensor_parallel:
            raise not_ported("ParallelWrapper tensor parallelism", 20)
        if sharded_updater_state:
            raise not_ported("ParallelWrapper's sharded updater state", 20)
        self.model = model
        model._ensure_init()
        if mesh is None:
            mesh = make_mesh(n_data=workers, device=model.device)
        elif workers is not None and int(workers) != mesh.size:
            raise ValueError(f"workers({workers}) but the mesh has "
                             f"{mesh.size} ranks")
        if mesh.device != model.device:
            raise ValueError(f"the mesh computes on {mesh.device}, the "
                             f"network on {model.device}")
        self.mesh = mesh
        self.workers = mesh.size
        self.averaging_frequency = int(averaging_frequency)
        self.average_updaters = bool(average_updaters)
        self.fault_injector = fault_injector
        self.checkpoint = checkpoint
        # the round counter (monotonic across fit() calls and epochs) and
        # the checkpoint / crash-resume gate
        cp = checkpoint or {}
        self._gate = RoundCheckpointer(cp.get("directory"),
                                       every=cp.get("every", 1),
                                       keep_last=cp.get("keep_last", 3),
                                       resume=cp.get("resume", True),
                                       owner="parallel wrapper")
        # the watchdog lives on the network; the wrapper supplies the
        # rollback seam: its own round checkpoints, or (manager,
        # on_restored) installed by a TrainingMaster
        if health_policy is not None:
            H.install(model, health_policy)
        self._ext_rollback = None
        self._sharded = False

    # ------------------------------------------------------------------
    def _ensure_sharded(self):
        """Every rank starts from rank 0's parameters, updater state and
        layer state (a broadcast; nothing on one rank)."""
        if self._sharded:
            return
        net = self.model
        replicate(_params(net) + _updater_leaves(net) + _state(net),
                  self.mesh)
        self._sharded = True

    def _round_starts(self):
        """True when this averaging round must run; fires the fault
        injector's "wrapper.round" site first."""
        if not self._gate.round_starts():
            return False
        if self.fault_injector is not None:
            self.fault_injector.fire("wrapper.round")
        return True

    def _round_done(self):
        self._gate.round_done(self.model)

    def _handle_health(self, health, round_index):
        """Classify one round's health (a dict of device scalars) and act;
        a rollback goes through the round-checkpoint seam. Returns the
        action taken (an abort raises)."""
        return H.apply_policy(self.model._health_policy,
                              H.host_health(health), round_index=round_index,
                              rollback=self._health_rollback)

    def _health_rollback(self):
        """Restore the last checkpointed round: the wrapper's own
        `.checkpointing(...)` manager, or the seam a TrainingMaster
        installed (`_ext_rollback = (manager, on_restored)`). The restore
        rewinds the parameters, updater and layer state, the generator and
        the counters on every rank (each reads the same file). Returns the
        restored round, or False when no checkpoint exists."""
        if self._ext_rollback is not None:
            mgr, on_restored = self._ext_rollback
        else:
            mgr = self._gate.manager()
            on_restored = lambda s: setattr(self._gate, "round", int(s))  # noqa: E731
        if mgr is None or mgr.latest_step() is None:
            return False
        last = mgr.latest_step()
        mgr.restore(self.model, last)
        self._sharded = False
        self._ensure_sharded()
        on_restored(last)
        return last

    def _inject_batch(self, ds):
        """Payload-corruption seam: site "wrapper.batch" (see
        datasets.iterators.inject_features)."""
        from ..datasets.iterators import inject_features
        return inject_features(self.fault_injector, "wrapper.batch", ds)

    def _local(self, ds):
        """This rank's rows of a global batch (all of it on one rank)."""
        if self.mesh.size == 1:
            return ds
        return _map_arrays(ds, lambda a: put_sharded(a, self.mesh))

    def _device_batch(self, ds):
        net = self.model
        return net._batch(net._dataset(self._local(ds)))

    def lower_step(self, ds):
        raise not_ported("ParallelWrapper.lower_step (the mesh-cost "
                         "profiling hook)", 20)

    def lower_kstep(self, batches):
        raise not_ported("ParallelWrapper.lower_kstep (the mesh-cost "
                         "profiling hook)", 20)

    # ------------------------------------------------------------------
    def fit(self, data, num_epochs=1):
        net = self.model
        self._gate.maybe_resume(net)
        self._ensure_sharded()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListDataSetIterator([data])
        for _ in range(num_epochs):
            data.reset()
            if self.averaging_frequency == 1:
                self._fit_allreduce(data)
            else:
                self._fit_local_steps(data)
        return self

    # -- mode 1: per-step gradient all-reduce --------------------------
    def _reduce(self, grads, score):
        """The ranks' mean gradient and score: one all-reduce of one flat
        buffer per dtype (nothing on one rank)."""
        if self.mesh.size == 1:
            return grads, score
        keys = [(key, k) for key, per in grads.items() for k in per]
        means = all_reduce_mean([grads[key][k] for key, k in keys]
                                + [score.reshape(1)], self.mesh)
        out = {key: {} for key in grads}
        for (key, k), m in zip(keys, means):
            out[key][k] = m
        return out, means[-1].reshape(())

    def _fit_allreduce(self, it):
        net = self.model
        group = self.mesh.group
        while it.has_next():
            ds = next_processed(it)
            if not self._round_starts():
                continue
            ds = self._inject_batch(ds)
            batch = self._device_batch(ds)
            with obs.TRACER.span("train.dispatch", cat="train",
                                 data_parallel=self.mesh.size), \
                    net.batch_stats_over(group):
                net._train_step(lambda rng: net._loss(*batch, True, rng),
                                reduce=self._reduce)
            net._last_batch_size = _num_rows(ds)
            if net._health_policy is not None:
                # the reduced gradient's health: alike on every rank
                action = self._handle_health(net._step_health,
                                             self._gate.round)
                if action == H.ROLLBACK:
                    continue    # counters and generator rewound
                if action != H.SKIP:
                    net._score = net._step_score
                net.conf.iteration_count += 1
                net._fire_iteration_done()
                if action != H.OK:
                    continue    # a skipped or diverged round is never saved
            else:
                net._fire_iteration_done()
            self._round_done()

    # -- mode 2: k local steps, then averaging -------------------------
    def _fit_local_steps(self, it):
        k = self.averaging_frequency
        pending = []
        while it.has_next():
            pending.append(self._inject_batch(next_processed(it)))
            if len(pending) == k:
                if self._round_starts():
                    if self._run_kstep(pending) == H.OK:
                        self._round_done()
                pending = []
        if pending:
            # ragged tail: the batches that remain, no duplicated steps
            if self._round_starts():
                if self._run_kstep(pending) == H.OK:
                    self._round_done()

    @staticmethod
    def _pad_to(arr, b):
        """Pad a ragged tail batch up to size b by wrapping rows."""
        if arr is None or arr.shape[0] == b:
            return arr
        idx = np.resize(np.arange(arr.shape[0]), b)
        if isinstance(arr, torch.Tensor):
            return arr[torch.as_tensor(idx, device=arr.device)]
        return np.asarray(arr)[idx]

    def _run_kstep(self, batches):
        """One round of k local steps, then the average over the group.
        Returns the health action (OK when disarmed)."""
        net = self.model
        k = len(batches)
        B = max(_num_rows(b) for b in batches)
        armed = net._health_policy is not None
        scores, healths = [], []
        with obs.TRACER.span("train.dispatch", cat="train", local_steps=k,
                             data_parallel=self.mesh.size):
            for ds in batches:
                batch = self._device_batch(
                    _map_arrays(ds, lambda a: self._pad_to(a, B)))
                net._train_step(lambda rng, b=batch: net._loss(*b, True, rng))
                scores.append(net._step_score if armed else net._score)
                healths.append(net._step_health)
            scores = torch.stack(scores)
            if armed:
                score, health = self._round_health(scores,
                                                   H.stack_health(healths))
            else:
                score = scores.mean()
            if self.mesh.size > 1:
                # the reference's pmean over "data": parameters, layer
                # state, (optionally) updater state and the score
                tensors = (_params(net) + _state(net)
                           + (_updater_leaves(net) if self.average_updaters
                              else []))
                means = all_reduce_mean(
                    tensors + ([] if armed else [score.reshape(1)]),
                    self.mesh)
                with torch.no_grad():
                    for t, m in zip(tensors, means):
                        t.copy_(m)
                if not armed:
                    score = means[-1].reshape(())
        action = H.OK
        if armed:
            action = self._handle_health(health, self._gate.round)
            if action == H.ROLLBACK:
                return action   # counters and generator rewound
            net.conf.iteration_count += k
        if action != H.SKIP:
            net._score = score
        net._last_batch_size = B
        net._fire_iteration_done()
        return action

    def _round_health(self, scores, hs):
        """A k-step round's score and health over the group: each rank
        skipped its own non-finite local steps, so the round's score is the
        mean of the finite step scores, its norms the largest, and
        `bad_steps` of `steps` counts the skipped ones (the policy counts a
        partial round's skips and keeps the average)."""
        fin = hs["all_finite"]
        k = int(fin.shape[0])
        sums = torch.stack([fin.float().sum(),
                            torch.where(fin, scores.float(),
                                        torch.zeros_like(scores.float()))
                            .sum(),
                            (~fin).float().sum()])
        maxes = torch.stack([hs["grad_norm"].max()]
                            + [v.max() for v in
                               hs["layer_grad_norms"].values()])
        all_ok = fin.all().float().reshape(1)
        if self.mesh.size > 1:
            sums = all_reduce_sum(sums, self.mesh.group)
            maxes = all_reduce_op(maxes, self.mesh.group, dist.ReduceOp.MAX)
            all_ok = all_reduce_op(all_ok, self.mesh.group,
                                   dist.ReduceOp.MIN)
        n_ok, s_sum, bad = sums[0], sums[1], sums[2]
        score = torch.where(n_ok > 0, s_sum / torch.clamp(n_ok, min=1.0),
                            torch.full_like(s_sum, float("nan")))
        keys = list(hs["layer_grad_norms"])
        return score, {"score": score, "grad_norm": maxes[0],
                       "layer_grad_norms": {key: maxes[1 + i]
                                            for i, key in enumerate(keys)},
                       "all_finite": all_ok[0] > 0,
                       "bad_steps": bad,
                       "steps": k * self.mesh.size}


def _params(net):
    return [p for per in net._params.values() for p in per.values()]


def _state(net):
    return [b for st in net._states().values() for b in st.values()]


def _updater_leaves(net):
    return [t for per in net._updater_state.values()
            for st in per.values() for t in st.values()]


def _num_rows(ds):
    f = ds.features
    if isinstance(f, dict):
        f = next(iter(f.values()))
    elif isinstance(f, (list, tuple)):
        f = f[0]
    return int(f.shape[0])


def _map_arrays(ds, fn):
    """A copy of a DataSet or MultiDataSet with fn applied to every array
    (features, labels and masks; lists and dicts leaf by leaf)."""
    def each(a):
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return [each(x) for x in a]
        if isinstance(a, dict):
            return {n: each(x) for n, x in a.items()}
        return fn(a)

    out = ds.shallow_copy()
    for name in ("features", "labels", "features_mask", "labels_mask",
                 "features_masks", "labels_masks"):
        if hasattr(out, name):
            setattr(out, name, each(getattr(out, name)))
    return out
