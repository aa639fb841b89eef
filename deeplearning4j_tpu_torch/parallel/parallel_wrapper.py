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

In all-reduce mode the step honours the network's activation-stats
arming (`collect_activation_stats`), re-read every batch, so a listener
that arms it mid-fit takes effect on the next batch: each rank sums its
rows' activations (x, x^2, |x| and the count per layer, in f64), one
all-reduce makes them the global batch's, and the grids are rank 0's first
row, the global batch's first. Those are collectives, so every rank arms
alike (`collect_activation_stats` on each; a listener may sit on rank 0
alone). The k-local-steps mode does not collect them (k batches a round),
as the reference's does not.

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

`.tensor_parallel(True)` and `.sharded_updater_state(True)` (all-reduce
mode) split what each rank stores while a fit runs, over a ("data",
"model") mesh (without a mesh: n_model = 2 when the worker count is even,
as the reference picks):

- tensor parallelism: each "model" rank keeps its slice of every parameter
  the reference's table splits (`sharding.param_specs_for_layer`: dense,
  output, autoencoder and embedding W's columns and b, convolution
  out-channels; an axis that does not divide stays whole), and of those
  parameters' updater state, and computes only its columns of those
  layers, as the reference's GSPMD step partitions their products
  (`sharding.ColumnParallel`, Megatron column parallelism with a gathered
  output): the layer's whole input, its slice of the pre-activation from
  this rank's slices of W and b, an all-gather of the pre-activation over
  "model" forward, the activation (or the loss) on the whole of it; in
  the backward each rank keeps its slice of dY, and dX is all-reduced
  over "model". No weight is gathered: the gradients come out sliced.
  Every other layer (pooling, BatchNorm, LSTM, a layer whose axis does
  not divide) runs whole on every model rank. The gradient norms that
  the per-layer normalisation and the health watchdog read, and the
  L1/L2 penalty, are summed over "model" (one all-reduce each). The
  gradients are then averaged over "data" and each rank updates its own
  slices. `ComputationGraph(remat_segments=True)` under it raises.
- the ZeRO-1 analogue: each "data" rank keeps its slice of every updater
  state leaf that divides (the first dimension that does,
  `sharding.zero_state_sharding`), updates that slice of the parameter,
  and all-gathers the updated slices over "data". The updaters are
  elementwise, so the step is bit-equal to the replicated one.

Listeners hear each round with the parameters whole: while some rank's
network has listeners, every rank all-gathers the "model" slices around
`iteration_done` and puts them back after. The parameters and the state
are whole again at the end of each fit, so
the network serves, saves and restores as usual. A round checkpoint taken
while the state is split is written shard by shard by every rank
(`util.sharded_checkpoint`, through torch.distributed.checkpoint), and any
checkpoint restores into whatever layout the network has. The k-step mode runs on whole parameters
(the reference's k-step program replicates them too), and
`.sharded_updater_state(True)` with it raises ValueError, as the
reference's does.

`lower_step` / `lower_kstep` are the mesh-cost hooks: one step (or one
k-step round) run under `mesh_cost`'s recorder on every rank, after which
the parameters, the updater and layer state, the dropout generator and the
counters are put back bit for bit; each returns a `mesh_cost.Lowered`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..common import health as H
from ..datasets.dataset import DataSet, MultiDataSet
from ..datasets.iterators import ListDataSetIterator, next_processed
from ..nn.updater import updaters as U
from ..util.sharded_checkpoint import RoundCheckpointer
from .sharding import (ColumnParallel, all_gather, all_reduce_mean,
                       all_reduce_op, all_reduce_sum, make_mesh, put_sharded,
                       replicate, shard_params, shard_slice,
                       zero_state_sharding)


class ParallelWrapper:
    class Builder:
        def __init__(self, model):
            self.model = model
            self._workers = None
            self._avg_freq = 1
            self._prefetch = 2
            self._avg_updaters = True
            self._tensor_parallel = False
            self._sharded_updater_state = False
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
            """Split the big layers' parameters over the mesh's "model"
            axis while a fit runs (all-reduce mode)."""
            self._tensor_parallel = bool(v); return self

        def sharded_updater_state(self, v):
            """The ZeRO-1 analogue: each data rank keeps and updates 1/n of
            the updater state. Requires averaging_frequency == 1."""
            self._sharded_updater_state = bool(v); return self

        def mesh(self, mesh):
            """A ("data", "model") `sharding.Mesh` (`make_mesh`), in place
            of the world group."""
            self._mesh = mesh; return self

        def build(self):
            return ParallelWrapper(self.model, self._workers, self._avg_freq,
                                   self._avg_updaters,
                                   tensor_parallel=self._tensor_parallel,
                                   mesh=self._mesh,
                                   sharded_updater_state=(
                                       self._sharded_updater_state),
                                   checkpoint=self._checkpoint,
                                   fault_injector=self._fault_injector,
                                   health_policy=self._health_policy)

    def __init__(self, model, workers=None, averaging_frequency=1,
                 average_updaters=True, tensor_parallel=False, mesh=None,
                 sharded_updater_state=False, checkpoint=None,
                 fault_injector=None, health_policy=None):
        self.model = model
        model._ensure_init()
        if mesh is None:
            n = workers
            if n is None:
                n = (dist.get_world_size() if dist.is_available()
                     and dist.is_initialized() else 1)
            n_model = 2 if (tensor_parallel and n % 2 == 0) else 1
            mesh = make_mesh(n_data=n // n_model, n_model=n_model,
                             device=model.device)
        elif workers is not None and int(workers) != mesh.n_ranks:
            raise ValueError(f"workers({workers}) but the mesh has "
                             f"{mesh.n_ranks} ranks")
        if mesh.device != model.device:
            raise ValueError(f"the mesh computes on {mesh.device}, the "
                             f"network on {model.device}")
        self.mesh = mesh
        self.workers = mesh.size
        self.averaging_frequency = int(averaging_frequency)
        self.average_updaters = bool(average_updaters)
        self.tensor_parallel = bool(tensor_parallel)
        self.sharded_updater_state = bool(sharded_updater_state)
        if self.sharded_updater_state and self.averaging_frequency != 1:
            raise ValueError(
                "sharded_updater_state requires averaging_frequency=1 "
                "(k-local-steps carries updater state rank-locally)")
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
        self._split = None     # the split layout while a fit runs
        self._whole = False    # listeners see split parameters whole

    # ------------------------------------------------------------------
    def _ensure_sharded(self):
        """Every rank starts from rank 0's parameters, updater state and
        layer state (a broadcast; nothing on one rank); then, with tensor
        parallelism or the sharded updater state in all-reduce mode, each
        rank keeps only its slices (`_split_state`)."""
        if not self._sharded:
            net = self.model
            replicate(_params(net) + _updater_leaves(net) + _state(net),
                      self.mesh)
            self._sharded = True
        if self._splits() and self._split is None:
            self._split_state()

    def _splits(self):
        return (self.averaging_frequency == 1
                and (self.sharded_updater_state
                     or (self.tensor_parallel
                         and self.mesh.axis_size("model") > 1)))

    @torch.no_grad()
    def _split_state(self):
        """Keep this rank's slices: each tensor-parallel parameter and its
        updater state over "model", then each updater state leaf over
        "data" (ZeRO). Records the layout in `_split`, {(key, param):
        (its "model" dim, {state name: its "data" dim})}, and for the
        checkpoints in `net._shard_layout`."""
        net, mesh = self.model, self.mesh
        net._fused_cache = None     # a captured group holds the old tensors
        nm, im = mesh.axis_size("model"), mesh.index("model")
        tp = (shard_params(net, mesh, tensor_parallel=True)[1]
              if self.tensor_parallel and nm > 1 else None)
        layout = {}
        for key, _ in net._keyed_layers():
            slot, ust = net._slot(key), net._updater_state[key]
            for name, p in slot.params.items():
                md = None if tp is None else tp[key][name]
                if md is not None:
                    for s, t in ust[name].items():
                        if _follows(t, p):
                            ust[name][s] = shard_slice(t, md, im,
                                                       nm).contiguous()
                    p.data = shard_slice(p.data, md, im, nm).contiguous()
                layout[(key, name)] = md
        zero = (zero_state_sharding(net._updater_state, mesh)
                if self.sharded_updater_state else None)
        nd, idd = mesh.axis_size("data"), mesh.index("data")
        split = {}
        for key, _ in net._keyed_layers():
            ust = net._updater_state[key]
            for name in net._slot(key).params:
                dims = {} if zero is None else zero[key][name]
                for s, d in dims.items():
                    if d is not None:
                        ust[name][s] = shard_slice(ust[name][s], d, idd,
                                                   nd).contiguous()
                split[(key, name)] = (layout[(key, name)], dims)
        self._split = split
        # the layout checkpoints write and restore by (util.sharded_checkpoint)
        leaves = {}
        for (key, name), (md, dims) in split.items():
            p = net._slot(key).params[name]
            leaves[("params", str(key), name)] = (md, None)
            for s, t in net._updater_state[key][name].items():
                leaves[("updater_state", str(key), name, s)] = (
                    md if _follows(t, p) else None, dims.get(s))
        net._shard_layout = (mesh, leaves)
        # while listeners see the parameters whole (`_iteration_done`)
        self._whole_layout = (mesh, {
            k: (None, None) if k[0] == "params" else v
            for k, v in leaves.items()})

    @torch.no_grad()
    def _join_state(self):
        """The whole parameters and updater state again on every rank."""
        if self._split is None:
            return
        net, mesh = self.model, self.mesh
        net._fused_cache = None
        net._shard_layout = None
        g_m, g_d = mesh.axis_group("model"), mesh.axis_group("data")
        for (key, name), (md, dims) in self._split.items():
            ust = net._updater_state[key][name]
            for s, d in dims.items():
                if d is not None:
                    ust[s] = all_gather(ust[s], g_d, d)
            if md is not None:
                p = net._slot(key).params[name]
                for s, t in ust.items():
                    if _follows(t, p):
                        ust[s] = all_gather(t, g_m, md)
                p.data = all_gather(p.data, g_m, md)
        self._split = None

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
        self._join_state()
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

    def _recorded(self, step):
        """`mesh_cost.run_recorded` over the whole training state: the
        parameters, the updater and layer state, the dropout generator and
        the counters are put back after `step()`."""
        from .mesh_cost import run_recorded
        net = self.model
        was_split = self._split is not None
        self._ensure_sharded()
        held = _params(net) + _updater_leaves(net) + _state(net)
        counters = (net.conf.iteration_count, net._score,
                    net._last_batch_size, net._step_score, net._step_health)
        try:
            return run_recorded(step, held, net.device,
                                generators=(net._dropout_gen,))
        finally:
            (net.conf.iteration_count, net._score, net._last_batch_size,
             net._step_score, net._step_health) = counters
            if not was_split:
                self._join_state()

    def lower_step(self, ds):
        """The mesh-cost hook of the all-reduce step: one step on `ds`
        under the recorder, everything put back (`_recorded`)."""
        net = self.model

        def step():
            batch = self._device_batch(ds)
            with net.batch_stats_over(self.mesh.group):
                self._one_step(batch)

        return self._recorded(step)

    def lower_kstep(self, batches):
        """The mesh-cost hook of the k-local-steps round: one round on the
        k DataSets `batches` under the recorder, everything put back."""
        net = self.model
        health = net._health_policy
        net._health_policy = None
        try:
            return self._recorded(lambda: self._run_kstep(list(batches)))
        finally:
            net._health_policy = health

    # ------------------------------------------------------------------
    def fit(self, data, num_epochs=1):
        net = self.model
        self._gate.maybe_resume(net)
        self._ensure_sharded()
        self._whole = self._listeners_see_whole()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListDataSetIterator([data])
        try:
            for _ in range(num_epochs):
                data.reset()
                if self.averaging_frequency == 1:
                    self._fit_allreduce(data)
                else:
                    self._fit_local_steps(data)
        finally:
            self._whole = False
            self._join_state()
        return self

    def _one_step(self, batch):
        """One all-reduce step: the network's own step with the
        all-reduce in it, or the split step while the state is split."""
        net = self.model
        if self._split is None:
            net._train_step(lambda rng: net._loss(*batch, True, rng),
                            reduce=self._reduce)
        else:
            self._split_train_step(batch)

    def _split_train_step(self, batch):
        """`Network._train_step` on split state. The masters are this
        rank's own slices; the layers split over "model" compute their
        columns (`sharding.ColumnParallel`, installed with the network's
        `_split_over`), so their gradients come out sliced over "model"
        and the norms, the health gate and the L1/L2 penalty are summed
        over it. Then the network's own all-reduce over "data", and each
        rank's updater on its slice of each parameter and state (the ZeRO
        layout's slice over "data" of a "model" slice), the updated "data"
        slices all-gathered into the parameters."""
        net, mesh = self.model, self.mesh
        g_d = mesh.axis_group("data")
        nd, idd = mesh.axis_size("data"), mesh.index("data")

        @torch.no_grad()
        def update(key, layer, grads, lr, ok, minimize):
            params = net._slot(key).params
            zero, sliced, sliced_grads = {}, {}, {}
            for name, p in params.items():
                zero[name] = _zero_dim(self._split[(key, name)][1])
                sliced[name] = shard_slice(p, zero[name], idd, nd)
                sliced_grads[name] = shard_slice(grads[name], zero[name],
                                                 idd, nd)
            U.apply_layer(layer, sliced, sliced_grads,
                          net._updater_state[key], None, minimize, lr=lr,
                          ok=ok, inplace=True)
            for name, p in params.items():
                if zero[name] is not None:
                    p.copy_(all_gather(sliced[name].contiguous(), g_d,
                                       zero[name]))

        dims = {}
        for (key, name), (md, _) in self._split.items():
            dims.setdefault(key, {})[name] = md
        cp = ColumnParallel(mesh.axis_group("model"), dims)
        with net._split_over(cp if cp.dims else None):
            net._train_step(lambda rng: net._loss(*batch, True, rng),
                            reduce=self._reduce, update=update)

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

    def _act_reduce(self, moments, grids):
        """The global batch's activation moments and grids from this
        rank's: the moments (sums and counts) summed over "data", the grids
        (the first row's) broadcast from rank 0, whose first row is the
        global batch's."""
        if self.mesh.n_ranks == 1:
            return moments, grids
        moments = all_reduce_sum(moments, self.mesh.axis_group("data"))
        replicate(list(grids.values()), self.mesh)
        return moments, grids

    def _listeners_see_whole(self):
        """Whether listeners must hear each round with the parameters split
        over "model" gathered whole: the state is so split and some rank's
        network has listeners. One all-reduce a fit, so that every rank
        takes part in the gathers that follow."""
        split = self._split or {}
        if all(md is None for md, _ in split.values()):
            return False
        net = self.model
        flag = torch.tensor([float(bool(net.listeners))], device=net.device)
        return bool(all_reduce_op(flag, self.mesh.base_group,
                                  dist.ReduceOp.MAX).item())

    def _iteration_done(self):
        """The network's `iteration_done`. With `_whole` (set by `fit`,
        alike on every rank), each parameter split over "model" is
        all-gathered for the listeners, which so read the whole arrays the
        reference's global ones hold, and put back to its slice after."""
        net = self.model
        if not (self._whole and self._split):
            net._fire_iteration_done()
            return
        g_m, slices = self.mesh.axis_group("model"), []
        with torch.no_grad():
            for (key, name), (md, _) in self._split.items():
                if md is not None:
                    p = net._slot(key).params[name]
                    slices.append((p, p.data))
                    p.data = all_gather(p.data, g_m, md)
        layout, net._shard_layout = net._shard_layout, self._whole_layout
        try:
            net._fire_iteration_done()
        finally:
            net._shard_layout = layout
            for p, part in slices:
                p.data = part

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
                    net.batch_stats_over(group), \
                    net._act_stats_step(self._act_reduce):
                self._one_step(batch)
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
                self._iteration_done()
                if action != H.OK:
                    continue    # a skipped or diverged round is never saved
            else:
                self._iteration_done()
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


def _follows(t, p):
    """Whether updater state leaf `t` is laid out as its parameter `p` (a
    moment; a scalar step counter is not)."""
    return t.dim() > 0 and t.dim() == p.dim()


def _zero_dim(dims):
    """The data dimension a parameter's update is split on: its updater
    state leaves' (all of its shape split on one), or None."""
    split = {d for d in dims.values() if d is not None}
    if len(split) > 1:
        raise ValueError(f"updater state leaves split on different "
                         f"dimensions {dims}")
    return split.pop() if split else None


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
