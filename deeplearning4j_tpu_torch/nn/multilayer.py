"""MultiLayerNetwork, the sequential container: port of
deeplearning4j_tpu/nn/multilayer.py (`init`, `fit`, `output`,
`feed_forward`, `score`, `compute_gradient_and_score`, `params`,
`set_params`, `num_params`, `clone`), and `Network`, what it shares with
`nn.graph.ComputationGraph`.

A container is an `nn.Module` of per-layer slots: the parameters, held as
f32 masters in the port's layout (convolution kernels OIHW), and the
layers' state as buffers (BatchNorm's running mean and var). Each forward
casts the parameters and the input to the compute type (`data_type`:
float32, bfloat16 or float64), so the gradients flow back to the f32
masters. A `fit` step is: the loss (the output layer's per-example loss,
mean in f32, plus the L1/L2 terms of the masters), its gradients by
autograd, then each layer's updater with its own state and learning-rate
schedule, in f32 (`updater.updaters.apply_layer`); then the layers' new
state. Where the reference compiles that step into one XLA program, the
port runs it eagerly: cuDNN and cuBLAS for the convolutions and products,
and `torch.autograd.Function`s for the reference's two hand-derived
backwards (`_BNTrain`, `_MaxPoolGather`).

The public API speaks the reference's terms: numpy inputs and outputs,
images NHWC (the port runs them as NCHW in the channels_last memory
format, the same bytes), and `params()` / `set_params()` /
`from_jax_params()` / the model zip in the reference's layout (HWIO
kernels) and flat order (`_param_sort_key`).

Recurrent layers carry their state (h, c) through `forward_with_carry`.
With `backprop_type="tbptt"` a `fit` step is truncated BPTT: the time axis
is cut into `tbptt_fwd_length` segments (the last one short when the
length does not divide T), one updater step per segment, the carries
handed on between segments detached, so no gradient crosses a segment
boundary and memory does not grow with T. `rnn_time_step` streams: the
carries stay on the network between calls until `rnn_clear_previous_state`.

The step is also two pure functions, as the reference's containers expose
it: `make_grad_fn()`, `(params, state, batch) -> (grads, score, new_state,
carries)` on the given parameter tensors (an asynchronous
parameter-server worker computes it on a snapshot), and `make_apply_fn()`,
`(params, ustate, grads, iteration) -> (params, ustate)`, the updaters
(which write the given parameters in place). `_train_step` takes an
optional gradient reduction between the two: `parallel.ParallelWrapper`
all-reduces there, before `normalize_gradients`, since the reference
normalises and clips the global gradient. `batch_stats_over(group)` makes
BatchNorm's training statistics those of the global batch over a process
group for the steps taken inside it.

`fit` also takes a DataSetIterator: the batches are staged onto the
network's device by `datasets.iterators.AsyncDataSetIterator` while the
previous step runs (a bf16 feature wire for bf16 networks), with the
reference's epoch semantics: listeners with `on_epoch_start` /
`on_epoch_end` hear each epoch begin and end. `evaluate` /
`evaluate_regression` score an iterator through the same staging;
`make_inference_fn` is the pure inference step `serving.InferenceServer`
runs.

Entry points run on the CUDA card unless the caller passes device="cpu";
on the card float32 networks run with TF32 off (`card_numerics`).

`fused_steps(K)` takes K optimizer steps a dispatch (`nn.fused`): on the
card K steps are one CUDA graph replay, for the batch loop and for the
TBPTT loop (K full segments a replay, the carries threaded through).
`training_health` arms the watchdog (`common.health`): each step also
computes its health scalars on the device and applies its update only when
they are finite; the host classifies them and skips, rolls back to the
newest checkpoint (`util.sharded_checkpoint`) or aborts. A step's learning
rates come from a device buffer the host fills before it
(`updater.updaters`), so a captured step reads each replay's rates.

Listeners (`set_listeners`, `add_listener`; `optimize.listeners`) hear
`iteration_done(net, iteration)` once per optimizer step, from the host
after the step: the single step, each TBPTT segment, each inner step of a
fused group (in its epilogue, never inside a CUDA graph capture), and a
`parallel.ParallelWrapper` round. With no listener nothing is read on the
host. `_last_batch_size` is the rows of the last batch a fit path took
(`optimize.listeners.PerformanceListener` reads it).
`make_flat_score_fn` is the score as a differentiable function of the flat
parameter vector (`gradientcheck`, `optimize.solvers`).

`pretrain` / `pretrain_layer` train the pretrainable layers (AutoEncoder,
RBM, VariationalAutoencoder) greedily, each on the frozen activations below
it, with the raw updater rule; `fit` never calls them.

`collect_activation_stats` arms the MultiLayerNetwork's step to also
summarise the activations of its training forward (`ui.stats.
StatsListener` reads them): per interior layer the mean, the stdev and the
mean magnitude in f32 (from f64 sums of x, x^2 and |x|, which a
data-parallel step all-reduces into the global batch's), and for a 4-D
output a downsampled grid of the first example, [h, w, ch] as the
reference's NHWC. They stay on the device in `_last_activation_stats`
until a listener reads them. An armed network runs single steps; a
disarmed step computes nothing more.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from .. import obs  # noqa: F401 (the reference's module-level name)
from ..common import health as H
from ..common.device import card_numerics, resolve_device, to_port, to_public
from ..datasets.dataset import DataSet
from ..datasets.iterators import (AsyncDataSetIterator, DataSetIterator,
                                  ListDataSetIterator, next_processed,
                                  wrap_async_for_fit)
from ..optimize import profiler as P
from . import fused as F
from .conf.layers.recurrent import BaseRecurrentLayer
from .conf.neural_net_configuration import MultiLayerConfiguration
from .updater import updaters as U

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}


def _param_sort_key(k):
    # canonical variable order: W-like first, then recurrent, then biases
    order = {"W": 0, "RW": 1, "b": 2, "gamma": 0, "beta": 1, "mean": 2, "var": 3,
             "vb": 3}
    return (order.get(k, 9), k)


def _pretrainable(layer):
    return hasattr(layer, "pretrain_loss") or hasattr(layer,
                                                      "pretrain_grads")


def mean_score(per_example):
    """The mean of the per-example losses, in f32 at least."""
    if per_example.dtype in (torch.bfloat16, torch.float16):
        per_example = per_example.float()
    return per_example.mean()


class _Slot(nn.Module):
    """One layer's parameters (f32 masters, the port's layout) and state
    buffers."""

    def __init__(self, params, state):
        super().__init__()
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params.items()})
        for k, v in state.items():
            self.register_buffer(k, v)

    def state(self):
        return dict(self.named_buffers(recurse=False))


class Network(nn.Module):
    """What both containers share: parameters and state, the training
    step, the flat parameters and the reference's layouts.

    A subclass names its layers by key (MultiLayerNetwork: the index;
    ComputationGraph: the vertex name) in the flat-parameter order
    (`_keyed_layers`), and says how the reference nests per-layer trees
    (`_tree`: a list or a name-keyed dict)."""

    def __init__(self, conf, device=None):
        super().__init__()
        self.conf = conf
        dt = str(conf.global_conf.get("data_type", "float32"))
        self.compute_dtype = _COMPUTE_DTYPES.get(dt, torch.float32)
        self.param_dtype = torch.float64 if dt == "float64" else torch.float32
        self._device = resolve_device(device)
        self._seed = int(conf.global_conf.get("seed", 123))
        # dropout's random bits (the reference draws them from its PRNG key)
        self._dropout_gen = torch.Generator(self._device).manual_seed(
            self._seed)
        self.slots = None
        self._pos = None
        self._updater_state = None   # key -> param -> state name -> tensor
        self._score = None
        self._rnn_state = None       # rnn_time_step's carries, per layer
        # the process group BatchNorm's training statistics span
        # (batch_stats_over); None: this rank's batch
        self._stats_group = None
        # inside the wrapper's split step, how the layers split over its
        # "model" axis compute (split_over); None: every layer whole
        self._column_parallel = None
        self.listeners = []          # iteration listeners
        self._last_batch_size = 0    # rows of the last batch fit took
        # the training-health watchdog (common.health.install)
        self._health_policy = None
        self._health_gen = 0
        self._health_ckpt = None
        self._health_ckpt_every = 10
        self._step_score = self._step_health = None  # an armed step's
        # fused steps (nn.fused.install) and what the fit loops did
        self._fused_steps = 1
        self._fused_cache = None
        self._lr_leaves_cache = None
        self._lr_single = None       # the single step's [1, P] lr buffer
        self._lr_single_rows = None  # and the rates it holds
        self.fused_counts = {"groups": 0, "graph_replays": 0, "captures": 0,
                             "fused_steps": 0, "single_steps": {}}
        # activation stats (collect_activation_stats): (max channels, max
        # size) while armed, the toggle's generation, the armed step's
        # sink and what its last step left
        self._act_stats_cfg = None
        self._act_stats_gen = 0
        self._act_sink = None
        self._last_activation_stats = None
        self._last_activation_stats_iter = None

    # -- what a subclass provides ------------------------------------------
    def _keyed_layers(self):
        raise NotImplementedError

    def _tree(self, by_key):
        raise NotImplementedError

    def _untree(self, tree):
        raise NotImplementedError

    def _time_steps(self, batch):
        """(T, batch size) of a device batch of sequences."""
        raise NotImplementedError

    def _segment(self, batch, t0, length):
        """The TBPTT segment [t0, t0 + length) of a device batch."""
        raise NotImplementedError

    def _gradient_batch(self, features, labels, fmask, lmask):
        """The device batch of `compute_gradient_and_score`'s arguments."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    @property
    def device(self):
        return self._device

    def init(self, parameters=None):
        """Draw the weights (a torch.Generator seeded from the conf's seed,
        on the CPU, so every device gets the same ones) and zero the
        updater state."""
        if self.slots is None:
            gen = torch.Generator().manual_seed(self._seed)
            keyed = self._keyed_layers()
            self._pos = {key: i for i, (key, _) in enumerate(keyed)}
            self.slots = nn.ModuleList(
                _Slot(layer.init_params(gen, self.param_dtype),
                      layer.init_state()) for _, layer in keyed
            ).to(self._device)
            sd = self.conf.global_conf.get("updater_state_dtype")
            self._updater_state = {}
            for key, layer in keyed:
                init_fn, _ = U.get(layer.updater or "sgd")
                self._updater_state[key] = U.cast_updater_state(
                    {k: init_fn(p.detach())
                     for k, p in self._slot(key).params.items()}, sd)
        if parameters is not None:
            self.set_params(parameters)
        return self

    def _ensure_init(self):
        if self.slots is None:
            self.init()

    def _slot(self, key):
        return self.slots[self._pos[key]]

    def _cast_params(self, masters=None):
        """Every layer's parameters in the compute type (a no-op for f32;
        gradients flow back to the masters): the network's own masters, or
        `masters` ({key: {name: tensor}}) in their place."""
        cdt = self.compute_dtype
        if masters is None:
            masters = {key: self._slot(key).params
                       for key, _ in self._keyed_layers()}
        return {key: {k: p.to(cdt) for k, p in masters[key].items()}
                for key, _ in self._keyed_layers()}

    @contextlib.contextmanager
    def batch_stats_over(self, group):
        """Inside it, BatchNorm's training statistics (forward and
        backward) are the global batch's over the ranks of `group` (a
        torch.distributed process group; None: this rank's batch)."""
        prev, self._stats_group = self._stats_group, group
        try:
            yield
        finally:
            self._stats_group = prev

    @contextlib.contextmanager
    def _split_over(self, column_parallel):
        """Inside it, the layers a `parallel.sharding.ColumnParallel` splits
        compute their slices of their output columns from this rank's
        parameter slices (`_layer_forward`, `_layer_score`), their L1/L2
        penalty and gradient norms are summed over its "model" group
        (`_reg_score`, `_step_body`); the wrapper's split step."""
        prev, self._column_parallel = self._column_parallel, column_parallel
        try:
            yield
        finally:
            self._column_parallel = prev

    def _layer_forward(self, key, layer, params, x, *, train, rng,
                       mask=None, state=None):
        """`layer.forward`, or the column-parallel forward of a layer split
        over "model" (`_split_over`); with `state` (a stateful layer's),
        `layer.forward_with_state` -> (out, new state), its training
        statistics over `_stats_group`. A `layer.<type>` span, which
        times the device where the layer says so (`span_times_device`)."""
        with P.span(layer.span_name,
                    self._device if layer.span_times_device else None):
            if state is not None:
                return layer.forward_with_state(params, x, state,
                                                train=train, rng=rng,
                                                mask=mask,
                                                group=self._stats_group)
            cp = self._column_parallel
            if cp is not None and cp.splits(key):
                return cp.forward(layer, params, x, train=train, rng=rng)
            return layer.forward(params, x, train=train, rng=rng, mask=mask)

    def _layer_score(self, key, layer, params, x, labels, *, train, rng,
                     mask=None):
        """An output layer's per-example loss (`_layer_forward`'s route)."""
        with P.span(layer.span_name,
                    self._device if layer.span_times_device else None):
            cp = self._column_parallel
            if cp is not None and cp.splits(key):
                return cp.score_per_example(layer, params, x, labels,
                                            train=train, rng=rng, mask=mask)
            return layer.compute_score_per_example(params, x, labels,
                                                   train=train, rng=rng,
                                                   mask=mask)

    def _states(self):
        return {key: self._slot(key).state() for key, _ in self._keyed_layers()}

    @property
    def _params(self):
        """Every layer's parameters (the f32 masters, the port's layout),
        keyed as the forward takes them; with `_model_state`, what
        `serving.InferenceServer` reads at build and at each swap."""
        self._ensure_init()
        return {key: dict(self._slot(key).params)
                for key, _ in self._keyed_layers()}

    @property
    def _model_state(self):
        self._ensure_init()
        return self._states()

    def _step(self, batch):
        """num_iterations optimizer steps on one device batch, or with
        truncated BPTT one step per segment."""
        self._last_batch_size = _rows(batch[0])
        if self.conf.backprop_type == "tbptt":
            return self._fit_tbptt(batch)
        for _ in range(int(self.conf.global_conf.get("num_iterations", 1))):
            with P.follow("train.dispatch", cat="train", tracer=True), \
                    self._act_stats_step():
                self._train_step(lambda rng: self._loss(*batch, True, rng))
            if self._health_policy is None:
                self._fire_iteration_done()
            elif self._finish_armed() == H.ROLLBACK:
                break           # counters and generator restored

    @contextlib.contextmanager
    def _act_stats_step(self, reduce=None):
        """Around one training step. Armed (`collect_activation_stats`),
        the step's training forward leaves its layers' moments in the sink
        (`_act_moments`); afterwards `_last_activation_stats` holds their
        summaries, tagged with the step's iteration. `reduce(moments,
        grids)`, when given, turns the rank's moments and grids into the
        global batch's (`parallel.ParallelWrapper`). Disarmed, a no-op."""
        if self._act_stats_cfg is None:
            yield
            return
        it0 = self.conf.iteration_count
        sink = self._act_sink = []
        try:
            yield
        finally:
            self._act_sink = None
        if sink:
            moments, grids = sink[-1]
            if reduce is not None:
                moments, grids = reduce(moments, grids)
            self._last_activation_stats = _act_summaries(moments, grids)
            self._last_activation_stats_iter = it0

    def _fire_iteration_done(self):
        """Tell every listener that the optimizer step (or a data-parallel
        round) numbered `iteration_count - 1` is done. Called on the host,
        after the step."""
        with P.span("train.listeners"):
            for listener in self.listeners:
                listener.iteration_done(self, self.conf.iteration_count - 1)

    def _epoch_event(self, name):
        """`on_epoch_start` / `on_epoch_end` of the listeners that define
        it."""
        for listener in self.listeners:
            hook = getattr(listener, name, None)
            if hook is not None:
                hook(self)

    def _init_carries(self, batch_size):
        """Every recurrent layer's zero carry, by key, in the compute type
        (the reference's choice: a recurrent forward returns its carry in
        the compute type)."""
        return {key: layer.init_carry(batch_size, self.compute_dtype,
                                      self._device)
                for key, layer in self._keyed_layers()
                if isinstance(layer, BaseRecurrentLayer)}

    def _fit_tbptt(self, batch):
        """Truncated BPTT over one device batch: one updater step per
        `tbptt_fwd_length` segment, iteration_count advanced per segment,
        the recurrent state carried across segments without its gradient
        (each segment starts from detached carries). With fused steps, K
        full segments run as one group, the carries threaded through; the
        short tail segment runs single-step; a rollback abandons the rest
        of the sequence."""
        T, n = self._time_steps(batch)
        L = int(self.conf.tbptt_fwd_length)
        carries = self._init_carries(n)
        t0 = 0
        while t0 < T:
            if self._fused_k() > 1:
                g = min(F.group_size(self, self._fused_k()), (T - t0) // L)
                if g > 1:
                    carries, done = self._fit_tbptt_group(batch, carries,
                                                          t0, g, L)
                    if done:
                        return      # rollback: abandon this sequence
                    t0 += g * L
                    continue
                self._count_single("tbptt_tail")
            seg = self._segment(batch, t0, L)
            with P.follow("train.dispatch", cat="train", tracer=True,
                          tbptt=True), self._act_stats_step():
                new = self._train_step(
                    lambda rng: self._loss(*seg, True, rng, carries))
            if self._health_policy is None:
                self._fire_iteration_done()
            else:
                new = H.gate_update(self._step_health["all_finite"], new,
                                    carries)
                if self._finish_armed() == H.ROLLBACK:
                    return      # abandon the rest of this sequence
            carries = _detached(new)
            t0 += L

    def _fit_iterator(self, it, num_epochs):
        """fit over an iterator, with the reference's epoch semantics: a
        plain iterator the caller hands in may be mid-stream, so it is reset
        BEFORE wrapping (the fresh wrapper prefetches from position 0 and
        needs no reset in epoch 0); an AsyncDataSetIterator the caller built
        resets every epoch. With fused steps the staging queue holds a
        whole group ahead."""
        with P.follow("train.fit"):
            wrapped_here = not isinstance(it, AsyncDataSetIterator)
            if wrapped_here:
                it.reset()
            async_it = wrap_async_for_fit(
                it, self.compute_dtype,
                queue_size=max(2, self._fused_steps + 1), device=self._device)
            for epoch in range(num_epochs):
                if epoch > 0 or not wrapped_here or not async_it.has_next():
                    async_it.reset()
                self._epoch_event("on_epoch_start")
                self._fit_stream(async_it)
                self._epoch_event("on_epoch_end")
                self.conf.epoch_count += 1
        return self

    def _fit_stream(self, it):
        """One pass over an iterator with has_next()/next(): single steps,
        or with fused steps groups of K staged batches (a ragged tail and a
        group of mixed shapes run single-step, the same stream)."""
        def next_batch():
            return self._batch(self._dataset(next_processed(it)))

        while it.has_next():
            k = (self._fused_k() if self.conf.backprop_type != "tbptt"
                 else 1)
            if k <= 1:
                if self._fused_steps > 1 and self.conf.backprop_type \
                        != "tbptt":
                    self._count_single("num_iterations")
                with P.follow("train.step"):
                    self._step(next_batch())
                continue
            g = F.group_size(self, k)
            group = []
            with P.span("train.stage", cat="train", tracer=True, k=g):
                while len(group) < g and it.has_next():
                    group.append(next_batch())
            if len(group) == g and F.uniform_group(group):
                self._fit_group(group)
                continue
            self._count_single("ragged_tail" if len(group) < g
                               else "mixed_shapes", len(group))
            for batch in group:
                self._step(batch)

    # ------------------------------------------------------------------
    # The step body, the single step and the fused groups
    # ------------------------------------------------------------------
    def _fused_k(self):
        """The fused depth for the current batch: 1 (the single step)
        unless fused_steps(K > 1) is set, activation stats are disarmed
        and num_iterations == 1."""
        k = self._fused_steps
        if (k <= 1 or self._act_stats_cfg is not None
                or int(self.conf.global_conf.get("num_iterations", 1)) != 1):
            return 1
        return k

    def _count_single(self, why, n=1):
        """Count single steps the fused loop took, by the reference's
        reason (a ragged tail, mixed shapes, num_iterations != 1, the short
        TBPTT tail, the replay after a rollback)."""
        c = self.fused_counts["single_steps"]
        c[why] = c.get(why, 0) + n

    def _lr_leaves(self):
        """(key, layer, param name) of every parameter, in a fixed order:
        the columns of the learning-rate buffers."""
        if self._lr_leaves_cache is None:
            self._lr_leaves_cache = [
                (key, layer, k) for key, layer in self._keyed_layers()
                for k in self._slot(key).params]
        return self._lr_leaves_cache

    def _lr_rows(self, it0, k):
        """The learning rates of iterations it0 .. it0 + k - 1, k rows of P
        floats (the schedules run on the host)."""
        return [[U.layer_lr(layer, name, it)
                 for _, layer, name in self._lr_leaves()]
                for it in range(it0, it0 + k)]

    def _lr_buffer(self, k):
        return torch.empty((k, len(self._lr_leaves())), dtype=self.param_dtype,
                           device=self._device)

    def _fill_lr(self, buf, rows, held):
        """Copy `rows` into the device buffer `buf` unless it holds them
        already (`held`): a constant rate costs no copy and no host tensor
        after the first step. Returns the rows `buf` holds."""
        if rows != held:
            buf.copy_(torch.tensor(rows, dtype=self.param_dtype))
        return rows

    def _lr_views(self, row):
        """{key: {param name: 0-d lr tensor}} over one buffer row."""
        out = {key: {} for key, _ in self._keyed_layers()}
        for j, (key, _, name) in enumerate(self._lr_leaves()):
            out[key][name] = row[j]
        return out

    def _single_lr(self):
        """The single step's learning rates: one row of a device buffer,
        filled by the host when they changed."""
        if self._lr_single is None:
            self._lr_single = self._lr_buffer(1)
        self._lr_single_rows = self._fill_lr(
            self._lr_single, self._lr_rows(int(self.conf.iteration_count), 1),
            self._lr_single_rows)
        return self._lr_views(self._lr_single[0])

    def _step_body(self, loss_fn, lrs, reduce=None, update=None):
        """One optimizer step, as both the single step and each inner step
        of a fused group run it: the loss `loss_fn(rng)` -> (score, new
        layer state, new carries), its gradients for the masters,
        `reduce(grads, score)` when given (a data-parallel all-reduce,
        before the updaters' normalization and clipping; inside
        `_split_over`, the split layers' gradients are this rank's slices
        and their norms are summed over "model"), each layer's normalization,
        the updaters with the learning rates `lrs`, the new layer state.
        `update(key, layer, grads, lr, ok, minimize)`, when given, runs in
        place of the layer's updater on its own parameters (the wrapper's
        split state updates slices). Armed, the health scalars gate the
        update on the device. Touches no host counter and reads nothing on
        the host. Returns (score, new carries, health or None)."""
        with card_numerics(self._device, self.compute_dtype):
            with P.span("train.forward", self._device):
                score, new_state, new_carries = loss_fn(self._dropout_gen)
            with P.span("train.backward", self._device):
                grads = self._grads(score)
            score = score.detach()
            if reduce is not None:
                grads, score = reduce(grads, score)
            sq = None      # split gradients: the whole ones' sums of squares
            if self._column_parallel is not None and (
                    self._health_policy is not None
                    or any(U.reads_norms(layer)
                           for _, layer in self._keyed_layers())):
                sq = self._column_parallel.grad_sq(grads)
            health = ok = None
            if self._health_policy is not None:
                health = H.grad_health(grads, score, sq)
                ok = health["all_finite"]
            minimize = self.conf.global_conf.get("minimize", True)
            with P.span("train.update", self._device):
                for key, layer in self._keyed_layers():
                    g = U.normalize_layer(layer, grads[key],
                                          None if sq is None else sq[key])
                    if update is not None:
                        update(key, layer, g, lrs[key], ok, minimize)
                    else:
                        U.apply_layer(layer, dict(self._slot(key).params), g,
                                      self._updater_state[key], None,
                                      minimize, lr=lrs[key], ok=ok,
                                      inplace=True)
            self._store_state(new_state, ok)
        return score, new_carries, health

    def _finish_armed(self):
        """The armed single step's epilogue: classify its health, act
        (skip, roll back, abort), advance the counter and checkpoint when
        due. Returns the action."""
        with P.span("train.health", cat="train", tracer=True):
            action = H.finish_step(self, H.host_health(self._step_health),
                                   self._step_score)
        if action == H.ROLLBACK:
            return action
        self.conf.iteration_count += 1
        self._fire_iteration_done()
        if action == H.OK:
            with P.span("train.checkpoint", cat="train", tracer=True):
                H.fit_loop_checkpoint(self)
        return action

    def _held(self):
        """The tensors a fused group reads and writes in place: parameters,
        updater state, layer state."""
        out = []
        for key, _ in self._keyed_layers():
            slot = self._slot(key)
            out.extend(slot.params.values())
            out.extend(t for st in self._updater_state[key].values()
                       for t in st.values())
            out.extend(slot.state().values())
        return out

    @contextlib.contextmanager
    def _preserve(self):
        """Put back every state a CUDA graph's warm-up step moves (the
        parameters, updater and layer state, the dropout generator)."""
        held = self._held()
        saved = [t.detach().clone() for t in held]
        rng = self._dropout_gen.get_state()
        try:
            yield
        finally:
            with torch.no_grad():
                for t, s in zip(held, saved):
                    t.copy_(s)
            self._dropout_gen.set_state(rng)

    def _group(self, key, make_static, run):
        """The fused group for `key`: built once (a CUDA graph on the card,
        the body itself on the CPU), captured again if the network now
        holds other tensors than those it was captured on."""
        def build():
            static = make_static()
            if self._device.type != "cuda":
                return _EagerGroup(run, static)
            self.fused_counts["captures"] += 1
            return F.CapturedGroup(run, static, self._held(),
                                   self._dropout_gen, self._preserve)

        grp = F.fused_program(self, key, build)
        if self._device.type == "cuda" and not grp.valid(self._held()):
            grp = self._fused_cache[key] = build()
        return grp

    def _replay(self, grp, values, g):
        """Run one fused group of g steps; returns (scores [g], stacked
        health or None, outputs)."""
        with P.span("train.dispatch", cat="train", tracer=True, k=g):
            out = grp.replay(values)
        self.fused_counts["groups"] += 1
        self.fused_counts["fused_steps"] += g
        if self._device.type == "cuda":
            self.fused_counts["graph_replays"] += 1
        # the graph's outputs are overwritten by its next replay
        return out[0].clone(), out[1], out[2:]

    def _fit_group(self, group):
        """One dispatch for len(group) staged device batches of one
        signature; on a rollback mid-group the remaining batches replay
        single-step from the restored state, as the sequential loop would."""
        g = len(group)
        armed = self._health_policy is not None
        self._last_batch_size = _rows(group[0][0])

        def make_static():
            return {"batch": [F.tree_map(_static_like, group[0])
                              for _ in range(g)],
                    "lr": self._lr_buffer(g)}

        def run(static):
            scores, healths = [], []
            for i in range(g):
                batch = static["batch"][i]
                score, _, health = self._step_body(
                    lambda rng, b=batch: self._loss(*b, True, rng),
                    self._lr_views(static["lr"][i]))
                scores.append(score)
                healths.append(health)
            return (torch.stack(scores),
                    H.stack_health(healths) if armed else None)

        grp = self._group(("batch", g, F.batch_signature(group[0])),
                          make_static, run)
        grp.lr_rows = self._fill_lr(
            grp.static["lr"], self._lr_rows(int(self.conf.iteration_count), g),
            grp.lr_rows)
        values = {"batch": group}
        with P.span("train.fused_group", cat="train", tracer=True, k=g):
            scores, health, _ = self._replay(grp, values, g)
            with P.span("train.health", cat="train", tracer=True, k=g):
                rb = H.finish_fused(self, scores, health, g)
        if rb is not None:
            self._count_single("rollback_replay", g - rb - 1)
            for batch in group[rb + 1:]:
                self._step(batch)

    def _fit_tbptt_group(self, batch, carries, t0, g, L):
        """One dispatch for g full TBPTT segments from t0: the group's
        g * L time steps are copied into the static buffers (so one capture
        serves every t0), the carries threaded from segment to segment.
        Returns (carries, rolled back)."""
        armed = self._health_policy is not None
        span_batch = self._segment(batch, t0, g * L)

        def make_static():
            return {"seq": F.tree_map(_static_like, span_batch),
                    "carries": F.tree_map(_static_like, carries),
                    "lr": self._lr_buffer(g)}

        def run(static):
            c = static["carries"]
            scores, healths = [], []
            for i in range(g):
                seg = self._segment(static["seq"], i * L, L)
                score, new, health = self._step_body(
                    lambda rng, s=seg, c=c: self._loss(*s, True, rng, c),
                    self._lr_views(static["lr"][i]))
                if armed:
                    new = H.gate_update(health["all_finite"], new, c)
                c = _detached(new)
                scores.append(score)
                healths.append(health)
            F.tree_zip(lambda pair: pair[0].copy_(pair[1]),
                       [static["carries"], c])
            return (torch.stack(scores),
                    H.stack_health(healths) if armed else None,
                    static["carries"])

        key = ("tbptt", g, L, F.batch_signature(span_batch),
               F.batch_signature(tuple(_flat_carries(carries))))
        grp = self._group(key, make_static, run)
        grp.lr_rows = self._fill_lr(
            grp.static["lr"], self._lr_rows(int(self.conf.iteration_count), g),
            grp.lr_rows)
        values = {"seq": span_batch, "carries": carries}
        with P.span("train.fused_group", cat="train", tracer=True, k=g,
                    tbptt=True):
            scores, health, (out_carries,) = self._replay(grp, values, g)
            carries = F.tree_map(torch.clone, out_carries)
            with P.span("train.health", cat="train", tracer=True, k=g):
                rb = H.finish_fused(self, scores, health, g)
        return carries, rb is not None

    def _eval_batches(self, data):
        """The batches of `data` (a DataSet, an iterator, or a list of
        batches) for evaluation: an iterator is reset (the full pass) and
        staged onto the device ahead of the forward."""
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        if isinstance(data, DataSetIterator):
            data.reset()
            data = wrap_async_for_fit(data, self.compute_dtype,
                                      device=self._device)
        return data

    def _reg_score(self, masters=None):
        layers = [(key, layer, dict(self._slot(key).params if masters is None
                                    else masters[key]))
                  for key, layer in self._keyed_layers()]
        if self._column_parallel is not None:
            return self._column_parallel.reg_score(layers)
        total = 0.0
        for _, layer, p in layers:
            total = total + layer.reg_score(p)
        return total

    def _grads(self, score, masters=None):
        """{key: {param name: gradient}} of `score` for the masters (or
        for `masters`, the tensors the loss was evaluated on)."""
        if masters is None:
            masters = {key: self._slot(key).params
                       for key, _ in self._keyed_layers()}
        leaves = [(key, k, p) for key, _ in self._keyed_layers()
                  for k, p in masters[key].items()]
        grads = torch.autograd.grad(score, [p for _, _, p in leaves],
                                    allow_unused=True, materialize_grads=True)
        out = {key: {} for key, _ in self._keyed_layers()}
        for (key, k, _), g in zip(leaves, grads):
            out[key][k] = g
        return out

    def _apply_updates(self, params, ustate, grads, iteration):
        """Each layer's updater (gradient normalization, the learning rate
        at `iteration`, the update rule) on `params` in place; returns
        (params, the new updater state)."""
        minimize = self.conf.global_conf.get("minimize", True)
        new_ustate = {}
        for key, layer in self._keyed_layers():
            new_ustate[key] = U.apply_layer(
                layer, dict(params[key]), U.normalize_layer(layer, grads[key]),
                ustate[key], iteration, minimize)
        return params, new_ustate

    def make_grad_fn(self):
        """The gradient half of the step, `(params, state, batch) ->
        (grads, score, new_state, new_carries)`, evaluated on the given
        parameters ({key: {name: tensor}}, f32 masters in the port's
        layout; e.g. a parameter-server snapshot) and layer state (None:
        the network's own). `batch`: a dict of the container's device
        batch (`features`, `labels`, `fmask`, `lmask`), `rng` (the dropout
        torch.Generator) and optional `carries`. Everything returned is
        detached; the network is not touched."""
        self._ensure_init()

        def grad_fn(params, state, batch):
            leaves = {key: {k: p.detach().requires_grad_()
                            for k, p in params[key].items()}
                      for key, _ in self._keyed_layers()}
            with card_numerics(self._device, self.compute_dtype):
                score, new_state, carries = self._loss(
                    batch["features"], batch["labels"], batch.get("fmask"),
                    batch.get("lmask"), True, batch.get("rng"),
                    batch.get("carries"), params=leaves, state=state)
                grads = self._grads(score, leaves)
            new_state = {key: {n: t.detach() for n, t in st.items()}
                         for key, st in new_state.items()}
            return (grads, score.detach(), new_state,
                    None if carries is None else _detached(carries))

        return grad_fn

    def make_apply_fn(self):
        """The updater half of the step, `(params, ustate, grads,
        iteration) -> (params, ustate)`: gradient normalization, the
        learning-rate schedule and each updater, in f32. Unlike the
        reference's pure function it writes `params` in place (and returns
        them); the updater state comes back new."""
        self._ensure_init()
        return self._apply_updates

    def _train_step(self, loss_fn, reduce=None, update=None):
        """One optimizer step on the loss `loss_fn(rng)` -> (score, new
        layer state, new carries), with the learning rates of
        `iteration_count` (`_step_body`, which takes `update`).
        `reduce(grads, score) -> (grads, score)`, when given,
        runs between the gradients and the updaters.
        Disarmed, it records the score and advances `iteration_count`;
        armed (`training_health`), it leaves both to the caller's epilogue
        and keeps the step's score and health in `_step_score` /
        `_step_health`. Returns the new carries."""
        score, new_carries, health = self._step_body(
            loss_fn, self._single_lr(), reduce, update)
        if self._health_policy is None:
            self._score = score
            self.conf.iteration_count += 1
        else:
            self._step_score, self._step_health = score, health
        return new_carries

    @torch.no_grad()
    def _store_state(self, new_state, ok=None):
        """Write the layers' new state into their buffers; where `ok` (a
        0-d bool tensor) is False, keep the old."""
        for key, st in new_state.items():
            slot = self._slot(key)
            for name, v in st.items():
                buf = getattr(slot, name)
                if v is not buf:
                    buf.copy_(v if ok is None else torch.where(ok, v, buf))

    def score(self, data=None, training=False):
        """The score (loss plus L1/L2 terms) of the last fit step, or of
        `data` (as `fit` takes it)."""
        if data is None:
            return (float(self._score) if self._score is not None
                    else float("nan"))
        self._ensure_init()
        batch = self._batch(self._dataset(data))
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            s, *_ = self._loss(*batch, training,
                               self._dropout_gen if training else None)
        return float(s)

    def compute_gradient_and_score(self, features, labels, fmask=None,
                                   lmask=None, train=True):
        """(gradients, score): the gradients as the reference nests its
        parameters (MultiLayerNetwork: a list of per-layer dicts;
        ComputationGraph: keyed by vertex name), in the port's layout
        (`flatten_gradients` gives the reference's flat vector). Dropout
        draws from a generator seeded 0, as the reference uses
        PRNGKey(0)."""
        self._ensure_init()
        batch = self._gradient_batch(features, labels, fmask, lmask)
        with card_numerics(self._device, self.compute_dtype):
            score, *_ = self._loss(
                *batch, train, torch.Generator(self._device).manual_seed(0))
            grads = self._grads(score)
        return self._tree(grads), float(score.detach())

    def make_flat_score_fn(self, features, labels, fmask=None, lmask=None,
                           train=True):
        """`score(flat)`: the loss on this batch as a function of a flat
        parameter vector in the reference's layout and order (`params()`),
        a numpy array or a tensor, cast to the parameter type. The result
        is a 0-d tensor, differentiable through `torch.autograd` back to
        `flat` (the layout moves, e.g. HWIO to OIHW, are autograd ops).
        Every call draws dropout from a fresh generator seeded 0, as the
        reference uses PRNGKey(0), so two calls see the same masks. The
        layers' state is the network's own."""
        self._ensure_init()
        batch = self._gradient_batch(features, labels, fmask, lmask)
        dev = self._device
        leaves = [(key, k, layer, p.dtype, p.numel(),
                   tuple(layer.to_reference(k, p).shape))
                  for key, k, layer, p in self._param_leaves()]

        def score(flat):
            if not isinstance(flat, torch.Tensor):
                flat = torch.from_numpy(np.asarray(flat))
            flat = flat.to(dev).reshape(-1)
            tree = {key: {} for key, _ in self._keyed_layers()}
            offset = 0
            for key, k, layer, dtype, n, shape in leaves:
                chunk = flat[offset:offset + n].reshape(shape).to(dtype)
                tree[key][k] = layer.from_reference(k, chunk)
                offset += n
            if offset != flat.numel():
                raise ValueError(f"Expected {offset} params, got "
                                 f"{flat.numel()}")
            with card_numerics(dev, self.compute_dtype):
                s, *_ = self._loss(*batch, train,
                                   torch.Generator(dev).manual_seed(0),
                                   params=tree)
            return s

        return score

    # ------------------------------------------------------------------
    # Flat parameters, in the reference's layout and order
    # ------------------------------------------------------------------
    def _param_leaves(self):
        leaves = []
        for key, layer in self._keyed_layers():
            p = self._slot(key).params
            for k in sorted(p.keys(), key=_param_sort_key):
                leaves.append((key, k, layer, p[k]))
        return leaves

    def params(self):
        """The flat parameter vector (f32, or f64 for float64 networks), as
        the reference's `params()`."""
        self._ensure_init()
        vecs = [layer.to_reference(k, p.detach()).cpu().reshape(-1)
                for _, k, layer, p in self._param_leaves()]
        if not vecs:
            return np.zeros((0,), np.float32)
        return torch.cat(vecs).numpy()

    @torch.no_grad()
    def set_params(self, flat):
        """Load a flat vector in the reference's layout and order."""
        self._ensure_init()
        flat = torch.tensor(np.asarray(flat).ravel())
        offset = 0
        for _, k, layer, p in self._param_leaves():
            ref_shape = layer.to_reference(k, p).shape
            n = p.numel()
            if offset + n > flat.numel():
                raise ValueError(f"Expected {self.num_params()} params, "
                                 f"got {flat.numel()}")
            chunk = flat[offset:offset + n].reshape(ref_shape)
            p.copy_(layer.from_reference(k, chunk))
            offset += n
        if offset != flat.numel():
            raise ValueError(f"Expected {offset} params, got {flat.numel()}")

    def num_params(self):
        self._ensure_init()
        return int(sum(p.numel() for *_, p in self._param_leaves()))

    def flatten_gradients(self, grads):
        """A gradient tree (`compute_gradient_and_score`) as one float64
        vector in the flat-parameter layout and order."""
        grads = self._untree(grads)
        vecs = [layer.to_reference(k, grads[key][k].detach()).double().cpu()
                .reshape(-1) for key, k, layer, _ in self._param_leaves()]
        return torch.cat(vecs).numpy() if vecs else np.zeros((0,))

    # ------------------------------------------------------------------
    # The reference's per-layer trees (weight bridge and model zips)
    # ------------------------------------------------------------------
    def reference_params(self):
        """The parameters as the reference nests them (per layer: name ->
        numpy array), in its layout: what `from_jax_params` takes."""
        self._ensure_init()
        return self._tree({key: {k: _to_numpy(layer.to_reference(k, p))
                                 for k, p in self._slot(key).params.items()}
                           for key, layer in self._keyed_layers()})

    def reference_updater_state(self):
        """The updater state as the reference nests it (per layer: param
        name -> state name -> numpy array), in its layout."""
        self._ensure_init()
        out = {}
        for key, layer in self._keyed_layers():
            out[key] = {k: {s: _to_numpy(layer.to_reference(k, t)
                                         if t.ndim else t)
                            for s, t in st.items()}
                        for k, st in self._updater_state[key].items()}
        return self._tree(out)

    def reference_model_state(self):
        """The layers' state (BatchNorm's running mean and var) as the
        reference nests it."""
        self._ensure_init()
        return self._tree({key: {n: _to_numpy(b) for n, b in
                                 self._slot(key).state().items()}
                           for key, _ in self._keyed_layers()})

    @torch.no_grad()
    def load_reference_updater_state(self, tree):
        self._ensure_init()
        tree = self._untree(tree)
        for key, layer in self._keyed_layers():
            for k, st in self._updater_state[key].items():
                for s, t in st.items():
                    a = torch.tensor(np.asarray(tree[key][k][s]))
                    if t.ndim:
                        a = layer.from_reference(k, a)
                    st[s] = a.to(device=t.device, dtype=t.dtype).contiguous(
                        memory_format=_memory_format(t))

    @torch.no_grad()
    def load_reference_model_state(self, tree):
        self._ensure_init()
        tree = self._untree(tree)
        for key, _ in self._keyed_layers():
            for n, b in self._slot(key).state().items():
                b.copy_(torch.tensor(np.asarray(tree[key][n])))

    @torch.no_grad()
    def from_jax_params(self, params, model_state=None, updater_state=None):
        """The weight bridge: load the reference's per-layer trees (its
        `_params`, `_model_state` and `_updater_state`, as numpy arrays:
        a list per layer for MultiLayerNetwork, a name-keyed dict for
        ComputationGraph). Every layout move happens here: HWIO kernels
        become OIHW; dense weights after a CNN-to-dense preprocessor keep
        their (h, w, c) row order, which the port's NHWC-order flatten
        reads as it is. Returns self."""
        self._ensure_init()
        params = self._untree(params)
        for key, layer in self._keyed_layers():
            for k, p in self._slot(key).params.items():
                a = torch.tensor(np.asarray(params[key][k]))
                p.copy_(layer.from_reference(k, a))
        if model_state is not None:
            self.load_reference_model_state(model_state)
        if updater_state is not None:
            self.load_reference_updater_state(updater_state)
        return self

    # ------------------------------------------------------------------
    def clone(self):
        net = type(self)(self.conf.clone(), device=self._device)
        if self.slots is not None:
            net.init()
            net.load_state_dict(self.state_dict())
            net._updater_state = {
                key: {k: {s: t.clone() for s, t in st.items()}
                      for k, st in per.items()}
                for key, per in self._updater_state.items()}
        return net

    def rnn_clear_previous_state(self):
        """Forget the state `rnn_time_step` carries between calls."""
        self._rnn_state = None

    rnnClearPreviousState = rnn_clear_previous_state

    def training_health(self, policy=True, checkpoint_dir=None,
                        checkpoint_every=10, keep_checkpoints=3):
        """Arm the training-health watchdog: every step also computes its
        gradient norms and an all-finite flag on the device and applies its
        update only when they are finite; the fit loop classifies each step
        through the policy (NaN/Inf skip, EMA z-score loss spike,
        gradient-norm explosion) and responds: count and skip, roll back to
        the newest checkpoint (with `checkpoint_dir`, a
        ShardedCheckpointManager saving every `checkpoint_every` healthy
        steps), or abort after N consecutive bad steps naming the offending
        rounds. policy=True takes TrainingHealthPolicy's defaults;
        None/False disarms. Returns self."""
        H.install(self, policy, checkpoint_dir, checkpoint_every,
                  keep_checkpoints)
        return self

    def fused_steps(self, k=8):
        """Take K optimizer steps a dispatch: the fit loops stage K batches
        and run them as one group, one CUDA graph replay on the card (K
        full TBPTT segments of a sequence, the carries threaded through).
        Bit-identical to K single steps; a ragged tail, mixed batch shapes
        and num_iterations != 1 run single-step; a health checkpoint seam
        clips groups at its boundaries. Returns self."""
        return F.install(self, k)

    def set_listeners(self, *listeners):
        """Replace the iteration listeners (`optimize.listeners`). Returns
        self."""
        self.listeners = list(listeners)
        return self

    setListeners = set_listeners


def _rows(features):
    """The batch size of a device batch's features (a tensor, or a dict of
    the graph's inputs)."""
    if isinstance(features, dict):
        features = next(iter(features.values()))
    return int(features.shape[0])


def _detached(carries):
    """Carries (key -> name -> tensor) cut from the autograd graph."""
    return {key: {n: t.detach() for n, t in c.items()}
            for key, c in carries.items()}


def _flat_carries(carries):
    return [t for c in carries.values() for t in c.values()]


def _static_like(t):
    """A static buffer for `t` in a fused group: its shape and dtype, dense,
    channels_last when `t` is (the layout picks cuDNN's algorithms, so the
    group sees the single step's)."""
    if t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last) \
            and not t.is_contiguous():
        return torch.empty_like(t, memory_format=torch.channels_last)
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


class _EagerGroup:
    """A fused group off the card: the same static buffers and body as a
    captured one, the body run directly."""

    def __init__(self, run, static):
        self.run, self.static = run, static
        self.lr_rows = None      # the rates static["lr"] holds

    def valid(self, held):
        return True

    def replay(self, values):
        for name, v in values.items():
            F.tree_zip(lambda pair: pair[0].copy_(pair[1]),
                       [self.static[name], v])
        return self.run(self.static)


def _to_numpy(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _host(a):
    """A label or mask array of a (possibly staged) batch as numpy."""
    return _to_numpy(a) if isinstance(a, torch.Tensor) else a


def _memory_format(t):
    if t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


@torch.no_grad()
def _act_moments(acts, max_channels, max_size):
    """(moments, grids) of a training forward's interior activations:
    moments [L, 4] f64 on the device, per layer the sum of x, of x^2, of
    |x| and the element count: per-example partials in f32 (f64 for an
    f64 layer; a bf16 output is read as it is, never copied), summed in
    f64; grids {layer: [h, w, ch] f32}, for each 4-D (NCHW) output the first example, permuted to the reference's NHWC,
    every step-th row and column, the first max_channels channels."""
    rows, grids, f64 = [], {}, torch.float64
    for i, a in enumerate(acts):
        a = a.detach()
        acc = f64 if a.dtype == f64 else torch.float32
        dims = tuple(range(1, a.ndim))
        parts = torch.stack([
            a.sum(dims, dtype=acc),
            torch.linalg.vector_norm(a, 2, dims, dtype=acc).square(),
            torch.linalg.vector_norm(a, 1, dims, dtype=acc)])
        rows.append(torch.cat([parts.to(f64).sum(1), torch.full(
            (1,), a.numel(), dtype=f64, device=a.device)]))
        if a.ndim == 4:
            g = a[0].permute(1, 2, 0)
            step = max(1, max(g.shape[0], g.shape[1]) // max_size)
            grids[i] = g[::step, ::step, :max_channels].float().clone()
    return torch.stack(rows), grids


@torch.no_grad()
def _act_summaries(moments, grids):
    """The per-layer summaries of `_act_moments`' moments: {"mean",
    "stdev", "meanMagnitude"} as 0-d f32 tensors on the device (the
    population stdev, as jnp.std), and "grid" for a 4-D output."""
    total, squares, absolute, n = moments.unbind(1)
    mean = total / n
    stdev = (squares / n - mean * mean).clamp_min(0).sqrt()
    stats = torch.stack([mean, stdev, absolute / n], 1).float()
    out = []
    for i in range(stats.shape[0]):
        s = {"mean": stats[i, 0], "stdev": stats[i, 1],
             "meanMagnitude": stats[i, 2]}
        if i in grids:
            s["grid"] = grids[i]
        out.append(s)
    return out


class MultiLayerNetwork(Network):
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__(conf, device)
        self.layers = conf.layers

    def _keyed_layers(self):
        return list(enumerate(self.layers))

    def _tree(self, by_key):
        return [by_key[i] for i in range(len(self.layers))]

    def _untree(self, tree):
        return dict(enumerate(tree))

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _apply_layers(self, params, state, x, *, train, rng, fmask=None,
                      upto=None, carries=None):
        """Forward through layers [0, upto) -> (activations, new state,
        new carries). With `carries` (index -> carry), each recurrent layer
        starts from its carry; without, from zero, and new carries is
        None."""
        n = len(self.layers) if upto is None else upto
        acts = []
        new_state = dict(state)
        new_carries = dict(carries) if carries is not None else None
        for i in range(n):
            layer = self.layers[i]
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i].pre_process(x)
            if isinstance(layer, BaseRecurrentLayer) and carries is not None:
                x, new_carries[i] = layer.forward_with_carry(
                    params[i], x, carries[i], train=train, rng=rng,
                    mask=fmask)
            elif layer.has_state():
                x, new_state[i] = self._layer_forward(
                    i, layer, params[i], x, train=train, rng=rng, mask=fmask,
                    state=state[i])
            else:
                x = self._layer_forward(i, layer, params[i], x, train=train,
                                        rng=rng, mask=fmask)
            acts.append(x)
        return acts, new_state, new_carries

    def _input(self, x):
        x = to_port(x, self._device)
        return x.to(self.compute_dtype) if x.is_floating_point() else x

    def _output_layer_input(self, params, state, x, *, train, rng,
                            fmask=None, carries=None):
        """(h, new state, new carries, acts): the output layer's input
        after its preprocessor, and the interior activations."""
        i = len(self.layers) - 1
        acts, new_state, new_carries = self._apply_layers(
            params, state, x, train=train, rng=rng, fmask=fmask, upto=i,
            carries=carries)
        h = acts[-1] if acts else x
        if i in self.conf.preprocessors:
            h = self.conf.preprocessors[i].pre_process(h)
        return h, new_state, new_carries, acts

    def _loss(self, features, labels, fmask, lmask, train, rng,
              carries=None, params=None, state=None):
        """(score, new layer state, new carries), on the network's masters
        and layer state, or on `params` (masters, {key: {name: tensor}})
        and `state` in their place."""
        cast = self._cast_params(params)
        h, new_state, new_carries, acts = self._output_layer_input(
            cast, self._states() if state is None else state, features,
            train=train, rng=rng, fmask=fmask, carries=carries)
        if self._act_sink is not None:
            self._act_sink.append(_act_moments(acts, *self._act_stats_cfg))
        i = len(self.layers) - 1
        per_ex = self._layer_score(i, self.layers[i], cast[i], h, labels,
                                   train=train, rng=rng, mask=lmask)
        return (mean_score(per_ex) + self._reg_score(params), new_state,
                new_carries)

    def _time_steps(self, batch):
        return int(batch[0].shape[1]), int(batch[0].shape[0])

    def _segment(self, batch, t0, length):
        features, labels, fmask, lmask = batch
        cut = slice(t0, t0 + length)
        return (features[:, cut],
                labels[:, cut] if labels.ndim >= 3 else labels,
                None if fmask is None else fmask[:, cut],
                None if lmask is None else lmask[:, cut])

    def _batch(self, ds):
        dev = self._device
        return (self._input(ds.features), to_port(ds.labels, dev),
                None if ds.features_mask is None
                else to_port(ds.features_mask, dev),
                None if ds.labels_mask is None
                else to_port(ds.labels_mask, dev))

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, features_mask=None, labels_mask=None,
            num_epochs=1):
        """Train on one DataSet (or arrays `data`, `labels`, or a tuple of
        them), num_epochs steps of it; or on a DataSetIterator, num_epochs
        passes over it."""
        self._ensure_init()
        if labels is not None:
            data = DataSet(data, labels, features_mask, labels_mask)
        if isinstance(data, DataSetIterator):
            return self._fit_iterator(data, num_epochs)
        batch = self._batch(self._dataset(data))
        for _ in range(num_epochs):
            self._step(batch)
        return self

    @staticmethod
    def _dataset(data):
        """A DataSet (or a tuple of its arrays) as a DataSet."""
        if isinstance(data, tuple):
            data = DataSet(*data)
        if not isinstance(data, DataSet):
            raise TypeError(f"Cannot fit on {type(data)}")
        return data

    # ------------------------------------------------------------------
    # Layerwise pretraining: greedy unsupervised training of each
    # pretrainable layer (AutoEncoder, RBM, VariationalAutoencoder) on the
    # activations of the frozen layers below it. `fit` never calls it.
    # ------------------------------------------------------------------
    def pretrain(self, data, num_epochs=1):
        """`pretrain_layer` for each pretrainable layer, in order."""
        self._ensure_init()
        for i, layer in enumerate(self.layers):
            if _pretrainable(layer):
                self.pretrain_layer(i, data, num_epochs)
        return self

    def pretrain_layer(self, i, data, num_epochs=1):
        """Train layer `i` alone, num_epochs passes over `data` (a DataSet
        or a DataSetIterator), one step a batch: the layers below run
        frozen (train=False), then the layer's preprocessor; the gradients
        are the layer's own CD statistics (`pretrain_grads`) where it has
        them, else autograd of `pretrain_loss`; the update is the raw
        updater rule at the layer's learning rate (0.1 when unset), p -= u,
        with no L1/L2, schedule or gradient normalization, and an updater
        state that lives for this call only. The layer's random draws come
        from the network's generator, once a batch. `score()` is then the
        last batch's loss."""
        self._ensure_init()
        layer = self.layers[i]
        if not _pretrainable(layer):
            raise ValueError(f"Layer {i} ({type(layer).__name__}) is not "
                             "pretrainable")
        init_fn, apply_fn = U.get(layer.updater or "sgd")
        hp, lr = layer.updater_hp(), layer.learning_rate or 0.1
        masters = self._slot(i).params
        ustate = {k: init_fn(p.detach()) for k, p in masters.items()}
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        for _ in range(num_epochs):
            data.reset()
            while data.has_next():
                ds = next_processed(data)
                with card_numerics(self._device, self.compute_dtype):
                    self._score = self._pretrain_step(
                        i, self._input(ds.features), ustate, apply_fn, lr,
                        hp)
        return self

    pretrainLayer = pretrain_layer

    def _pretrain_step(self, i, x, ustate, apply_fn, lr, hp):
        """One pretraining step of layer `i` on the batch `x`; updates the
        layer's masters and `ustate` in place, returns the loss."""
        layer = self.layers[i]
        with torch.no_grad():
            acts, _, _ = self._apply_layers(self._cast_params(),
                                            self._states(), x, train=False,
                                            rng=None, upto=i)
            h = acts[-1] if acts else x
            if i in self.conf.preprocessors:
                h = self.conf.preprocessors[i].pre_process(h)
        draws = layer.pretrain_draws(h, self._dropout_gen)
        masters = self._slot(i).params
        cast = {k: p.detach().to(self.compute_dtype).requires_grad_()
                for k, p in masters.items()}
        if hasattr(layer, "pretrain_grads"):
            with torch.no_grad():
                grads = layer.pretrain_grads(cast, h, draws=draws)
                loss = layer.pretrain_loss(cast, h, draws=draws)
        else:
            loss = layer.pretrain_loss(cast, h, draws=draws)
            grads = dict(zip(cast, torch.autograd.grad(
                loss, list(cast.values()), allow_unused=True,
                materialize_grads=True)))
        with torch.no_grad():
            for k, p in masters.items():
                upd, ustate[k] = apply_fn(ustate[k], grads[k].to(p.dtype),
                                          lr, hp)
                p.sub_(upd)
        return loss.detach()

    def collect_activation_stats(self, enabled=True, max_channels=8,
                                 max_size=48):
        """Make the training step also summarise the activations of its
        own forward (reference BaseStatsListener.java:273-420 /
        ConvolutionalIterationListener: the live batch, no extra probe
        forward): each step of `fit` (the single step, each TBPTT segment,
        a ParallelWrapper all-reduce round) leaves per-layer summaries in
        `_last_activation_stats` (`_last_activation_stats_iter` its
        iteration) for `ui.stats.StatsListener`. Fused groups run as single
        steps while armed. Toggling bumps `_act_stats_gen`; disarming
        drops the last summaries. Returns self."""
        cfg = (int(max_channels), int(max_size)) if enabled else None
        if cfg != self._act_stats_cfg:
            self._act_stats_cfg = cfg
            self._act_stats_gen += 1
            if not enabled:
                self._last_activation_stats = None
        return self

    def add_listener(self, listener):
        """Append one iteration listener. Returns self."""
        self.listeners.append(listener)
        return self

    def get_layer(self, i):
        """Layer `i`'s configuration."""
        return self.layers[i]

    @property
    def n_layers(self):
        return len(self.layers)

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    def _forward_out(self, params, state, x, *, train, rng, fmask=None):
        h, _, _, _ = self._output_layer_input(params, state, x, train=train,
                                              rng=rng, fmask=fmask)
        return self._head(params, state, h, train=train, rng=rng)

    def _head(self, params, state, h, *, train, rng):
        """The output layer's activations for its input `h`."""
        i = len(self.layers) - 1
        layer = self.layers[i]
        if layer.has_state():
            return self._layer_forward(i, layer, params[i], h, train=train,
                                       rng=rng, state=state[i])[0]
        return self._layer_forward(i, layer, params[i], h, train=train,
                                   rng=rng)

    def predict(self, x):
        """The class index of each example: the argmax over the last axis
        of `output(x)`, as a numpy int array."""
        return np.asarray(self.output(x)).argmax(axis=-1)

    def output(self, x, train=False, features_mask=None):
        """The output layer's activations for `x`, as numpy."""
        self._ensure_init()
        with P.follow("infer.forward", self._device):
            x = self._input(x)
            fmask = (None if features_mask is None
                     else to_port(features_mask, self._device))
            with torch.no_grad(), card_numerics(self._device,
                                                self.compute_dtype):
                out = self._forward_out(
                    self._cast_params(), self._states(), x, train=train,
                    fmask=fmask, rng=self._dropout_gen if train else None)
        with P.span("infer.to_host"):
            return to_public(out)

    def rnn_time_step(self, x):
        """Streaming inference: x [B, F] is one time step, [B, T, F] a
        run of them; returns the output with the same time rank, as numpy.
        Each recurrent layer starts from the state the previous call left
        (zero after `rnn_clear_previous_state`) and keeps its new one."""
        self._ensure_init()
        x = self._input(x)
        single = x.ndim == 2
        if single:
            x = x[:, None, :]
        if self._rnn_state is None:
            self._rnn_state = self._init_carries(int(x.shape[0]))
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            params, state = self._cast_params(), self._states()
            h, _, self._rnn_state, _ = self._output_layer_input(
                params, state, x, train=False, rng=None,
                carries=self._rnn_state)
            out = self._head(params, state, h, train=False, rng=None)
        return to_public(out[:, 0] if single else out)

    rnnTimeStep = rnn_time_step

    def make_inference_fn(self):
        """The pure inference step `(params, state, x) -> out` that
        `serving.InferenceServer` runs per padding bucket: `params` in the
        compute type (the server casts the masters once, at build and at
        each swap), `state` the layers' state, `x` a batch in the public
        layout (numpy or a tensor); the output stays on the device.
        train=False, so no randomness reaches the math: two calls with the
        same arguments give the same bits on a deterministic backend.
        Params are arguments, so a hot swap is a new argument."""
        self._ensure_init()

        def infer(params, state, x):
            with torch.no_grad(), card_numerics(self._device,
                                                self.compute_dtype):
                return self._forward_out(params, state, self._input(x),
                                         train=False, rng=None)

        return infer

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    def evaluate(self, data, meta=None):
        """Classification statistics (`eval.Evaluation`) over a DataSet or
        an iterator (reset first, staged through AsyncDataSetIterator).
        `meta`: optional per-example metadata over all examples in
        iteration order (or each batch's `example_metas`), for
        Evaluation's error-analysis queries."""
        from ..eval.evaluation import Evaluation
        ev = Evaluation()
        pos = 0
        with P.follow("eval.run"):
            for ds in self._eval_batches(data):
                with P.follow("eval.batch"):
                    out = self.output(ds.features,
                                      features_mask=ds.features_mask)
                    batch_meta = getattr(ds, "example_metas", None)
                    if batch_meta is None and meta is not None:
                        batch_meta = meta[pos:pos + ds.num_examples()]
                    pos += ds.num_examples()
                    with P.span("eval.score"):
                        ev.eval(_host(ds.labels), out,
                                mask=_host(ds.labels_mask), meta=batch_meta)
        return ev

    def evaluate_regression(self, data):
        """Regression statistics (`eval.RegressionEvaluation`), as
        `evaluate`."""
        from ..eval.regression import RegressionEvaluation
        ev = None
        for ds in self._eval_batches(data):
            out = self.output(ds.features, features_mask=ds.features_mask)
            if ev is None:
                ev = RegressionEvaluation(int(ds.labels.shape[-1]))
            ev.eval(_host(ds.labels), out)
        return ev

    def feed_forward(self, x, train=False):
        """The input, then every layer's activations, as numpy."""
        self._ensure_init()
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            acts, _, _ = self._apply_layers(
                self._cast_params(), self._states(), self._input(x),
                train=train, rng=self._dropout_gen if train else None)
        return [np.asarray(x)] + [to_public(a) for a in acts]

    def _gradient_batch(self, features, labels, fmask, lmask):
        return self._batch(DataSet(features, labels, fmask, lmask))
