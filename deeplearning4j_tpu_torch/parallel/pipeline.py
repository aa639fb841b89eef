"""Pipeline parallelism (GPipe) over a "pipe" mesh axis: port of
deeplearning4j_tpu/parallel/pipeline.py.

The reference expresses the schedule as one `shard_map` program over the
mesh. Here each pipe position is a rank of a process group, holding only
its own stage (sliced over "model" when `param_specs` says so), and every
rank runs the same schedule:

- T = M + S - 1 ticks. Stage 0 takes in microbatch t while t < M; every
  stage computes on every tick, bubbles included (a bubble's result never
  reaches an output); the last stage writes output t - (S - 1); then the
  activations move one rank on (`ring_attention._PPermute`, one rotation a
  tick). So a stage runs M + S - 1 times per rank and pass.
- The backward is autograd's: the rotation's gradient is the reverse
  rotation. Every selection is a `torch.where` with a tensor condition, so
  every rank's graph has the same shape and runs its collectives' backward
  in the same order.
- The last stage's outputs reach every pipe rank through a masked
  all-reduce (`sharding.reduce_from`, identity backward), and the
  embedding's output enters through `sharding.copy_to` (its gradient,
  which only stage 0 takes in, summed over "pipe"): the embedding, the
  head and the loss run replicated on every pipe rank, each with the true
  gradient.
- With a "data" axis each data rank takes its columns of every microbatch
  and the gradients are averaged over "data", as the reference's batch
  mean does.

Stage parameters are modules (a transformer `Block`) or nested dicts of
tensors (held as `ParamDict`, which reads both p["W"] and p.W).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from .sharding import (all_gather, all_reduce_mean, copy_to, named_mesh,
                       reduce_from)


class ParamDict(nn.Module):
    """A nested dict of tensors as a module: p["W"] and p.W alike."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                setattr(self, k, ParamDict(v))
            else:
                setattr(self, k, nn.Parameter(torch.as_tensor(v)))

    def __getitem__(self, name):
        return getattr(self, name)


def as_module(p):
    return p if isinstance(p, nn.Module) else ParamDict(p)


def make_pipeline_mesh(n_pipe, n_data=1, n_model=1, group=None, device=None):
    """A ("data", "pipe") mesh, or ("data", "model", "pipe") with n_model >
    1; "pipe" varies fastest, so a stage's neighbours are adjacent
    ranks."""
    if int(n_model) > 1:
        return named_mesh(("data", "model", "pipe"),
                          (n_data, n_model, n_pipe), group, device)
    return named_mesh(("data", "pipe"), (n_data, n_pipe), group, device)


def _named(p):
    return dict(as_module(p).named_parameters())


def stack_stage_params(params_list):
    """{dotted name: [S, ...] stacked tensor} of S stages of one
    structure."""
    named = [_named(p) for p in params_list]
    return {k: torch.stack([n[k].detach() for n in named]) for k in named[0]}


def unstack_stage_params(stacked, n_stages):
    return [{k: a[i] for k, a in stacked.items()} for i in range(n_stages)]


def _slice_stage(stage, specs, mesh, axis):
    """A copy of `stage` holding this rank's slice of each parameter along
    every non-`axis` mesh axis its spec names (the spec's dimension 0 is
    the stacked stage axis)."""
    stage = copy.deepcopy(as_module(stage))
    if specs is None:
        return stage
    for name, p in stage.named_parameters():
        t = p.detach()
        for dim, ax in enumerate(tuple(specs.get(name, ()))[1:]):
            if ax is None or ax == axis:
                continue
            n = mesh.axis_size(ax)
            c = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(ax) * c, c)
        p.data = t.contiguous().clone()
    return stage


def gpipe(stage_fn, mesh, axis="pipe"):
    """pipelined(stage, xs) -> ys: this rank's stage parameters (sliced
    over "model" by the caller where they split) and this data rank's
    microbatched input xs [M, B, ...] (the whole of it on every pipe rank);
    ys has xs's shape, on every pipe rank equal to running the S stages
    in order on every microbatch. Differentiable. The reference's
    `data_axis` and `param_specs` are the caller's business here: a data
    rank passes its own columns, and `PipelineParallel` slices the stage."""
    S = mesh.axis_size(axis)
    group = mesh.axis_group(axis)
    idx = mesh.index(axis)

    def pipelined(stage, xs):
        from .ring_attention import _PPermute
        M = xs.shape[0]
        dev = xs.device
        flag = lambda v: torch.tensor(bool(v), device=dev)
        xs = copy_to(xs, group)
        state = torch.zeros_like(xs[0])
        outputs = [torch.zeros_like(xs[0]) for _ in range(M)]
        for t in range(M + S - 1):
            state = torch.where(flag(idx == 0 and t < M), xs[min(t, M - 1)],
                                state)
            y = stage_fn(stage, state)
            o = t - (S - 1)
            oi = min(max(o, 0), M - 1)
            outputs[oi] = torch.where(flag(idx == S - 1 and o >= 0),
                                      y.to(xs.dtype), outputs[oi])
            state = _PPermute.apply(group, y)[0] if S > 1 else y
        out = torch.stack(outputs) * float(idx == S - 1)
        return reduce_from(out, group)

    return pipelined


@torch.no_grad()
def sgd_momentum_update(params, vel, grads, lr, mu):
    """SGD with momentum over matching sequences of tensors: v <- mu*v + g;
    p <- p - lr*v. Updates `params` and `vel` in place (JAX returns new
    ones) and returns them.

    Each update is computed in at least f32 and rounded once to the
    tensor's dtype, as XLA's fused elementwise rounds a bf16 update once.
    Two in-place bf16 ops in a row would round twice, and `torch.add` on
    bf16 tensors rounds `alpha` itself to bf16 (0.9 -> 0.8984375)."""
    for p, v, g in zip(params, vel, grads, strict=True):
        wide = torch.promote_types(p.dtype, torch.float32)
        v.copy_(torch.add(g.to(wide), v.to(wide), alpha=mu))
        p.copy_(torch.sub(p.to(wide), v.to(wide), alpha=lr))
    return params, vel


def microbatch(x, n_micro):
    """[B_total, ...] -> [M, B_total/M, ...]."""
    B = x.shape[0]
    if B % n_micro != 0:
        raise ValueError(f"batch {B} not divisible by {n_micro} "
                         f"microbatches")
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


class PipelineParallel:
    """The trainer of a pipelined stack of uniform stages, on every
    rank of `mesh`:

      pre_fn(aux, x_micro) -> activations [B, ...]  (e.g. token embedding)
      stage_fn(stage, h)   -> h                     (uniform interface)
      loss_fn(aux, out[B*, ...], labels[B*, ...]) -> scalar mean loss

    `stage_params` lists all S stages (every rank gets the same list, as
    the reference gets the full arrays); each rank keeps its own, sliced
    over "model" by `param_specs` (`tp_block_specs`). `aux_params` (a
    module or dict) runs replicated. Updates are SGD with momentum on this
    rank's stage and on aux, so the stage's optimizer state is sharded over
    "pipe" for free."""

    def __init__(self, stage_fn, stage_params, mesh, *, loss_fn,
                 aux_params=None, pre_fn=None, n_micro, axis="pipe",
                 data_axis=None, learning_rate=0.1, momentum=0.0,
                 param_specs=None):
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        self.n_micro = int(n_micro)
        self.S = mesh.axis_size(axis)
        if len(stage_params) != self.S:
            raise ValueError(f"{len(stage_params)} stages != mesh "
                             f"{axis}={self.S}")
        self.param_specs = param_specs
        self.stage = _slice_stage(stage_params[mesh.index(axis)],
                                  param_specs, mesh, axis)
        self.aux = (None if aux_params is None
                    else copy.deepcopy(as_module(aux_params)))
        self._pipe = gpipe(stage_fn, mesh, axis=axis)
        self.pre_fn = pre_fn
        self.loss_fn = loss_fn
        self.lr = float(learning_rate)
        self.mu = float(momentum)
        self._vel = None

    @property
    def device(self):
        return next(self.stage.parameters()).device

    def _params(self):
        return (list(self.stage.parameters())
                + ([] if self.aux is None else list(self.aux.parameters())))

    # -- functional pieces ------------------------------------------------
    def _embed(self, xs):
        if self.pre_fn is None:
            return xs
        return torch.stack([self.pre_fn(self.aux, xs[i])
                            for i in range(xs.shape[0])])

    def _loss(self, xs, ys):
        out = self._pipe(self.stage, self._embed(xs))
        flat_o = out.reshape((-1,) + tuple(out.shape[2:]))
        flat_y = ys.reshape((-1,) + tuple(ys.shape[2:]))
        return self.loss_fn(self.aux, flat_o, flat_y)

    def _put_micro(self, a):
        """A global batch as this data rank's microbatches [M, B_local,
        ...] on the stage's device (integers as int64)."""
        a = microbatch(np.asarray(a), self.n_micro)
        if self.data_axis is not None:
            n = self.mesh.axis_size(self.data_axis)
            if a.shape[1] % n:
                raise ValueError(f"microbatches of {a.shape[1]} rows do not "
                                 f"divide over {n} data ranks")
            c = a.shape[1] // n
            i = self.mesh.index(self.data_axis)
            a = a[:, i * c:(i + 1) * c]
        t = torch.as_tensor(np.ascontiguousarray(a))
        if not t.is_floating_point():
            t = t.long()
        return t.to(self.device)

    def _gather_data(self, out):
        if self.data_axis is None:
            return out
        return all_gather(out, self.mesh.axis_group(self.data_axis), dim=1)

    @torch.inference_mode()
    def forward(self, x):
        """Full-batch forward through the pipeline (inference): the
        pipeline-output activations of the whole global batch, on every
        rank (apply your own head for logits)."""
        out = self._gather_data(self._pipe(self.stage,
                                           self._embed(self._put_micro(x))))
        return out.reshape((-1,) + tuple(out.shape[2:]))

    def _step(self, xs, ys):
        params = self._params()
        if self._vel is None:
            self._vel = [torch.zeros_like(p) for p in params]
        loss = self._loss(xs, ys)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        loss = loss.detach()
        if self.data_axis is not None:
            *grads, loss = all_reduce_mean(list(grads) + [loss.reshape(1)],
                                           self.mesh, self.data_axis)
        sgd_momentum_update(params, self._vel, grads, self.lr, self.mu)
        return loss.reshape(())

    def fit_batch(self, x, y):
        """One optimization step over a global batch; returns the loss
        (before the step, the mean over the global batch)."""
        return float(self._step(self._put_micro(x), self._put_micro(y)))

    def lower_step(self, x, y):
        """The mesh-cost hook: one step run under `mesh_cost`'s recorder on
        this pipeline's own tensors, then every parameter and velocity put
        back bit for bit. Returns a `mesh_cost.Lowered`."""
        from .mesh_cost import run_recorded
        xs, ys = self._put_micro(x), self._put_micro(y)
        fresh = self._vel is None
        lowered = run_recorded(lambda: self._step(xs, ys),
                               self._params() + (self._vel or []),
                               self.device)
        if fresh:
            self._vel = None
        return lowered

    @torch.no_grad()
    def stage_params(self):
        """Every stage's parameters ({dotted name: tensor}, whole over
        "model"), on every rank (the reference's unstack)."""
        local = {}
        for name, p in self.stage.named_parameters():
            t = p.detach()
            spec = tuple((self.param_specs or {}).get(name, ()))[1:]
            for dim, ax in enumerate(spec):
                if ax is not None and ax != self.axis:
                    t = all_gather(t, self.mesh.axis_group(ax), dim)
            local[name] = t
        group = self.mesh.axis_group(self.axis)
        stacked = {k: all_gather(t[None], group, 0) for k, t in local.items()}
        return unstack_stage_params(stacked, self.S)
