"""deeplearning4j_tpu/parallel/sharding.py over `torch.distributed` process
groups: the mesh, the tensor-parallel layout rules, the ZeRO-style updater
state layout, and the collectives every parallel mode of the port runs.

The reference partitions one jitted program over a named device mesh and
lets XLA insert the collectives. The torch idiom is SPMD over processes:
each mesh position is a rank of a process group, every rank runs the same
program on its own shard, and the collectives are explicit. So here a mesh
is a process group, a tuple of named axes, and this rank's place in it:

  * `Mesh(group, axes, sizes, rank, device)`: rank r sits at
    `numpy.unravel_index(r, sizes)`, the reference's device order (the
    last axis varies fastest). `axis_group(axis)` is this rank's subgroup
    along one axis; every rank creates the subgroups it lies on with
    `dist.new_group`, in one fixed order (axis by axis, lines in C order).
    Axes in use: ("data", "model") (`make_mesh`), ("data", "pipe") and
    ("data", "model", "pipe") (`pipeline.make_pipeline_mesh`), ("expert",)
    and ("data", "expert") (`moe.make_expert_mesh`).
  * A mesh of one rank needs no process group; asking for more than one
    rank without a group raises, so nothing ever trains on one rank while
    asking for more.
  * `mesh.size`, `mesh.group` and `mesh.index("data")` are the data axis'
    (what the data-parallel wrapper reads); `DataMesh(group, n, rank,
    device)` builds a ("data", "model") mesh of n x 1.
  * `put_sharded` is this rank's rows of a global batch (data-axis order is
    row order); `replicate` broadcasts from rank 0.
  * `all_reduce_mean` / `all_reduce_sum` / `all_gather` / `all_to_all`:
    one flat buffer per dtype where several tensors travel. The route is
    picked from the group's backend, never from a caught error: NCCL
    reduces CUDA tensors where they are (one rank per card); gloo carries
    CPU tensors only, so CUDA buffers go through the host, which is how
    several ranks share one card.
  * Collectives with gradients, for the programs whose every rank computes
    the same loss (the pipeline's stages, the Megatron block, the expert
    layer): `copy_to` (identity forward, all-reduce backward), `reduce_from`
    (all-reduce forward, identity backward), `gather_from` (all-gather
    forward, this rank's slice backward) and `exchange` (all-to-all both
    ways). Each parameter's gradient then is the true one on every rank.
  * `param_specs_for_layer` / `shard_params(tensor_parallel=True)` give the
    reference's tensor-parallel table: which dimension of which parameter
    splits over "model"; `ColumnParallel` is how the wrapper's split step
    computes those layers (each rank its output columns, from the whole
    input). `zero_state_sharding` gives each updater-state leaf's
    dimension split over "data" (the first that divides).

Every collective a helper here (or `ring_attention._ppermute`) runs is
reported to `mesh_cost`'s recorder when one is active, by the reference's
op names, with the result's bytes.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from ..common.device import resolve_device
from ..nn import activations


# -- the recorder (mesh_cost.recording) ---------------------------------------

_RECORDERS = []


def record(kind, tensor_or_bytes):
    """Count one collective of `kind` (the reference's HLO op name) with
    the bytes of its result, in every active recorder."""
    if not _RECORDERS:
        return
    nbytes = (tensor_or_bytes if isinstance(tensor_or_bytes, int)
              else tensor_or_bytes.numel() * tensor_or_bytes.element_size())
    for rec in _RECORDERS:
        r = rec.setdefault(kind, {"count": 0, "bytes": 0})
        r["count"] += 1
        r["bytes"] += int(nbytes)


# -- the mesh -----------------------------------------------------------------

class Mesh:
    """A mesh of named axes over a process group: `shape[axis]` ranks along
    each, this rank at `rank` (its index in `group`), computing on
    `device`. `group` is None for a one-rank mesh without a process
    group."""

    def __init__(self, group, axes, sizes, rank, device):
        # The world group is looked up on each use, not held: a mesh in a
        # reference cycle (a network and its wrapper) would otherwise keep
        # gloo's threads alive past `destroy_process_group`, until the
        # interpreter's shutdown, where tearing them down can abort it.
        self._world = group is not None and group is dist.group.WORLD
        self._group = None if self._world else group
        self.axes = tuple(axes)
        sizes = tuple(int(s) for s in sizes)
        self.shape = dict(zip(self.axes, sizes))
        self.rank = int(rank)
        self.device = torch.device(device)
        self.n_ranks = int(np.prod(sizes))
        if self.rank >= self.n_ranks:
            raise ValueError(f"rank {rank} outside a mesh of "
                             f"{self.n_ranks}")
        self.coords = {a: int(i) for a, i in
                       zip(self.axes, np.unravel_index(self.rank, sizes))}
        self._sub = {}
        self._dm = None
        if group is not None and self.n_ranks > 1:
            self._make_subgroups(group)

    def _make_subgroups(self, group):
        """Every line of every axis of fewer ranks than the mesh that holds
        this rank becomes a `dist.new_group`, created in one fixed order
        (axis by axis, lines in C order) with local synchronisation, so
        only the line's own ranks take part (a mesh over a subgroup needs
        nothing of the ranks outside it)."""
        sizes = tuple(self.shape[a] for a in self.axes)
        for ai, axis in enumerate(self.axes):
            n = sizes[ai]
            if n in (1, self.n_ranks):
                continue
            others = [range(s) if j != ai else range(1)
                      for j, s in enumerate(sizes)]
            for base in itertools.product(*others):
                line = []
                for i in range(n):
                    c = list(base)
                    c[ai] = i
                    line.append(int(np.ravel_multi_index(c, sizes)))
                if self.rank not in line:
                    continue
                ranks = [dist.get_global_rank(group, r) if not self._world
                         else r for r in line]
                self._sub[axis] = dist.new_group(
                    ranks, use_local_synchronization=True)

    @property
    def base_group(self):
        return dist.group.WORLD if self._world else self._group

    def axis_group(self, axis):
        """This rank's process group along `axis`: the mesh's own group
        when the axis spans the mesh, None when it has one rank (or the
        mesh has no group)."""
        n = self.shape.get(axis, 1)
        if self.base_group is None:
            return None
        if n == self.n_ranks:
            return self.base_group
        if n == 1:
            return None
        return self._sub[axis]

    def index(self, axis):
        return self.coords.get(axis, 0)

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    @property
    def group(self):
        """The data axis' group (what the data-parallel wrapper reduces
        over)."""
        return self.axis_group("data")

    @property
    def size(self):
        """The data axis' size."""
        return self.axis_size("data")

    def via_host(self, axis="data"):
        """Whether CUDA tensors must go through the host on `axis` (a gloo
        group)."""
        g = self.axis_group(axis)
        return g is not None and dist.get_backend(g) == dist.Backend.GLOO

    def device_mesh(self):
        """A CPU `DeviceMesh` over this ("data", "model") mesh's ranks with
        dimensions ("model", "data"), so that a tensor split over "model"
        and then over "data" on one dimension is `[Shard(d), Shard(d)]`
        (what `util.sharded_checkpoint` writes with). Made on first use;
        every rank must ask."""
        if self._dm is None:
            from torch.distributed.device_mesh import DeviceMesh
            base = self.base_group
            ranks = [r if self._world else dist.get_global_rank(base, r)
                     for r in range(self.n_ranks)]
            grid = torch.tensor(ranks).reshape(self.axis_size("data"),
                                               self.axis_size("model"))
            self._dm = DeviceMesh("cpu", grid.T.contiguous(),
                                  mesh_dim_names=("model", "data"))
        return self._dm

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def DataMesh(group, n_data, rank, device):
    """A ("data", "model") mesh of n_data x 1."""
    return Mesh(group, ("data", "model"), (n_data, 1), rank, device)


def named_mesh(axes, sizes, group=None, device=None):
    """A mesh of `axes` with `sizes` over `group` (the world group once
    `torch.distributed` is initialised). The product of the sizes must be
    the group's size; without a group it must be 1. `device=None` is the
    CUDA card."""
    device = resolve_device(device)
    sizes = tuple(int(s) for s in sizes)
    n = int(np.prod(sizes))
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but "
                             "torch.distributed is not initialised")
        if n != 1:
            raise RuntimeError(
                f"a mesh {dict(zip(axes, sizes))} of {n} ranks needs a "
                f"torch.distributed process group of {n} ranks: start the "
                f"ranks with torch.distributed (torchrun, or "
                f"init_process_group on each rank); this process has none, "
                f"and never trains on one rank in their place")
        return Mesh(None, axes, sizes, 0, device)
    group = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(group)
    if n != world:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} != the {world} "
                         f"ranks of the process group")
    return Mesh(group, axes, sizes, dist.get_rank(group), device)


def make_mesh(n_data=None, n_model=1, group=None, device=None):
    """A ("data", "model") mesh over `group` (the world group by default,
    once `torch.distributed` is initialised). `n_data` defaults to the
    group's size over `n_model`. `device=None` is the CUDA card."""
    n_model = int(n_model)
    if n_data is None:
        if dist.is_available() and dist.is_initialized():
            g = group if group is not None else dist.group.WORLD
            n_data = dist.get_world_size(g) // n_model
        else:
            n_data = 1
    return named_mesh(("data", "model"), (n_data, n_model), group, device)


def is_multiprocess_mesh(mesh):
    return mesh.n_ranks > 1


# -- tensor-parallel layout ------------------------------------------------------

def param_specs_for_layer(layer, tensor_parallel=False):
    """{parameter name: the dimension split over "model"} for `layer`, in
    the port's layout, or None (everything replicated). The reference's
    table: dense, output, autoencoder and embedding split W's output
    columns (dim 1) and b; convolution splits the out-channels, OIHW dim 0
    here (HWIO dim 3 in the reference); LSTM and SimpleRnn stay
    replicated, as does every other layer. Every split parameter is cut on
    the layer's output features, so a split layer computes its slice of
    the output from the whole input (`ColumnParallel`)."""
    if not tensor_parallel:
        return None
    lt = getattr(layer, "layer_type", "")
    if lt in ("dense", "output", "autoencoder", "embedding"):
        return {"W": 1, "b": 0}
    if lt == "convolution":
        return {"W": 0, "b": 0}
    return None


def _split_dim(shape, dim, n):
    """`dim` when it divides by n (else None: replicate, as the reference
    does for an axis that does not divide)."""
    if dim is None or dim >= len(shape) or shape[dim] % n:
        return None
    return dim


def layer_tp_dims(layer, params, n_model, tensor_parallel=True):
    """{name: dim or None} of one layer's parameters on a model axis of
    n_model ranks."""
    specs = param_specs_for_layer(layer, tensor_parallel) or {}
    return {k: (_split_dim(tuple(p.shape), specs.get(k), n_model)
                if n_model > 1 else None)
            for k, p in params.items()}


def shard_params(net, mesh, tensor_parallel=False):
    """Every rank starts from rank 0's parameters (a broadcast). Returns
    (params, dims): the network's {key: {name: tensor}} and, with
    tensor_parallel, {key: {name: the dimension split over "model", or
    None}} (the wrapper keeps each rank's slice of those); else None."""
    params = [p for per in net._params.values() for p in per.values()]
    replicate(params, mesh)
    if not tensor_parallel:
        return net._params, None
    n = mesh.axis_size("model")
    dims = {key: layer_tp_dims(layer, net._params[key], n)
            for key, layer in net._keyed_layers()}
    return net._params, dims


def zero_state_sharding(ustate, mesh, axis="data"):
    """ZeRO-1-style layout of an updater-state tree ({key: {param: {state
    name: tensor}}}): for each leaf, the first dimension whose size
    divides by the axis' size (and is at least it), or None (replicated,
    e.g. a scalar step counter). The reference shards optimizer state the
    same way (`NamedSharding(P(..., axis, ...))` on that dimension)."""
    n = mesh.axis_size(axis)

    def leaf(a):
        for dim, size in enumerate(a.shape):
            if size % n == 0 and size >= n:
                return dim
        return None

    return {key: {p: {s: leaf(t) for s, t in st.items()}
                  for p, st in per.items()}
            for key, per in ustate.items()}


class ColumnParallel:
    """How the wrapper's split step computes the layers split over "model"
    (Megatron column parallelism with a gathered output): `dims` is {layer
    key: {parameter name: the dimension split over "model", or None}}, of
    which the layers with a split parameter are the split ones, `group`
    the "model" group. Each model rank holds its slice of a split layer's
    output columns (W's and b's, or a convolution's out-channels) and:

      * the whole input goes through `copy_to` (identity forward; backward,
        the sum over "model" of the ranks' partial dX);
      * the layer's own `preout` runs on this rank's slice of W and b
        (input dropout included: every model rank of a data index holds
        the same generator state and the same input, so draws the same
        mask);
      * `gather_from` concatenates the slices of the pre-activation on the
        output's feature dimension (the channels, dim 1 of NCHW, for a
        convolution; the last for the others); backward, each rank keeps
        its slice of dY, so the gradients of W and b come out sliced;
      * the activation, or for an output layer the loss, runs on the whole
        pre-activation, as in the replicated forward.

    So per split layer the step sends an all-gather of the pre-activation
    forward and an all-reduce of dX backward (none for the network's
    input, which needs no gradient), and never gathers a weight. The
    L1/L2 penalty of the split parameters is summed over "model"
    (`reg_score`), and the gradient norms that the updaters' normalization
    and the health watchdog read are those of the whole gradients
    (`grad_sq`)."""

    def __init__(self, group, dims):
        self.group = group
        self.dims = {key: d for key, d in dims.items()
                     if any(v is not None for v in d.values())}

    def splits(self, key):
        return key in self.dims

    def preout(self, layer, params, x, *, train, rng):
        """The whole pre-activation of a split layer from the whole input
        `x` and this rank's slices `params`."""
        if x.is_floating_point():
            x = copy_to(x, self.group)
        pre = layer.preout(params, x, train=train, rng=rng)
        dim = 1 if layer.layer_type == "convolution" else pre.ndim - 1
        return gather_from(pre, self.group, dim)

    def forward(self, layer, params, x, *, train, rng):
        return activations.get(layer.activation)(
            self.preout(layer, params, x, train=train, rng=rng))

    def score_per_example(self, layer, params, x, labels, *, train, rng,
                          mask=None):
        """An output layer's per-example loss on the whole pre-activation."""
        return layer.score_of_preout(
            self.preout(layer, params, x, train=train, rng=rng), labels,
            mask)

    def reg_score(self, layers):
        """The L1/L2 penalty of `layers`, [(key, layer, {name: tensor})]:
        the split parameters' penalties (each rank's slices) summed over
        "model" by one `reduce_from` (so each slice's gradient is its own
        term's), the replicated parameters' counted once."""
        whole = split = 0.0
        for key, layer, params in layers:
            d = self.dims.get(key, {})
            whole = whole + layer.reg_score(
                {k: v for k, v in params.items() if d.get(k) is None})
            split = split + layer.reg_score(
                {k: v for k, v in params.items() if d.get(k) is not None})
        if isinstance(split, torch.Tensor):
            split = reduce_from(split, self.group)
        return split + whole

    def grad_sq(self, grads):
        """{key: {name: the sum of squares of the whole gradient}} of the
        container's gradients {key: {name: gradient}}, where a split
        parameter's gradient is this rank's slice: its sums over "model"
        (one all-reduce in f64), the replicated ones as they are. Each is
        0-d, in the gradient's dtype widened to at least f32."""
        out, split = {}, []
        for key, per in grads.items():
            d = self.dims.get(key, {})
            out[key] = {}
            for name, g in per.items():
                w = g.detach().to(_buffer_dtype(g.dtype))
                out[key][name] = torch.sum(torch.square(w))
                if d.get(name) is not None:
                    split.append((key, name))
        if split:
            sums = all_reduce_sum(torch.stack(
                [out[k][n].double() for k, n in split]), self.group)
            for i, (k, n) in enumerate(split):
                out[k][n] = sums[i].to(out[k][n].dtype)
        return out


def shard_slice(t, dim, index, n):
    """The `index`-th of n equal pieces of `t` along `dim` (t itself when
    dim is None)."""
    if dim is None or n == 1:
        return t
    c = t.shape[dim] // n
    return t.narrow(dim, index * c, c)


# -- batches ------------------------------------------------------------------

def _rows(a, lo, hi):
    return None if a is None else a[lo:hi]


def put_sharded(arr, mesh):
    """This rank's rows of the global batch `arr` (numpy or a tensor; a
    list or dict of them, leaf by leaf) along the data axis. Raises when
    the batch does not divide by the data size."""
    if arr is None:
        return None
    if isinstance(arr, (list, tuple)):
        return type(arr)(put_sharded(a, mesh) for a in arr)
    if isinstance(arr, dict):
        return {k: put_sharded(a, mesh) for k, a in arr.items()}
    n, b = mesh.size, int(arr.shape[0])
    if b % n:
        raise ValueError(
            f"a batch of {b} rows does not divide over the {n} ranks of the "
            f"data mesh: its global size on dimension 0 must be divisible "
            f"by {n}")
    per = b // n
    i = mesh.index("data")
    return _rows(arr, i * per, (i + 1) * per)


# -- collectives ------------------------------------------------------------------

def _buffer_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _flat_groups(tensors):
    """{buffer dtype: [index into tensors]}, in first-seen order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(_buffer_dtype(t.dtype), []).append(i)
    return groups


def _host(group, t):
    """Whether `t` must go through the host on `group` (CUDA on gloo)."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _collective(flat, mesh, fn, kind="all-reduce", axis="data"):
    """Run fn(buffer, group) on `flat` over the mesh's group along `axis`,
    through the host for a CUDA buffer on a gloo group. Returns the result
    on flat's device."""
    group = mesh.axis_group(axis)
    record(kind, flat)
    if _host(group, flat):
        host = flat.cpu()
        fn(host, group)
        return host.to(flat.device)
    fn(flat, group)
    return flat


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_op(t, group, op):
    """`t` reduced by `op` (a dist.ReduceOp) over the ranks of `group`, as
    a new tensor on t's device (through the host for a CUDA tensor on a
    gloo group)."""
    if group_size(group) == 1:
        return t.detach().clone()
    record("all-reduce", t)
    via_host = _host(group, t)
    buf = t.detach().cpu() if via_host else t.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def all_reduce_sum(t, group):
    """The sum of `t` over the ranks of `group` (`all_reduce_op`)."""
    return all_reduce_op(t, group, dist.ReduceOp.SUM)


def all_reduce_mean(tensors, mesh, axis="data"):
    """The mean over the ranks of `axis` of each tensor of `tensors`, as
    new tensors of the same dtypes and shapes: one flat buffer per dtype
    (at least f32), summed, divided by n. An axis of one rank returns the
    tensors themselves."""
    tensors = list(tensors)
    n = mesh.axis_size(axis)
    if n == 1:
        return tensors
    out = [None] * len(tensors)
    for dt, idx in _flat_groups(tensors).items():
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dt)
                          for i in idx])
        flat = _collective(flat, mesh, lambda b, g: dist.all_reduce(
            b, op=dist.ReduceOp.SUM, group=g), axis=axis)
        flat = flat / n
        off = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
            off += t.numel()
    return out


@torch.no_grad()
def average_(tensors, mesh):
    """`all_reduce_mean`, written back into `tensors` in place."""
    tensors = list(tensors)
    for t, m in zip(tensors, all_reduce_mean(tensors, mesh)):
        if m is not t:
            t.copy_(m)


@torch.no_grad()
def replicate(tensors, mesh):
    """Broadcast `tensors` (a list) from rank 0 of the mesh, in place, one
    flat buffer per dtype. A one-rank mesh leaves them as they are."""
    tensors = list(tensors)
    if mesh.n_ranks == 1:
        return tensors
    group = mesh.base_group
    src = dist.get_global_rank(group, 0)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if _host(group, flat):
            host = flat.cpu()
            dist.broadcast(host, src=src, group=group)
            flat = host.to(flat.device)
        else:
            dist.broadcast(flat, src=src, group=group)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return tensors


def all_gather(t, group, dim=0):
    """The ranks' tensors of `group`, concatenated along `dim` in rank
    order (all of the same shape)."""
    n = group_size(group)
    if n == 1:
        return t
    via_host = _host(group, t)
    src, back = _movable(
        (t.detach().cpu() if via_host else t.detach()).contiguous())
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    out = back(torch.cat(outs, dim))
    record("all-gather", out)
    return out.to(t.device)


def all_to_all(t, group):
    """`lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)`: `t`'s n
    equal pieces along dim 0 go one to each rank of `group`; the result
    holds the pieces received, in rank order."""
    n = group_size(group)
    if n == 1:
        return t
    via_host = _host(group, t)
    src, back = _movable(
        (t.detach().cpu() if via_host else t.detach()).contiguous())
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    out = back(out)
    record("all-to-all", out)
    return out.to(t.device)


def _sum_wide(t, group):
    """The sum over `group`, in at least f32, rounded once to t's dtype."""
    return all_reduce_sum(t.to(_buffer_dtype(t.dtype)), group).to(t.dtype)


def _movable(t):
    """(t as a dtype every backend moves, the view back): 2-byte floats
    travel as int16."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16), lambda u, dt=t.dtype: u.view(dt)
    return t, lambda u: u


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: where a replicated
    activation enters a computation each rank does only a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_wide(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the partial sums of
    every rank made whole, each rank's loss the same."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_wide(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather forward along `dim`; backward: this rank's slice of the
    gradient (every rank's loss is the same)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, group_size(group)
        ctx.i = dist.get_rank(group) if ctx.n > 1 else 0
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return shard_slice(g, ctx.dim, ctx.i, ctx.n).contiguous(), None, None


class _Exchange(torch.autograd.Function):
    """`all_to_all` with a gradient: the reverse exchange, which for equal
    tiles along dim 0 is the same all-to-all."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


def copy_to(x, group):
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim=0):
    return x if group_size(group) == 1 else _GatherFrom.apply(x, group, dim)


def exchange(x, group):
    return x if group_size(group) == 1 else _Exchange.apply(x, group)
