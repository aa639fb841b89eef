"""The data-parallel half of deeplearning4j_tpu/parallel/sharding.py, over a
`torch.distributed` process group.

The reference partitions one jitted program over a ("data", "model") device
mesh and lets XLA insert the collectives. The torch idiom is SPMD over
processes: every rank runs the same step on its own rows of the global
batch, and the collectives are explicit. So here a mesh is a process group
and this rank's place in it:

  * `make_mesh` returns a `DataMesh`: `.shape == {"data": n, "model": 1}`,
    `.group`, `.rank`, `.device`. Without an initialised process group it
    is a one-rank mesh on the caller's device; `n_data > 1` then raises, so
    nothing ever trains on one rank while asking for more.
  * `put_sharded` is this rank's rows of a global batch (rank order is row
    order, as the "data" axis lays out a sharded batch); it raises, as
    `jax.device_put` does, when the batch does not divide by the data size.
  * `replicate` broadcasts from rank 0, so every rank starts from identical
    parameters, updater state and layer state.
  * `all_reduce_mean` / `all_reduce_sum`: the `pmean` / `psum` the
    reference's programs run over "data". Tensors travel as one flat buffer
    per dtype (never one message per leaf), summed in at least f32 and
    divided by n (gloo has no `ReduceOp.AVG`). The route is picked from the
    group's backend, as `ring_attention._ppermute` picks it: NCCL reduces
    CUDA tensors where they are (one rank per card); gloo carries CPU
    tensors only, so CUDA buffers go through the host, which is how several
    ranks share one card.

Tensor parallelism (`n_model > 1`, `shard_params(..., tensor_parallel=True)`)
and the ZeRO-style sharded updater state are not ported yet: they raise,
naming ROADMAP.md queue 1 item 20.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..common.device import resolve_device


def not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet: ROADMAP.md "
        f"queue 1 item {item}")


class DataMesh:
    """A ("data", "model") mesh over a process group: `shape["data"]`
    ranks, this one at `rank`, computing on `device`. `group` is None for
    a one-rank mesh without a process group."""

    def __init__(self, group, n_data, rank, device):
        # The world group is looked up on each use, not held: a mesh in a
        # reference cycle (a network and its wrapper) would otherwise keep
        # gloo's threads alive past `destroy_process_group`, until the
        # interpreter's shutdown, where tearing them down can abort it.
        self._world = group is not None and group is dist.group.WORLD
        self._group = None if self._world else group
        self.shape = {"data": int(n_data), "model": 1}
        self.rank = int(rank)
        self.device = torch.device(device)

    @property
    def group(self):
        return dist.group.WORLD if self._world else self._group

    @property
    def size(self):
        return self.shape["data"]

    def via_host(self):
        """Whether CUDA tensors must go through the host (a gloo group)."""
        return (self.group is not None
                and dist.get_backend(self.group) == dist.Backend.GLOO)


def make_mesh(n_data=None, n_model=1, group=None, device=None):
    """A data mesh over `group` (the world group by default, once
    `torch.distributed` is initialised). `n_data` defaults to the group's
    size and must equal it. `device=None` is the CUDA card."""
    if int(n_model) != 1:
        raise not_ported("tensor parallelism (a mesh with n_model > 1)", 20)
    device = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but "
                             "torch.distributed is not initialised")
        if n_data not in (None, 1):
            raise RuntimeError(
                f"a data mesh of {n_data} ranks needs a torch.distributed "
                f"process group of {n_data} ranks: start the ranks with "
                f"torch.distributed (torchrun, or init_process_group on each "
                f"rank); this process has none, and never trains on one rank "
                f"in their place")
        return DataMesh(None, 1, 0, device)
    group = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(group)
    if n_data is not None and int(n_data) != world:
        raise ValueError(f"mesh {n_data}x1 != the {world} ranks of the "
                         f"process group")
    return DataMesh(group, world, dist.get_rank(group), device)


def is_multiprocess_mesh(mesh):
    return mesh.size > 1


def shard_params(net, mesh, tensor_parallel=False):
    """The parameters as every rank holds them: replicated (broadcast from
    rank 0). Returns (params, None); tensor parallelism raises."""
    if tensor_parallel:
        raise not_ported("tensor-parallel parameter sharding", 20)
    params = [p for per in net._params.values() for p in per.values()]
    replicate(params, mesh)
    return net._params, None


def zero_state_sharding(ustate, mesh, axis="data"):
    raise not_ported("the ZeRO-style sharded updater state", 20)


def _rows(a, lo, hi):
    return None if a is None else a[lo:hi]


def put_sharded(arr, mesh):
    """This rank's rows of the global batch `arr` (numpy or a tensor; a
    list or dict of them, leaf by leaf). Raises when the batch does not
    divide by the data size."""
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
    return _rows(arr, mesh.rank * per, (mesh.rank + 1) * per)


def _buffer_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _flat_groups(tensors):
    """{buffer dtype: [index into tensors]}, in first-seen order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(_buffer_dtype(t.dtype), []).append(i)
    return groups


def _collective(flat, mesh, fn):
    """Run fn(buffer) on `flat` over the mesh's group, through the host
    for a CUDA buffer on a gloo group. Returns the result on flat's
    device."""
    if mesh.via_host() and flat.is_cuda:
        host = flat.cpu()
        fn(host)
        return host.to(flat.device)
    fn(flat)
    return flat


def all_reduce_op(t, group, op):
    """`t` reduced by `op` (a dist.ReduceOp) over the ranks of `group`, as
    a new tensor on t's device (through the host for a CUDA tensor on a
    gloo group)."""
    via_host = t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO
    buf = t.detach().cpu() if via_host else t.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def all_reduce_sum(t, group):
    """The sum of `t` over the ranks of `group` (`all_reduce_op`)."""
    return all_reduce_op(t, group, dist.ReduceOp.SUM)


def all_reduce_mean(tensors, mesh):
    """The mean over the mesh's ranks of each tensor of `tensors`, as new
    tensors of the same dtypes and shapes: one flat buffer per dtype
    (at least f32), summed, divided by n. A one-rank mesh returns the
    tensors themselves."""
    tensors = list(tensors)
    if mesh.size == 1:
        return tensors
    out = [None] * len(tensors)
    for dt, idx in _flat_groups(tensors).items():
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dt)
                          for i in idx])
        flat = _collective(flat, mesh, lambda b: dist.all_reduce(
            b, op=dist.ReduceOp.SUM, group=mesh.group))
        flat = flat / mesh.size
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
    if mesh.size == 1:
        return tensors
    src = dist.get_global_rank(mesh.group, 0)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = _collective(flat, mesh, lambda b: dist.broadcast(
            b, src=src, group=mesh.group))
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return tensors
