"""Mixture-of-Experts with expert parallelism over an "expert" mesh axis:
port of deeplearning4j_tpu/parallel/moe.py, function for function.

Top-1 routing with raw router-prob gates (Switch) or top-k with the
winners' probs renormalised (GShard/Mixtral, ``k=2``), a fixed expert
capacity, and an all-to-all token exchange so each rank hosts E/n experts'
FFNs. `moe_mlp_dense` is the one-rank version the sharded path is held to.

Parameters are a `MoE` module (or a dict with the same names): gate [D, E],
w1 [E, D, F], b1 [E, F], w2 [E, F, D], b2 [E, D]; sharded, each rank holds
its E/n experts' slices (`shard_moe_params`) and the whole gate.

`moe_mlp_sharded(mesh)` returns apply(params, x) -> (y, aux) with the
reference's signature: x is the whole batch [B, D] on every rank, and so
are y and the aux loss. Each rank takes its shard of the rows (shard
d * n_expert + e on a ("data", "expert") mesh, the reference's layout),
routes them, sends each (token, choice) dispatch unit to its expert's rank
(`sharding.exchange`), runs its local experts over what it received, sends
the results back and combines each token's k returns; the rows then come
together again (`sharding.gather_from`). Every rank computes the same loss
from y, so the gradients of every parameter and of x are the true ones on
every rank: x and the gate enter through `sharding.copy_to` over the
ranks of the batch, the expert weights over "data" (where they are
replicated).

torch.topk does not promise which of two equal values comes first;
`lax.top_k` puts the lower index first, and so does the stable sort here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from .sharding import (all_reduce_sum, copy_to, exchange, gather_from,
                       named_mesh, reduce_from)


class MoE(nn.Module):
    """Gate and stacked expert FFN parameters ([E, ...] leading axis)."""

    def __init__(self, gate, w1, b1, w2, b2):
        super().__init__()
        self.gate, self.w1, self.b1 = (nn.Parameter(gate), nn.Parameter(w1),
                                       nn.Parameter(b1))
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)


def _get(prm, name):
    return prm[name] if isinstance(prm, dict) else getattr(prm, name)


def make_expert_mesh(n_expert, n_data=1, group=None, device=None):
    """An ("expert",) mesh of n_expert ranks, or ("data", "expert") with
    n_data > 1 (the dp x ep layout: rank d * n_expert + e)."""
    if int(n_data) > 1:
        return named_mesh(("data", "expert"), (n_data, n_expert), group,
                          device)
    return named_mesh(("expert",), (n_expert,), group, device)


def init_moe(generator, d_model, n_experts, d_ff, dtype=torch.float32,
             device=None):
    """Random gate and expert weights from `generator` (a CPU generator);
    biases zero."""
    device = resolve_device(device)
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    normal = lambda shape, std: (torch.randn(shape, generator=generator)
                                 * std).to(device=device, dtype=dtype)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return MoE(normal((d_model, n_experts), s_in),
               normal((n_experts, d_model, d_ff), s_in),
               zeros(n_experts, d_ff),
               normal((n_experts, d_ff, d_model), s_out),
               zeros(n_experts, d_model))


def _expert_ffn(w1, b1, w2, b2, x):
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2


def _topk(probs, k):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (`lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_topk(gate_w, x, k):
    """Expert ids [B, k] by descending router prob, the combine weights
    (k=1: the raw prob; k>1: renormalised over the winners) in x's dtype,
    and the full f32 probs [B, E] for the aux loss."""
    probs = torch.softmax((x @ gate_w).float(), -1)
    top_p, experts = _topk(probs, k)
    if k == 1:
        gates = top_p
    else:
        gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return experts, gates.to(x.dtype), probs


def _route_fractions(probs, expert, n_experts):
    """(f, P): the fraction of tokens routed to each expert, and the mean
    router prob per expert."""
    f = F.one_hot(expert, n_experts).to(probs.dtype).mean(0)
    return f, probs.mean(0)


def load_balance_loss(probs, expert, n_experts):
    """The Switch aux loss E * sum_e f_e * P_e."""
    f, p = _route_fractions(probs, expert, n_experts)
    return n_experts * (f * p).sum()


def moe_mlp_dense(params, x, capacity=None, n_shards=1, k=1):
    """The one-rank version: every expert computes every token, the top-k
    mask selects. With `capacity`, dispatch units past an expert's capacity
    are dropped, ranked token-major within each of `n_shards` contiguous
    batch shards (as `moe_mlp_sharded` drops per source shard). Returns
    (y, aux); aux stays over the top-1 assignment."""
    w1 = _get(params, "w1")
    E = w1.shape[0]
    experts, gates, probs = _route_topk(_get(params, "gate"), x, k)
    B = x.shape[0]
    ev = experts.reshape(B * k)
    gv = gates.reshape(B * k)
    onehot_v = F.one_hot(ev, E).to(x.dtype)                     # [B*k, E]
    if capacity is not None:
        oh = onehot_v.reshape(n_shards, (B * k) // n_shards, E)
        pos = (torch.cumsum(oh, 1) - oh).reshape(B * k, E)
        keep = (pos.gather(-1, ev[:, None])[:, 0] < capacity).to(x.dtype)
        gv = gv * keep
    h = F.gelu(torch.einsum("bd,edf->ebf", x, w1)
               + _get(params, "b1")[:, None], approximate="tanh")
    y_all = (torch.einsum("ebf,efd->ebd", h, _get(params, "w2"))
             + _get(params, "b2")[:, None])                       # [E, B, D]
    combine = (onehot_v * gv[:, None]).reshape(B, k, E).sum(1)   # [B, E]
    y = torch.einsum("ebd,be->bd", y_all, combine)
    return y, load_balance_loss(probs, experts[:, 0], E)


def moe_mlp_sharded(mesh, axis="expert", capacity=None, k=1,
                    data_axis=None):
    """The expert-parallel apply fn, apply(params, x[B, D]) -> (y[B, D],
    aux), params this rank's (`shard_moe_params`). B must divide by the
    number of batch shards (the axis' size, times the data axis' when
    `data_axis` is set: dp x ep, the batch over (data_axis, axis) jointly,
    expert weights replicated over data_axis, each data slice exchanging
    within its own expert group). `capacity` bounds the dispatch units per
    (source shard, expert); None = k * B_local, which never drops. The aux
    loss is E * sum(mean f * mean P), the means over every shard first."""
    n = mesh.axis_size(axis)
    g_e = mesh.axis_group(axis)
    nd = 1 if data_axis is None else mesh.axis_size(data_axis)
    g_d = None if data_axis is None else mesh.axis_group(data_axis)
    n_sh = nd * n
    shard = ((0 if data_axis is None else mesh.index(data_axis)) * n
             + mesh.index(axis))
    if data_axis is None:
        grid = g_e
    else:
        if n_sh != mesh.n_ranks:
            raise ValueError(f"a ({data_axis}, {axis}) batch grid of {n_sh} "
                             f"ranks needs a mesh of just those axes, not "
                             f"{mesh.shape}")
        grid = mesh.base_group

    def apply(params, x):
        B, D = x.shape
        if B % n_sh:
            raise ValueError(f"a batch of {B} tokens does not divide over "
                             f"{n_sh} shards")
        B_loc = B // n_sh
        x = copy_to(x, grid)
        gate = copy_to(_get(params, "gate"), grid)
        w1, b1, w2, b2 = (copy_to(_get(params, name), g_d)
                          for name in ("w1", "b1", "w2", "b2"))
        x_local = x[shard * B_loc:(shard + 1) * B_loc]
        e_per = w1.shape[0]
        E = e_per * n
        V = B_loc * k
        C = V if capacity is None else min(int(capacity), V)
        experts, gates, probs = _route_topk(gate, x_local, k)
        expert = experts.reshape(V)
        gate_v = gates.reshape(V)
        x_v = x_local.repeat_interleave(k, 0)                   # [V, D]
        onehot = F.one_hot(expert, E).to(x.dtype)
        pos = torch.cumsum(onehot, 0) - onehot
        pos_t = pos.gather(-1, expert[:, None])[:, 0].long()
        keep = pos_t < C
        # a dropped unit adds a zeroed row at C - 1, as the reference does
        buf = x.new_zeros((E, C, D)).index_put(
            (expert, torch.where(keep, pos_t, C - 1)),
            x_v * keep[:, None].to(x.dtype), accumulate=True)
        recv = exchange(buf.reshape(E * C, D), g_e).reshape(n, e_per, C, D)
        y = torch.stack([
            _expert_ffn(w1[e], b1[e], w2[e], b2[e],
                        recv[:, e].reshape(n * C, D)).reshape(n, C, D)
            for e in range(e_per)])                         # [e, src, C, D]
        y = y.transpose(0, 1).reshape(E * C, D)             # [src, e, C, D]
        back = exchange(y, g_e).reshape(E, C, D)
        out_v = (back[expert, torch.where(keep, pos_t, 0)]
                 * (gate_v * keep.to(gate_v.dtype))[:, None])
        out = out_v.reshape(B_loc, k, D).sum(1)
        # the global-batch aux: the means of f and P over the shards first
        # (shards hold equal token counts), then E * sum(f * P)
        f_loc, p_loc = _route_fractions(probs, experts[:, 0], E)
        f = all_reduce_sum(f_loc, grid) / n_sh
        p = reduce_from(p_loc, grid) / n_sh
        aux = E * (f * p).sum()
        return gather_from(out, grid, 0), aux

    return apply


def shard_moe_params(params, mesh, axis="expert"):
    """This rank's MoE parameters: the gate whole, the expert stacks' rows
    of its experts (E/n of them, in rank order along `axis`)."""
    n = mesh.axis_size(axis)
    i = mesh.index(axis)
    out = {}
    for name in ("gate", "w1", "b1", "w2", "b2"):
        t = _get(params, name).detach()
        if name != "gate":
            c = t.shape[0] // n
            t = t[i * c:(i + 1) * c]
        out[name] = t.clone()
    return MoE(**out)
