"""Ring attention: sequence parallelism over a `torch.distributed` group.

Port of deeplearning4j_tpu/parallel/ring_attention.py, function for
function. The sequence axis is split over the ranks of a process group:
each rank holds one chunk of q, k and v, [B, T/n, H, D], and rank order is
chunk order. K/V chunks rotate around the ring, rank r sending to r+1, while
a running softmax (max m, sum l, accumulator o) folds each visiting chunk
in; causal masking uses global positions. This is the torch SPMD idiom of
the reference's `shard_map` over a mesh axis: every rank calls
`ring_self_attention` on its own chunk.

Routes, as in the reference:
  * einsum: each hop scores the visiting chunk with plain torch in q's
    dtype, with an optional key mask; its gradient flows through autograd,
    the rotation's through `_PPermute` (the reverse rotation);
  * flash (`use_flash=True`): each hop is one launch of K3
    (`ops.flash_attention.flash_attention_partial`), folded in f32; with
    grad, `_RingFlashAttention` keeps the global logsumexp and its backward
    is the fused reverse ring (`ring_attention_bwd_kernel`): K4 and K5 per
    hop with the hop's global offsets and f32 outputs, dK/dV rotating home
    with their chunk, every gradient rounded once at the end.

The rotation goes through `torch.distributed` P2P, one `batch_isend_irecv`
per hop. The route is picked from the group's backend, never from a caught
error: NCCL sends CUDA tensors as they are (one rank per card); gloo carries
CPU tensors only, so CUDA tensors are copied to the host, sent, and copied
back to their device. The latter is how several ranks share one card.
Every wait is bounded by the group's timeout (`init_process_group(timeout=)`).

Each rank's device is its tensors'. On CPU tensors the kernels' plain
versions run; on CUDA tensors the kernels launch or raise.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import flash_attention as fa
from .sharding import record

NEG_INF = -1e30


def _ring(group):
    """(group, n, this rank's index in it)."""
    group = group if group is not None else dist.group.WORLD
    return group, dist.get_world_size(group), dist.get_rank(group)


def _ppermute(tensors, group, shift=1):
    """`lax.ppermute(perm=[(j, (j + shift) % n)])`: each tensor goes to the
    rank `shift` places on in `group` and is replaced by the one from the
    rank `shift` places back. One `batch_isend_irecv`; tensor i travels
    with tag i, so the pairs match on every backend."""
    group, n, rank = _ring(group)
    if n == 1:
        return list(tensors)
    dst = dist.get_global_rank(group, (rank + shift) % n)
    src = dist.get_global_rank(group, (rank - shift) % n)
    via_host = dist.get_backend(group) == dist.Backend.GLOO
    sends = [t.detach().to("cpu" if via_host else t.device).contiguous()
             for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, dst, group, tag)
            for tag, t in enumerate(sends)]
           + [dist.P2POp(dist.irecv, t, src, group, tag)
              for tag, t in enumerate(recvs)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    record("collective-permute", sum(r.numel() * r.element_size()
                                     for r in recvs))
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


class _PPermute(torch.autograd.Function):
    """The rotation with a gradient: its backward is the reverse rotation
    (JAX's transpose of ppermute). All of a hop's tensors rotate in one
    call, so the backward runs the hops as one chain, in the same order on
    every rank. Only the gradients of inputs that need one travel back
    (every rank of an SPMD program needs the same ones)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_ppermute(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        needed = ctx.needs_input_grad[1:]
        back = iter(_ppermute([g for g, need in zip(grads, needed) if need],
                              ctx.group, shift=-1))
        return (None, *(next(back) if need else None for need in needed))


def _attend_block(q, k, v, bias):
    """Scores for one (q chunk, kv block) pair, [B, H, Tq, Tk]: q [B,Tq,H,D];
    k, v [B,Tk,H,D]; bias [Tq, Tk] additive (0 or NEG_INF)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    return s + bias[None, None, :, :]


def _flash_fold(o, m, l, s, v):
    """Fold one block's scores s [B,H,Tq,Tk] into the running (output
    [B,H,Tq,D], max, sumexp); v [B,Tk,H,D]."""
    m_blk = s.amax(-1)                                  # [B,H,Tq]
    m_new = torch.maximum(m, m_blk)
    scale = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])                 # [B,H,Tq,Tk]
    l_new = l * scale + p.sum(-1)
    o_new = o * scale[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return o_new, m_new, l_new


def ring_attention_kernel(q, k, v, kv_mask, group=None, causal=False,
                          scale=None, use_flash=False, return_lse=False):
    """One rank's ring attention over its chunk.

    q, k, v: [B, T_local, H, D], this rank's chunk; kv_mask: [B, T_local]
    validity of its keys (rotates with K/V; ignored by the flash route).
    n hops; after each but the last, K/V move one rank on. Returns the
    output [B, T_local, H, D] in q's dtype and, with `return_lse`, the
    global per-row logsumexp lse = m + log(max(l, 1e-30)), f32 [B, H,
    T_local] (the port's layout), the one residual the fused backward
    needs."""
    group, n, my = _ring(group)
    B, Tq, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    acc_dt = torch.float32 if use_flash else q.dtype
    if not use_flash:
        q = q * scale
    o = torch.zeros(B, H, Tq, D, dtype=acc_dt, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=acc_dt, device=q.device)
    l = torch.zeros(B, H, Tq, dtype=acc_dt, device=q.device)
    qpos = my * Tq + torch.arange(Tq, device=q.device)

    k_blk, v_blk, km_blk = k, v, kv_mask
    for i in range(n):
        src = (my - i) % n                              # origin of k_blk
        if use_flash:
            acc_b, m_b, l_b = fa.flash_attention_partial(
                q, k_blk, v_blk, my * Tq, src * Tq, causal, scale)
            m_new = torch.maximum(m, m_b)
            a_run = torch.exp(m - m_new)
            a_blk = torch.exp(m_b - m_new)
            o = (o * a_run[..., None]
                 + acc_b.transpose(1, 2) * a_blk[..., None])
            l = l * a_run + l_b * a_blk
            m = m_new
        else:
            kpos = src * Tq + torch.arange(Tq, device=q.device)
            if causal:
                bias = torch.where(qpos[:, None] >= kpos[None, :], 0.0,
                                   NEG_INF)
            else:
                bias = torch.zeros(Tq, Tq, device=q.device)
            s = _attend_block(q, k_blk, v_blk, bias.to(q.dtype))
            # invalid keys: NEG_INF for every query, per batch element
            s = s + torch.where(km_blk > 0, 0.0, NEG_INF)[
                :, None, None, :].to(q.dtype)
            o, m, l = _flash_fold(o, m, l, s, v_blk)
        if i < n - 1:
            if use_flash:
                k_blk, v_blk = _ppermute((k_blk, v_blk), group)
            else:
                k_blk, v_blk, km_blk = _PPermute.apply(group, k_blk, v_blk,
                                                       km_blk)
    out = o / l.clamp_min(1e-30)[..., None]             # [B,H,Tq,D]
    out = out.transpose(1, 2).to(q.dtype)               # [B,Tq,H,D]
    if return_lse:
        return out, (m + torch.log(l.clamp_min(1e-30))).float()
    return out


def ring_attention_bwd_kernel(q, k, v, o, lse, do, group=None, causal=False,
                              scale=None):
    """One rank's fused ring backward: the reverse of the forward's
    rotation, each hop's gradients from K4 and K5 with the hop's global
    offsets and f32 outputs (`flash_attention_bwd_partial`).

    The rank keeps its own (q, o, lse, do, delta) and sees each visiting
    (k, v) chunk once. dQ accumulates locally; the dK/dV accumulators
    rotate WITH their chunk, so after n hops each chunk's gradient is home
    with every rank's contribution in it. The global lse makes each hop's
    p exact, so no cross-hop refold is needed. Accumulators stay f32;
    each gradient is rounded once to its input's dtype.

    q, k, v, o, do: [B, T_local, H, D]; lse: f32 [B, H, T_local]. Returns
    (dq, dk, dv) for this rank's chunk."""
    group, n, my = _ring(group)
    Tq = q.shape[1]
    do = do.contiguous()    # autograd may hand it expanded; copied once
    delta = fa.attention_delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_rot = torch.zeros_like(dq)
    dv_rot = torch.zeros_like(dq)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i) % n
        dq_p, dk_p, dv_p = fa.flash_attention_bwd_partial(
            q, k_blk, v_blk, delta, do, lse, my * Tq, src * Tq, causal,
            scale)
        dq += dq_p
        dk_rot += dk_p
        dv_rot += dv_p
        # the gradients travel with their chunk; the last move brings them
        # home, and the chunk itself is not needed after the last hop
        if i < n - 1:
            k_blk, v_blk, dk_rot, dv_rot = _ppermute(
                (k_blk, v_blk, dk_rot, dv_rot), group)
        else:
            dk_rot, dv_rot = _ppermute((dk_rot, dv_rot), group)
    return dq.to(q.dtype), dk_rot.to(k.dtype), dv_rot.to(v.dtype)


def blockwise_attention(q, k, v, kv_mask=None, causal=False, scale=None):
    """Single-device reference with the same math over the full sequence.
    q, k, v: [B, T, H, D]; kv_mask [B, T] key validity."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q = q * scale
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        pos = torch.arange(T, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    if kv_mask is not None:
        s = s + torch.where(kv_mask > 0, 0.0, NEG_INF)[
            :, None, None, :].to(q.dtype)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v)
    return out.transpose(1, 2)


class _RingFlashAttention(torch.autograd.Function):
    """The reference's `rsa` custom VJP: the forward keeps the global lse;
    the backward is `ring_attention_bwd_kernel`."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse = ring_attention_kernel(q, k, v, None, group, causal,
                                         use_flash=True, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ring_attention_bwd_kernel(q, k, v, out, lse, do, ctx.group,
                                           ctx.causal), None, None)


def ring_self_attention(q, k, v, group=None, causal=False, kv_mask=None,
                        use_flash=False):
    """Sequence-parallel attention over the ranks of `group` (default: the
    world). Every rank calls it on its own chunk: q, k, v [B, T/n, H, D],
    the chunk whose global positions start at rank * T/n; kv_mask
    [B, T/n] is the validity of this chunk's keys. Returns this rank's
    chunk of the output, [B, T/n, H, D].

    use_flash: each hop through K3, and with grad the fused ring backward
    through K4/K5; kv_mask is not supported there (pad-free sequences
    only)."""
    if use_flash and kv_mask is not None:
        raise ValueError("use_flash does not support kv_mask; pad-free "
                         "sequences only")
    if not use_flash:
        if kv_mask is None:
            kv_mask = torch.ones(q.shape[:2], dtype=q.dtype, device=q.device)
        return ring_attention_kernel(q, k, v, kv_mask, group, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingFlashAttention.apply(q, k, v, group, causal)
    # primal (inference / no grad): no lse
    return ring_attention_kernel(q, k, v, None, group, causal,
                                 use_flash=True)
