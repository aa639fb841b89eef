"""Flash attention: hand-written CUDA kernels for Hopper, forward and
backward.

Port of deeplearning4j_tpu/ops/flash_attention.py: `flash_attention`, a
`jax.custom_vjp` over four Pallas kernels, and the ring-attention pieces
`flash_attention_partial` and `flash_attention_bwd_partial`. Each of the five
Pallas kernels has a CUDA kernel here:
  K1 `_kernel`         -> `csrc/flash_attention_fwd.cu` `dl4j_flash_fwd`
  K2 `_kernel_lse`     -> `csrc/flash_attention_fwd.cu` `dl4j_flash_fwd_lse`
  K3 `_partial_kernel` -> `csrc/flash_attention_fwd.cu` `dl4j_flash_fwd_partial`
  K4 `_bwd_dq_kernel`  -> `csrc/flash_attention_bwd.cu` `dl4j_flash_bwd_dq`
  K5 `_bwd_dkv_kernel` -> `csrc/flash_attention_bwd.cu` `dl4j_flash_bwd_dkv`
Their designs and bounds are in those files. K3, K4 and K5 take the global
offsets `q_off`/`k_off` of a ring hop (the causal mask keeps
q_off + i >= k_off + j); K4 and K5 also write f32 gradients when asked, so
the ring (`parallel/ring_attention.py`) rounds once after its last hop.

`flash_attention` picks its route as the custom VJP does: with grad enabled
and an input that requires grad, it runs `_FlashAttention` (forward K2, which
saves the logsumexp; backward delta = rowsum(dO * O), then K4, then K5);
otherwise the single-output forward K1.

Layout is the JAX package's: q, k, v, the output and the gradients are
[B, T, H, D]; lse and delta are f32 [B, H, T] (JAX's [B*H, T, 1] without the
unit axis). The kernels read q, k, v through strides, so the views that
`flash_causal_attention` splits out of one qkv projection go in without a
copy; only the innermost stride must be 1.

Each wrapper launches its kernel on CUDA tensors or raises, and on CPU
tensors runs the kernel's plain PyTorch version (`*_reference`). The tiling
(the JAX `block_q`/`block_k`/`interpret`) is the kernels' own business and is
not a parameter here.

`launches` counts kernel launches by kernel; `reset_launches()` sets every
count to 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

launches = {"fwd": 0, "fwd_lse": 0, "partial": 0, "bwd_dq": 0,
            "bwd_dkv": 0}

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# The finite masked score of the ring partial (the TPU kernel's
# `_FINITE_NEG`): a row that has seen no key keeps m = -1e30, l = 0, acc = 0,
# and the cross-hop fold stays free of NaN.
FINITE_NEG = -1e30
# launch counter -> (source, C function, pointer args, the kernel's own int
# arguments after `causal`). Every C function takes (dtype, head dim,
# pointers..., B, H, T, strides, scale, causal, own ints..., stream).
_KERNELS = {
    "fwd": ("flash_attention_fwd", "dl4j_flash_fwd", 4, ()),
    "fwd_lse": ("flash_attention_fwd", "dl4j_flash_fwd_lse", 5, ()),
    "partial": ("flash_attention_fwd", "dl4j_flash_fwd_partial", 6,
                ("q_off", "k_off")),
    "bwd_dq": ("flash_attention_bwd", "dl4j_flash_bwd_dq", 7,
               ("q_off", "k_off", "out_dtype")),
    "bwd_dkv": ("flash_attention_bwd", "dl4j_flash_bwd_dkv", 8,
                ("q_off", "k_off", "out_dtype")),
}
_fns = {}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _scores(q, k, causal, scale, q_off=0, k_off=0, neg=float("-inf")):
    """[B, H, Tq, Tk] f32 scores: products of the input type accumulated in
    f32, scaled after the product. Causal keeps q_off + i >= k_off + j
    (global positions) and sets the rest to `neg`."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = q_off + torch.arange(q.shape[1], device=q.device)
        cols = k_off + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(rows[:, None] < cols[None, :], neg)
    return s


def _softmax_parts(q, k, v, causal, scale):
    """(acc [B, T, H, D] f32, m [B, H, T], l [B, H, T]) of the plain forward:
    the probabilities p = exp(s - row max) are left unnormalised in f32;
    their sum l is taken in f32 while the PV product takes them rounded to
    v's type."""
    s = _scores(q, k, causal, _scale(q, scale))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(-1)


def flash_attention_reference(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of K1, [B, T, H, D]: acc / max(l, 1e-30) in
    q's type. It materialises the [T, T] scores."""
    acc, _, l = _softmax_parts(q, k, v, causal, scale)
    return (acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)


def flash_attention_lse_reference(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of K2: (o as `flash_attention_reference` gives
    it, lse = m + log(max(l, 1e-30)) as f32 [B, H, T])."""
    acc, m, l = _softmax_parts(q, k, v, causal, scale)
    l = l.clamp_min(1e-30)
    return ((acc / l.transpose(1, 2)[..., None]).to(q.dtype),
            m + torch.log(l))


def flash_attention_partial_reference(q, k, v, q_off, k_off, causal=True,
                                      scale=None):
    """Plain PyTorch version of K3: the unnormalised partial of one ring hop,
    (acc [B, T, H, D] f32, m [B, H, T] f32, l [B, H, T] f32). Masked scores
    are FINITE_NEG; p = exp(s - m) is zeroed where s <= FINITE_NEG / 2, so a
    row that sees no key of the hop gets m = FINITE_NEG, l = 0, acc = 0. l
    sums the f32 p; the PV product takes p rounded to v's type."""
    s = _scores(q, k, causal, _scale(q, scale), q_off, k_off, FINITE_NEG)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s > FINITE_NEG * 0.5, p, 0.0)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return acc, m, p.sum(-1)


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32, [B, H, T]: computed once per backward
    and read by both backward kernels (plain torch ops on every device, as
    the JAX package leaves it to XLA)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_panels(q, k, v, do, lse, delta, causal, scale, q_off, k_off):
    """(p, ds) [B, H, T, T] f32: p = exp(s - lse), 0 where masked;
    ds = p * (dO vᵀ - delta)."""
    p = torch.exp(_scores(q, k, causal, scale, q_off, k_off) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal=True,
                                     scale=None, q_off=0, k_off=0,
                                     out_dtype=None):
    """Plain PyTorch version of K4: dQ = (ds in k's type) K, accumulated in
    f32, times scale, in `out_dtype` (default q's type; f32 is the
    accumulator itself, unrounded). q_off/k_off: global offsets of the
    causal mask."""
    scale = _scale(q, scale)
    _, ds = _bwd_panels(q, k, v, do, lse, delta, causal, scale, q_off, k_off)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(out_dtype or q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal=True,
                                      scale=None, q_off=0, k_off=0,
                                      out_dtype=None):
    """Plain PyTorch version of K5: (dK = (ds in q's type)ᵀ Q · scale,
    dV = (p in dO's type)ᵀ dO), accumulated in f32, in `out_dtype`
    (default k's / v's type)."""
    scale = _scale(q, scale)
    p, ds = _bwd_panels(q, k, v, do, lse, delta, causal, scale, q_off, k_off)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return (dk * scale).to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True,
                                  scale=None):
    """The plain backward: delta, the dQ pass, the dK/dV pass. Returns
    (dq, dk, dv)."""
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                          scale)
    return (dq, *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   causal, scale))


def _kernel_fn(name):
    fn = _fns.get(name)
    if fn is None:
        source, symbol, n_ptr, own = _KERNELS[name]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_int] + [ctypes.c_int] * len(own)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError("flash_attention takes q, k, v of one shape "
                         f"[B, T, H, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v must share a dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def _check_kernel_input(q, named):
    """`q` sets device, dtype and shape; `named` are (name, tensor) pairs of
    [B, T, H, D] tensors the kernel reads or writes through strides."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("the flash kernel takes float32, float16 or bfloat16, "
                        f"not {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dim in {HEAD_DIMS}, "
                         f"not {q.shape[-1]}")
    B, T, H, _ = q.shape
    if T > 65535 * 16 or B * H > 2**31 - 1:   # CUDA grid limits
        raise ValueError(f"shape {tuple(q.shape)} is too large for the grid")
    for name, t in named:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device; "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in its last dim; "
                             f"got strides {t.stride()}")
        # the 16-bit kernels move rows as 16-byte vectors, and the TMA
        # tensor maps of the Hopper kernels take 16-byte strides and base
        if q.dtype != torch.float32 and (
                any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(f"{name}'s rows must start 16-byte aligned for "
                             f"{q.dtype}; got strides {t.stride()}")


def _launch(name, q, pointers, strided, scale, causal, **own):
    """Launch kernel `name` on q's stream: dtype, head dim, `pointers`
    (data pointers in the C function's order), B, H, T, the (batch, time,
    head) strides of the `strided` tensors, scale, causal, then the
    kernel's own int arguments (`_KERNELS`) from `own`."""
    B, T, H, D = q.shape
    strides = [s for t in strided for s in t.stride()[:3]]
    fn = _kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], D, *pointers, B, H, T,
                (ctypes.c_longlong * len(strides))(*strides),
                float(_scale(q, scale)), int(bool(causal)),
                *(int(own[arg]) for arg in _KERNELS[name][3]), stream)
    if rc:
        raise RuntimeError(f"flash attention kernel {name} launch failed: "
                           f"CUDA error {rc} ({_KERNELS[name][0]}.cu, shape "
                           f"{tuple(q.shape)}, {q.dtype})")
    launches[name] += 1


def _forward(q, k, v, causal, scale):
    """K1: the single-output forward (plain version on the CPU)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    _check_kernel_input(q, (("q", q), ("k", k), ("v", v)))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel():
        _launch("fwd", q, [t.data_ptr() for t in (q, k, v, out)],
                (q, k, v, out), scale, causal)
    return out


def flash_attention_fwd_lse(q, k, v, causal=True, scale=None):
    """K2: (o [B, T, H, D] in q's type, lse f32 [B, H, T]). On CUDA tensors
    the kernel (raises on input it does not take); on CPU tensors
    `flash_attention_lse_reference`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, v, causal, scale)
    _check_kernel_input(q, (("q", q), ("k", k), ("v", v)))
    B, T, H, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    if out.numel():
        _launch("fwd_lse", q,
                [t.data_ptr() for t in (q, k, v, out, lse)],
                (q, k, v, out), scale, causal)
    return out, lse


def _check_offsets(q_off, k_off):
    q_off, k_off = int(q_off), int(k_off)
    if not (0 <= q_off < 2**30 and 0 <= k_off < 2**30):
        raise ValueError(f"offsets must lie in [0, 2**30); got {q_off}, "
                         f"{k_off}")
    return q_off, k_off


def flash_attention_partial(q, k, v, q_off, k_off, causal=True, scale=None):
    """K3: one ring hop's unnormalised partial, (acc [B, T, H, D] f32,
    m [B, H, T] f32, l [B, H, T] f32), for the q chunk at global offset
    `q_off` against the visiting kv chunk at `k_off`. q, k and v share one
    shape: the ring's chunks are equal. On CUDA tensors the kernel (raises
    on input it does not take); on CPU tensors
    `flash_attention_partial_reference`."""
    _check(q, k, v)
    q_off, k_off = _check_offsets(q_off, k_off)
    if q.device.type == "cpu":
        return flash_attention_partial_reference(q, k, v, q_off, k_off,
                                                 causal, scale)
    _check_kernel_input(q, (("q", q), ("k", k), ("v", v)))
    B, T, H, _ = q.shape
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    l = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    if acc.numel():
        _launch("partial", q,
                [t.data_ptr() for t in (q, k, v, acc, m, l)],
                (q, k, v, acc), scale, causal, q_off=q_off, k_off=k_off)
    return acc, m, l


def _out_dtype(q, out_dtype):
    """The gradient type: q's (the default) or f32."""
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {q.dtype} or torch.float32, not "
                        f"{out_dtype}")
    return out_dtype


def _check_stats(q, lse, delta):
    B, T, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, H, T) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be f32 [B, H, T] = {(B, H, T)}, "
                             f"contiguous, on {q.device}; got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")


def _contiguous_do(do):
    """dO as autograd hands it over may be strided or expanded (stride 0,
    e.g. from out.sum()); the kernels take it as a fresh contiguous copy."""
    if do.is_contiguous() and do.data_ptr() % 16 == 0:
        return do
    return do.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=None,
                           q_off=0, k_off=0, out_dtype=None):
    """K4: dQ [B, T, H, D] in `out_dtype` (q's type by default, or f32),
    from the residuals q, k, v, lse (f32 [B, H, T], from K2), the output
    gradient do and delta = `attention_delta(o, do)`; q_off/k_off are the
    causal mask's global offsets. CPU tensors:
    `flash_attention_bwd_dq_reference`."""
    _check(q, k, v)
    q_off, k_off = _check_offsets(q_off, k_off)
    out_dtype = _out_dtype(q, out_dtype)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, scale, q_off, k_off,
                                                out_dtype)
    do = _contiguous_do(do)
    _check_kernel_input(q, (("q", q), ("k", k), ("v", v), ("do", do)))
    _check_stats(q, lse, delta)
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if dq.numel():
        _launch("bwd_dq", q,
                [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)],
                (q, k, v, do, dq), scale, causal, q_off=q_off, k_off=k_off,
                out_dtype=_DTYPE_CODE[out_dtype])
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True,
                            scale=None, q_off=0, k_off=0, out_dtype=None):
    """K5: (dK, dV) [B, T, H, D] in `out_dtype` (k's / v's type by default,
    or f32), from the same inputs as `flash_attention_bwd_dq`. CPU tensors:
    `flash_attention_bwd_dkv_reference`."""
    _check(q, k, v)
    q_off, k_off = _check_offsets(q_off, k_off)
    out_dtype = _out_dtype(q, out_dtype)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale, q_off, k_off,
                                                 out_dtype)
    do = _contiguous_do(do)
    _check_kernel_input(q, (("q", q), ("k", k), ("v", v), ("do", do)))
    _check_stats(q, lse, delta)
    dk = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if dk.numel():
        _launch("bwd_dkv", q,
                [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)],
                (q, k, v, do, dk, dv), scale, causal, q_off=q_off,
                k_off=k_off, out_dtype=_DTYPE_CODE[out_dtype])
    return dk, dv


def flash_attention_bwd_partial(q, k, v, delta, do, lse, q_off, k_off,
                                causal=True, scale=None):
    """One ring hop's backward: f32 (dq, dk, dv) for the q chunk at global
    offset `q_off` against the kv chunk at `k_off`, through K4 and K5 (the
    TPU package's `flash_attention_bwd_partial`, in its argument order).
    lse is the row's global logsumexp over every hop, so each hop's p is
    exact; f32 outputs let the ring round once after its last hop."""
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                                q_off, k_off, torch.float32)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                     q_off, k_off, torch.float32)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom VJP pair `_fwd` / `_bwd`: residuals (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_delta(o, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, scale=None):
    """softmax(q kᵀ · scale, causal) v over [B, T, H, D]; scale defaults to
    1/sqrt(D). Differentiable: with grad enabled and an input requiring
    grad, forward K2 and backward K4 + K5; otherwise forward K1. On CUDA
    tensors the kernels run (raising on input they do not take); on CPU
    tensors their plain versions."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale)
