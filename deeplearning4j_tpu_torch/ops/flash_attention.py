"""Flash attention forward: a hand-written CUDA kernel for Hopper.

Port of `flash_attention` in deeplearning4j_tpu/ops/flash_attention.py,
forward only (the Pallas `_kernel`). The kernel is
`csrc/flash_attention_fwd.cu`; its design and bound are in that file.

Layout is the JAX package's: q, k, v and the output are [B, T, H, D]. The
kernel reads them through strides, so the q/k/v views that
`flash_causal_attention` splits out of one qkv projection go in without a
copy; only the innermost stride must be 1.

On a CUDA tensor `flash_attention` launches the kernel or raises. On a CPU
tensor it runs `flash_attention_reference`, the plain PyTorch version of the
same arithmetic. The tiling (the JAX `block_q`/`block_k`/`interpret`) is the
kernel's own business and is not a parameter here.

`launches` counts kernel launches; reset it to 0 to count one run.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

launches = 0

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SOURCE = "flash_attention_fwd"
_fn = None


def flash_attention_reference(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of the kernel's arithmetic, [B, T, H, D].

    Scores in f32 (products of the input type, f32 accumulation), scaled
    after the product, masked with -inf (row >= col when causal). The
    probabilities are left unnormalised in f32: their sum is taken in f32,
    while the PV product takes them rounded to v's type. The output is
    acc / max(l, 1e-30) in q's type. It materialises the [T, T] scores."""
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[1]
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l = p.sum(-1).clamp_min(1e-30).transpose(1, 2)[..., None]   # [B, T, H, 1]
    return (acc / l).to(q.dtype)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load(_SOURCE).dl4j_flash_fwd
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def _check_kernel_input(q, k, v):
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in its last dim; "
                             f"got strides {t.stride()}")
        # the 16-bit path moves rows as 16-byte vectors
        if q.dtype != torch.float32 and (
                any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(f"{name}'s rows must start 16-byte aligned for "
                             f"{q.dtype}; got strides {t.stride()}")


def flash_attention(q, k, v, causal=True, scale=None):
    """softmax(q kᵀ · scale, causal) v over [B, T, H, D]; scale defaults to
    1/sqrt(D). On CUDA tensors: the hand-written kernel (raises on input it
    does not take). On CPU tensors: `flash_attention_reference`."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    _check_kernel_input(q, k, v)
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), B, H, T, *strides,
                float(scale), int(bool(causal)), stream)
    if rc:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc} ({_SOURCE}.cu, shape {tuple(q.shape)}, "
                           f"{q.dtype})")
    launches += 1
    return out
