"""Device selection and the card's numerics for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A missing
card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; any explicit device is taken as given.

    Raises RuntimeError when `None` is passed and no card is present, with
    the way to ask for the CPU in the message."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU (kernels then run as their plain PyTorch versions)")
    return torch.device("cuda")


class _Numerics:
    """The process-wide cuDNN/cuBLAS flags shared by every `card_numerics`
    scope: the caller's values (saved by the first scope in, restored by the
    last one out), how many scopes are open, and how many of them run
    float32/float64 work. One lock orders every enter and exit."""
    lock = threading.Lock()
    depth = 0
    strict = 0
    saved = None


def _flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32


def _search():
    """Whether cuDNN may time its algorithms: not when the caller asked
    for deterministic ones."""
    return not (torch.backends.cudnn.deterministic
                or torch.are_deterministic_algorithms_enabled())


def _set_flags(benchmark, cudnn_tf32, matmul_tf32):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.benchmark = benchmark
    cudnn.allow_tf32, matmul.allow_tf32 = cudnn_tf32, matmul_tf32


@contextlib.contextmanager
def card_numerics(device, dtype):
    """cuDNN and cuBLAS settings for one of the port's calls on the card
    (a no-op off the card). cuDNN picks its convolution algorithms by timing
    them (`benchmark`; the first call of a shape pays the search), unless
    the caller asked for deterministic algorithms (`cudnn.deterministic` or
    `torch.use_deterministic_algorithms`): then by its heuristics, which
    every process resolves alike for a shape, where two processes' timed
    searches may pick algorithms that round differently. For
    float32 and float64 work TF32 is off: PyTorch's default
    `cudnn.allow_tf32 = True` would run f32 convolutions with 10-bit
    mantissas. The flags are process-wide, and calls may overlap (a server's
    batcher thread, a staging thread and the caller's `fit`), so the scopes
    share one count: the first to enter saves the caller's flags, the last to
    leave restores them, and TF32 stays off while any float32/float64 scope
    is open. The backward of a step runs inside the call."""
    if device.type != "cuda":
        yield
        return
    strict = dtype in (torch.float32, torch.float64)
    with _Numerics.lock:
        if _Numerics.depth == 0:
            _Numerics.saved = _flags()
        _Numerics.depth += 1
        _Numerics.strict += strict
        _set_flags(_search(), *((False, False) if _Numerics.strict
                           else _Numerics.saved[1:]))
    try:
        yield
    finally:
        with _Numerics.lock:
            _Numerics.depth -= 1
            _Numerics.strict -= strict
            if _Numerics.depth == 0:
                _set_flags(*_Numerics.saved)
                _Numerics.saved = None
            elif not _Numerics.strict:
                _set_flags(_search(), *_Numerics.saved[1:])


def to_port(a, device):
    """An array of the public API (numpy or tensor) as a tensor on
    `device`. A 4-D array is an NHWC image batch, as the reference takes
    it, and becomes the port's NCHW view of the same bytes (channels_last
    when the array is contiguous)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if t.ndim == 4:
        t = t.permute(0, 3, 1, 2)
    return t.to(device)


def to_public(t):
    """A port tensor as the public API's numpy array: NHWC for a 4-D image
    batch; bf16 widened to f32 (numpy has no bf16; the widening is exact)."""
    t = t.detach()
    if t.ndim == 4:
        t = t.permute(0, 2, 3, 1)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
