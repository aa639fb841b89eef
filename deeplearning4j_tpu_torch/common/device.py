"""Device selection and the card's numerics for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A missing
card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def card_numerics(device, dtype):
    """cuDNN and cuBLAS settings for one of the port's calls on the card,
    restored when it returns (a no-op off the card). cuDNN picks its
    convolution algorithms by timing them (`benchmark`; the first call of a
    shape pays the search). For float32 and float64 work TF32 is off:
    PyTorch's default `cudnn.allow_tf32 = True` would run f32 convolutions
    with 10-bit mantissas. The flags are process-wide while the call runs,
    and the backward of a step runs inside the call."""
    if device.type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32
    cudnn.benchmark = True
    if dtype in (torch.float32, torch.float64):
        cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = saved


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
