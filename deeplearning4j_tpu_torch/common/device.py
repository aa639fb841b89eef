"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A missing
card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

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
