"""PyTorch/CUDA port of `deeplearning4j_tpu`, for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here is held
against its counterpart by a parity test on the CPU. This package imports
neither JAX nor anything of `deeplearning4j_tpu`; it keeps its own copies of
what it needs.

Importing it is light: no kernel is built and CUDA need not be present.
Kernels are compiled with `nvcc` on first use (`ops/_build.py`).

Ported so far: the inference half of the TransformerLM zoo model
(`models.zoo.transformer`) and the flash-attention forward kernel
(`ops.flash_attention`). ROADMAP.md queues the rest.
"""
from .common.device import resolve_device

__all__ = ["resolve_device"]
