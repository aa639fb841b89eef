"""PyTorch/CUDA port of `deeplearning4j_tpu`, for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here is held
against its counterpart by a parity test on the CPU. This package imports
neither JAX nor anything of `deeplearning4j_tpu`; it keeps its own copies of
what it needs.

Importing it is light: no kernel is built and CUDA need not be present.
Kernels are compiled with `nvcc` on first use (`ops/_build.py`).

Ported so far: the TransformerLM zoo model, training (`fit_batch`) and
inference (`models.zoo.transformer`), the flash-attention kernels it runs,
forward and backward (`ops.flash_attention`), the SGD-with-momentum
update (`parallel.pipeline`), ring attention (`parallel.ring_attention`),
and the training core: the configuration DSL, the LeNet and ResNet-50
layers, the updaters, `MultiLayerNetwork` and `ComputationGraph` (`nn`),
`DataSet` (`datasets`), the model zips (`util.model_serializer`) and the
LeNet and ResNet-50 zoo models. ROADMAP.md queues the rest.
"""
from .common.device import resolve_device

__all__ = ["resolve_device"]
