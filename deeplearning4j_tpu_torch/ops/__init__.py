"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (ports of the JAX package's Pallas kernels). Kernels build on first
use; importing this package builds nothing.

Import the modules themselves (`from deeplearning4j_tpu_torch.ops import
flash_attention`): each holds its kernel's wrapper, plain version and launch
counter."""
