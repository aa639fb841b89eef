"""Parallel training helpers (port of deeplearning4j_tpu/parallel/); only
what the ported models use so far, and ring attention (sequence
parallelism over a `torch.distributed` group)."""
from .ring_attention import blockwise_attention, ring_self_attention

__all__ = ["blockwise_attention", "ring_self_attention"]
