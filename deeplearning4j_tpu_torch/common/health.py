"""Output screening: port of deeplearning4j_tpu/common/health.py's
`rowwise_finite` (numpy). The training-health watchdog comes with fused
steps (ROADMAP.md queue 1 item 17).
"""
from __future__ import annotations

import numpy as np
import torch

from ..util.model_serializer import tree_leaves


def rowwise_finite(tree, batch_axis=0):
    """Per-example finiteness of an inference output tree: bool [B] numpy
    vector, True where every leaf's row `b` is all-finite. The serving
    layer's optional output screen (`InferenceServer(screen_outputs=True)`)
    uses it to fail only the poisoned requests of a micro-batch. Leaves are
    numpy arrays or tensors (bf16 is widened to f32, which is exact);
    integer and bool leaves cannot be non-finite."""
    ok = None
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            leaf = leaf.cpu().numpy()
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
            continue
        axes = tuple(i for i in range(a.ndim) if i != batch_axis)
        row_ok = np.isfinite(a).all(axis=axes)
        ok = row_ok if ok is None else (ok & row_ok)
    return ok
