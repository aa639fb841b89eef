"""Port of the one piece of deeplearning4j_tpu/parallel/pipeline.py that the
TransformerLM trainer uses: `sgd_momentum_update`. The pipeline schedule
itself is not ported yet (ROADMAP.md)."""
from __future__ import annotations

import torch


@torch.no_grad()
def sgd_momentum_update(params, vel, grads, lr, mu):
    """SGD with momentum over matching sequences of tensors: v <- mu*v + g;
    p <- p - lr*v. Updates `params` and `vel` in place (JAX returns new
    ones) and returns them.

    Each update is computed in at least f32 and rounded once to the
    tensor's dtype, as XLA's fused elementwise rounds a bf16 update once.
    Two in-place bf16 ops in a row would round twice, and `torch.add` on
    bf16 tensors rounds `alpha` itself to bf16 (0.9 -> 0.8984375)."""
    for p, v, g in zip(params, vel, grads, strict=True):
        wide = torch.promote_types(p.dtype, torch.float32)
        v.copy_(torch.add(g.to(wide), v.to(wide), alpha=mu))
        p.copy_(torch.sub(p.to(wide), v.to(wide), alpha=lr))
    return params, vel
