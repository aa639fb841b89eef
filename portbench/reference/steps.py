"""The reference's training steps and inference, over the benchmark's
inputs, and the norms the comparison reads from them.

`train` takes the first `steps` Nesterov steps of a model (`resnet.Model`,
`vgg.Model`) from the initial parameters over the given batches, as the
configuration states them: the mean softmax cross entropy, its gradients
by autograd, the update of the float32 parameters, BatchNorm's running
averages (decay 0.9, the biased batch variance). It returns each step's
loss, the norm of each parameter's first gradient, and the norm of each
parameter's and each running statistic's change after the last step.

Imports nothing of the measured program.
"""
from __future__ import annotations

import torch

from . import common as C


def norm(t):
    return float(torch.linalg.vector_norm(t.detach().double()))


def train(model, params, batches, *, lr, momentum, bn_names=(), decay=0.9,
          gen=None, recompute=False, loss_rows=None):
    """{"losses": [float], "grad": {leaf: norm}, "change": {leaf: norm}}
    over `batches`, [(NCHW float32 images, one-hot labels)] on one device.
    Leaves are (vertex, name) for parameters and (vertex, "mean" | "var")
    for running statistics. `gen` draws what each step draws
    (`model.step_inputs`). `loss_rows` (n) plants a fault: the loss is the
    mean over the batch's first n rows only, BatchNorm's statistics still
    the whole batch's."""
    p = {k: t.detach().clone().requires_grad_() for k, t in params.items()}
    keys = list(p)
    velocity = {k: torch.zeros_like(t) for k, t in p.items()}
    first = {k: t.detach().clone() for k, t in p.items()}
    dev = next(iter(p.values())).device
    running = {bn: (torch.zeros_like(p[(bn, "gamma")]),
                    torch.ones_like(p[(bn, "gamma")])) for bn in bn_names}
    losses, grad_norms = [], None
    for x, y in batches:
        extra = model.step_inputs(int(x.shape[0]), gen, dev)
        stats = {}
        logits = model.logits(p, x, train=True, stats=stats,
                              recompute=recompute, **extra)
        if loss_rows is not None:
            logits, y = logits[:loss_rows], y[:loss_rows]
        loss = C.cross_entropy(logits, y, model.num)
        grads = torch.autograd.grad(loss, [p[k] for k in keys])
        grads = dict(zip(keys, grads))
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = {k: norm(g) for k, g in grads.items()}
        C.nesterov(p, grads, velocity, lr, momentum)
        for bn in bn_names:
            mean, var = stats[bn]
            m0, v0 = running[bn]
            running[bn] = (decay * m0 + (1 - decay) * mean,
                           decay * v0 + (1 - decay) * var)
        del logits, loss, grads, stats
    moved = {k: (p[k] - first[k]).detach() for k in keys}
    for bn in bn_names:
        mean, var = running[bn]
        moved[(bn, "mean")] = mean
        moved[(bn, "var")] = var - 1.0
    return {"losses": losses, "grad": grad_norms,
            "change": {k: norm(t) for k, t in moved.items()}}


@torch.no_grad()
def probabilities(model, params, x, running=None, block=256):
    """Softmax probabilities of inference over NCHW float32 `x`, in blocks
    of `block` rows."""
    out = []
    for i in range(0, int(x.shape[0]), block):
        logits = model.logits(params, x[i:i + block], train=False,
                              running=running)
        out.append(model.num.hold(torch.softmax(logits, dim=-1)))
    return torch.cat(out)


@torch.no_grad()
def batch_statistics(model, params, x, bn_names):
    """{vertex: (mean, biased var)} of each BatchNorm in a training-mode
    forward over `x`: running statistics calibrated on that batch."""
    stats = {}
    model.logits(params, x, train=True, stats=stats)
    return {bn: stats[bn] for bn in bn_names}
