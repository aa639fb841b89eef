"""Device ms a step in the backward (`train.backward`: the gradients
of the masters, autograd), by its CUDA event interval."""
from ._spans import per_step


def read(ctx):
    return per_step(ctx, ["train.backward"], "device_s")
