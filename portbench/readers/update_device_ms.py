"""Device ms a step in the updater (`train.update`: each layer's
gradient normalization and update rule), by its CUDA event interval."""
from ._spans import per_step


def read(ctx):
    return per_step(ctx, ["train.update"], "device_s")
