"""Device ms a step (or scored batch) in BatchNorm: its forwards
(`layer.batchnorm`) and, in training, its backwards
(`layer.batchnorm.backward`, on autograd's thread), by their CUDA event
intervals."""
from ._spans import per_step


def read(ctx):
    return per_step(ctx, ["layer.batchnorm", "layer.batchnorm.backward"],
                    "device_s")
