"""Device kernels a step in the traced window (mean over ranks)."""
from ._ranks import mean_traced


def read(ctx):
    return mean_traced(ctx, lambda t: t["kernels"] / t["steps"])
