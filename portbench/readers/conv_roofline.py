"""The convolutions' and products' share of their roofline, in %: the
operations a step's convolutions and dense products need (`flops`),
at the card's peak, over the device time of the convolution and
matrix-product kernels of a traced step (mean over ranks). Bound by
compute; nothing where no such kernel ran."""
from ._ranks import mean_traced


def read(ctx):
    def share(t):
        busy = (t["by_kind_s"].get("convolution", 0.0)
                + t["by_kind_s"].get("matrix product", 0.0))
        if busy <= 0.0:
            return None
        return 100.0 * ctx.flops_per_step * t["steps"] / (
            ctx.peak_flops * busy)
    return mean_traced(ctx, share)
