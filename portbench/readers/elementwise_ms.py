"""Device ms a step in elementwise, copy or cast, and reduction kernels
in the traced window (mean over ranks)."""
from ._ranks import mean_traced

KINDS = ("elementwise", "copy or cast", "reduction")


def read(ctx):
    return mean_traced(ctx, lambda t: 1e3 * sum(
        t["by_kind_s"].get(k, 0.0) for k in KINDS) / t["steps"])
