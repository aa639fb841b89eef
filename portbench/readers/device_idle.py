"""Share of an untraced step, in %, in which no operation runs on the
device: the device's busy time a traced step (the union of kernels,
copies and fills) against the untraced window's mean step time on the
host clock (mean over ranks). The traced steps themselves are stretched
by the profiler's host overhead, so their own idle share is not read."""
from ._ranks import mean_traced


def read(ctx):
    step_s = ctx.window_s / ctx.steps
    return mean_traced(ctx, lambda t: 100.0 * (
        1.0 - t["busy_s"] / t["steps"] / step_s))
