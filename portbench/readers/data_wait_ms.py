"""ms a step (or a scored batch) the host waited in the iterator's
`next()` in the window: the slowest rank's total over the steps."""


def read(ctx):
    return max(r["data_wait_s"] for r in ctx.ranks) * 1e3 / ctx.steps
