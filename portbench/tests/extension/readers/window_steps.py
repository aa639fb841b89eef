"""Steps the untraced window took: a per-layer metric a later change adds
as one file (the extension test's)."""


def read(ctx):
    return float(ctx.steps)
