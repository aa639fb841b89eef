"""What the readers share: a mean over the ranks' traced windows."""


def mean_traced(ctx, fn):
    values = [fn(r["trace"]) for r in ctx.ranks if r.get("trace")]
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None
