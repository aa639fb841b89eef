"""GiB of device memory allocated at the window's peak (the allocator's
`max_memory_allocated` after a reset at the window's start; the fullest
rank)."""


def read(ctx):
    peak = max(r["peak_window_bytes"] for r in ctx.ranks)
    return peak / 2 ** 30 if peak else None
