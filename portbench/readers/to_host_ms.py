"""Host ms a scored batch in copying the probabilities to the host
(`infer.to_host`, which waits for the batch's forward to finish)."""
from ._spans import per_step


def read(ctx):
    return per_step(ctx, ["infer.to_host"], "host_s")
