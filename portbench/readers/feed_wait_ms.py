"""Host ms a step (or scored batch) the loop waited for the feed: the
blocking take of `AsyncDataSetIterator.next_batch` (`data.wait`), the
program's own span beside the harness's `data_wait_ms`."""
from ._spans import per_step


def read(ctx):
    return per_step(ctx, ["data.wait"], "host_s")
