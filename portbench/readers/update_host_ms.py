"""Host ms a step in the updater (`train.update`): the host's launch
loop over the layers' parameters."""
from ._spans import per_step


def read(ctx):
    return per_step(ctx, ["train.update"], "host_s")
