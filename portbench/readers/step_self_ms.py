"""Host ms a step spent in the containers themselves: the self time
of `train.step` and `train.dispatch` (each less its child spans: the
feed's wait, the phases, the listeners)."""
from ._spans import per_step


def read(ctx):
    return per_step(ctx, ["train.step", "train.dispatch"], "self_s")
