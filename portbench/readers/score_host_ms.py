"""Host ms a scored batch in `Evaluation.eval` (`eval.score`), the
labels' copy to the host included."""
from ._spans import per_step


def read(ctx):
    return per_step(ctx, ["eval.score"], "host_s")
