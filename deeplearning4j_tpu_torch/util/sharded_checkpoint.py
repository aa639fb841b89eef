"""Port of deeplearning4j_tpu/util/sharded_checkpoint.py: `RoundCheckpointer`
only, as the pure round counter it is without a directory.

The reference saves mesh-sharded training state with orbax. Its port moves
to `torch.distributed.checkpoint` and is not done yet: a checkpoint
directory (and with it crash-resume of ParallelWrapper and TrainingMaster)
raises, naming ROADMAP.md queue 1 item 20.
"""
from __future__ import annotations


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet "
        f"(torch.distributed.checkpoint in place of orbax): ROADMAP.md "
        f"queue 1 item 20")


class RoundCheckpointer:
    """The per-averaging-round gate that ParallelWrapper and
    ParameterAveragingTrainingMaster share (the round is the resume unit:
    master = one split; wrapper = one batch in all-reduce mode, one k-group
    in k-step mode). With `directory=None` it counts rounds: `round` is the
    rounds dispatched, monotonic for life; nothing is restored
    (`resume_round` stays 0), so every round starts, and `round_done`
    saves nothing. A directory raises (item 20)."""

    def __init__(self, directory=None, every=1, keep_last=3, resume=True,
                 owner="trainer"):
        if directory is not None:
            raise _not_ported(f"{owner} checkpointing to a directory")
        self.directory = None
        self.every = max(1, int(every))
        self.keep_last = max(1, int(keep_last))
        self.resume = bool(resume)
        self.owner = owner
        self.round = 0           # rounds dispatched, monotonic for life
        self.resume_round = 0    # rounds covered by a restored checkpoint

    def manager(self):
        return None

    def maybe_resume(self, net):
        """Nothing to restore without a directory."""

    def round_starts(self):
        """True when this round must run (always, with nothing restored);
        counts it."""
        r = self.round
        self.round += 1
        return r >= self.resume_round

    def round_done(self, net):
        """Nothing to save without a directory."""
