"""Phase 26 of chip_smoke.py, fused steps and the training-health
watchdog, alone in a fresh process on one NVIDIA card.

    python3 chip_fused.py    # from the root of a checkout; needs one card

`fused_steps(8)` against the single step on BASELINE.md's configuration #1
(LeNet bf16, batch 512, 16 batches a fit; images/s in interleaved
segments, one CUDA graph replay a group) and #3 (the char-RNN bf16,
B=64, T=200, TBPTT 50; chars/s, one replay a fit), each arm bit-equal to
the other, traced; the pins of fused == single steps on small nets (lr
schedules, dropout, a fresh net's first group, a TBPTT group at t0 != 0),
f32 LeNet card against CPU; and the watchdog on the card (a NaN skip inside
a group, a rollback mid-group through the checkpoints, an abort, the
one-rank ParallelWrapper's rollback in both modes). Builds no kernel.
Prints the card's name and power limit first, and a JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_fused.py needs one card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, fused_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"fused": fused_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
