"""Phase 23 of chip_smoke.py, the recurrent path, alone in a fresh process
on one NVIDIA card.

    python3 chip_recurrent.py    # from the root of a checkout; needs one card

The char-RNN (BASELINE.md configuration #3) card against CPU, then at full
width in bf16 (chars/s, ms per fit and per segment, a profiler trace of a
fit, ms per streamed step), as chip_smoke.py's phase 23 runs it after
phases 1-22 in one process. The fit is bound by the host's launches, so
the two readings differ with the process's state; comparing them, on one
machine in one call, is what this script is for. Builds no kernel. Prints
the card's name and power limit first, and a JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_recurrent.py needs one card",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, char_rnn_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"recurrent": char_rnn_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
