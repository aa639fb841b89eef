"""Phase 24 of chip_smoke.py, the embeddings path, alone in a fresh process
on one NVIDIA card.

    python3 chip_embeddings.py   # from the root of a checkout; needs one card

BASELINE.md configuration #4 (Word2Vec skip-gram with negative sampling,
V=10,000, D=100, native pairs): flushes card against CPU, the toy fits and
their pins, then config 4 at full width (pairs/s of flushes of 65,536 and
4,096 pairs, each as a CUDA graph and eager, and a profiler trace of a
segment of each), as chip_smoke.py's phase 24 runs it after phases 1-23 in
one process. The eager flush is bound by the host's launches, so the two
readings differ with the process's state; comparing them, on one machine in
one call, is what this script is for. Builds no CUDA kernel (the native C++
library is built at first use). Prints the card's name and power limit
first, and a JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_embeddings.py needs one card",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, embeddings_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"embeddings": embeddings_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
