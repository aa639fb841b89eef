"""Phase 32 of chip_smoke.py, the training UI and the visualisation tools,
alone in a fresh process on one NVIDIA card.

    python3 chip_ui.py    # from the root of a checkout; needs one card

(a) LeNet f32 at batch 64 with a full StatsListener against the same fit
without one, bit for bit, the step's activation summaries against
feed_forward, the legacy listeners; (b) ResNet-50 bf16 at batch 128 with
the listener reporting every 10 steps and every step into a SQLite
storage, a UIServer on 127.0.0.1 serving every page and /api route from
it, and VGG-16 bf16 at batch 64 with the step's activation summaries
disarmed and armed; (c) LeNet through the wrapper on 4 gloo ranks of the
card, the global batch's activation summaries against one process's; (d) k-means over a
10,000 x 100 table, K 100, card against CPU; (e) t-SNE: the dense loop at
N=4096 card against CPU (5 iterations held at twice the CPU's own f32 vs
f64 distance, 50 read), `Tsne.fit`, Barnes-Hut at N=10,000 with the
native forces; (f) the prefetching CSV reader against the plain one; (g)
`python -m deeplearning4j_tpu_torch.parallel.main` on the card, posting
to (b)'s server. The flash counters must read 0. Builds no kernel. Prints
the card's name and power limit first, and a JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_ui.py needs one card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, ui_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"ui": ui_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
