"""Phase 29 of chip_smoke.py, the training tools, the containers' surface
and the classic CNNs, alone in a fresh process on one NVIDIA card.

    python3 chip_tools.py    # from the root of a checkout; needs one card

(a) `predict`, `get_layer` and `n_layers` on LeNet bf16; (b) the listeners
at BASELINE.md's configuration #1 (LeNet bf16, batch 512, 16 batches a
fit): PerformanceListener's samples/s beside CUDA events over the same
steps, and fused_steps(8) with and without a CollectScoresIterationListener
(images/s, the listener's scores equal to the groups'); (c) early stopping
on the card: LocalFileModelSaver's best model restored bit-equal,
EarlyStoppingParallelTrainer in both modes equal to the plain trainer,
TpuEarlyStoppingTrainer over the TrainingMaster, ShardedModelSaver restored
bit-equal; (d) check_gradients on tier-1's f64 conv net and GravesLSTM;
(e) the solvers, card against CPU; (f) ProfilerListener and
summarize_trace on ResNet-50 bf16 at batch 128 (configuration #2);
(g) AlexNet, VGG-16 and GoogLeNet at 224x224x3 and 1000 classes, bf16, and
their toy copies card against CPU; (h) graft_entry.entry()'s forward.
Builds no kernel. Prints the card's name and power limit first, and a
JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_tools.py needs one card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, tools_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"tools": tools_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
