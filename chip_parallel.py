"""Phase 25 of chip_smoke.py, data-parallel and parameter-server training,
alone in a fresh process on one NVIDIA card.

    python3 chip_parallel.py   # from the root of a checkout; needs one card

BASELINE.md configuration #5 (ResNet-50 bf16, 224x224x3, global batch 128
through `ParallelWrapper`, as bench.py:1293-1329 runs it on one device):
the one-rank wrapper held bit-equal to plain `fit` in both modes (LeNet
and a conv + BatchNorm net); config 5 timed in turns with plain `fit` on
the same network; the asynchronous parameter server (2 worker threads,
64-row batches from the card); 2 gloo ranks on cuda:0 against one process
(LeNet and the conv + BatchNorm net, all-reduce and k = 4, 1e-5) with the
host all-reduce's share of a step; a `ps_worker_fit` process against a
`PSServer`; `TpuDl4jMultiLayer` with the "direct" and "export" approaches. On a machine
with two cards or more it also runs 25(c) over NCCL, one rank a card.

    python3 chip_parallel.py --nccl   # 25(c) over NCCL alone; 2+ cards

Builds no CUDA kernel. Prints the card's name and power limit first, and a
JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_parallel.py needs one card",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, par_ranks, parallel_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--nccl" in sys.argv[1:]:
        n = torch.cuda.device_count()
        if n < 2:
            print("--nccl needs two cards or more", file=sys.stderr)
            return 1
        print(json.dumps({"nccl_ranks": par_ranks(n, "nccl")}))
        return 0
    print(json.dumps({"parallel": parallel_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
