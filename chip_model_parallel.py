"""Phase 31 of chip_smoke.py, model parallelism, alone in a fresh process
on one NVIDIA card.

    python3 chip_model_parallel.py    # from the root of a checkout
    python3 chip_model_parallel.py --nccl   # 31(a) over NCCL alone (4 cards)

Builds the flash kernels, then spawns 4 gloo rank processes on cuda:0
(collectives through the host, as one card cannot host an NCCL group of
4): (a) GPipe over four flash TransformerLM stages at bench.py's width
(V 512, d_model 512, 8 heads, d_ff 2048), bf16, T=8192, four microbatches
of one row: K2, K4 and K5 launched 21 times per rank over 3 `fit_batch`
steps and K1 7 times per `forward`; the first step's loss and each stage's
gradients against the four blocks run in order in one process through the
same kernels; step time, the rotations' measured share, peak memory per
rank; f32
at T=1024 on the card against the CPU's plain versions; (b) Megatron
blocks in the rotation on (data 1, model 2, pipe 2), f32 and bf16, against
the dense blocks, then 10 steps; (c) expert-parallel MoE against the dense
layer at k=1, 2 with and without a capacity that drops, dp x ep top-2 and
a MoE block's step; (d) LeNet with Adam through ParallelWrapper's tensor
parallelism and sharded updater state against the replicated run, its
checkpoint restored into 4 ranks and into one, and swapped into an
InferenceServer, and its step time against data parallelism on (data 4);
(f) `graft_entry.dryrun_multichip(4)` on cuda:0 ranks
with its budget gate; (e) config 4's skip-gram with its tables
column-sharded over the 4 ranks against the whole tables; K1, K2, K4 and
K5 against their plain versions and timed at the stage shape. Where four
cards are present, (a) also runs over NCCL, one rank a card (`--nccl`:
that alone). Prints the card's name and power limit first, and a JSON
line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_model_parallel.py needs one card",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, model_parallel_phase
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = "--nccl" in sys.argv[1:]
    if nccl and torch.cuda.device_count() < 4:
        print("--nccl needs four cards", file=sys.stderr)
        return 1
    _build.build()
    print(json.dumps({"model_parallel": model_parallel_phase(
        fa, nccl_only=nccl)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
