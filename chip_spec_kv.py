"""Phase 27 of chip_smoke.py alone in a fresh process on one NVIDIA card:
ResNet-50 with segment remat (BASELINE config 2, bench.py's
resnet50_remat), speculative decoding and durable KV state (preemption,
migration, the prefix cache on disk) on the TransformerLM's decode server.

    python3 chip_spec_kv.py    # from the root of a checkout; needs one card

The teaching steps of 27(b) build the flash kernels at first use (nvcc,
about half a minute). Prints the card's name and power limit first, and a
{"spec_kv": ...} JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_spec_kv.py needs one card",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, spec_kv_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"spec_kv": spec_kv_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
