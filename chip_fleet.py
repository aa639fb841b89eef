"""Phase 28 of chip_smoke.py alone in a fresh process on one NVIDIA card:
the fleet and the wire at full width. A FleetManager over three paged
replicas of the TransformerLM's decode server (least-backlog routing on a
Poisson schedule against bare servers, a replica killed mid-run, a drain
with migration, a NaN and a healthy canary rollout), then two replica
processes on cuda:0 behind RemoteReplicas and a journaled manager (a
severed STREAM deduplicated, a SIGKILLed process reaped, the manager
recovered from its journal fencing its predecessor, a SWAP of the full
weights over the wire).

    python3 chip_fleet.py      # from the root of a checkout; needs one card

No kernel is built: the serving programs of this path use none. Prints the
card's name and power limit first, and a {"fleet": ...} JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_fleet.py needs one card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, fleet_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"fleet": fleet_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
