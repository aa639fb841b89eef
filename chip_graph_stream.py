"""Phase 33 of chip_smoke.py, graph embeddings, streaming and object-store
training, alone in a fresh process on one NVIDIA card.

    python3 chip_graph_stream.py    # from the root of a checkout; one card

(a) DeepWalk at BlogCatalog's size (10,312 vertices in 39 planted
communities, 333,983 edges, 90% inside a community), vector 128, window 10,
walk length 40, one epoch: walk time, fit time, pairs/s, one traced flush's
busy share, and the 10 nearest vertices sharing a community at 5x chance or
more; (a') a 500-vertex DeepWalk card against CPU (syn0, syn1 1e-5), two
card fits bit-equal, save -> load; (b) LeNet f32 at batch 64 through the
StreamingTrainingPipeline (scores and parameters) and the
StreamingInferencePipeline (rows) against the main thread's fits and
`output()` (1e-5), and ResNet-50 bf16 at batch 32 through the inference
pipeline, timed per payload; (c) `fit` over an ObjectStoreDataSetIterator
bit-equal to the in-memory fit, and two `parallel.main` ranks started by
ClusterProvisioner's launch commands joining a world of 2; (d) the
device-free modules on the committed fixtures. The flash counters must read
0. Builds no kernel. Prints the card's name and power limit first, and a
JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_graph_stream.py needs one card",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, graph_stream_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"graph_stream": graph_stream_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
