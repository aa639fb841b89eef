"""Phase 30 of chip_smoke.py, layerwise pretraining and the Keras import,
alone in a fresh process on one NVIDIA card.

    python3 chip_pretrain.py    # from the root of a checkout; needs one card

(a) the MNIST deep autoencoder of DL4J's DeepAutoEncoderExample (RBMs
784-1000-500-250-100-30-100-250-500-1000, a sigmoid MSE OutputLayer
1000 -> 784, batch 1000, f32): `pretrain` for 3 batches a layer, each
layer's pretrain step timed (ms, images/s), two traced by the port's
profiler (busy share), then `fit` over ReconstructionDataSetIterator;
(b) the same stack of denoising AutoEncoders (corruption 0.3); (c)
VaeMNIST2dPlots' VAE (784 -> [256, 256] -> 2 -> [256, 256], Bernoulli,
leakyrelu, RMSProp 1e-3, batch 128), pretrained, then
reconstruction_probability and generate_at_mean_given_z; (d) the Keras
import: the committed real fixture (from its npz) against Keras's
predictions, and tier-1's Keras 1 nets card against CPU; then a small
float64 stack card against CPU with the same draws. Peak memory for each.
The flash counters must read 0. Builds no kernel. Prints the card's name
and power limit first, and a JSON line last.
"""
import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_pretrain.py needs one card",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, pretrain_phase
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"pretrain": pretrain_phase(fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
