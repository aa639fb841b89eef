"""A/B of the ring partial's (K3's) loop and tiles on one NVIDIA card.

    python3 chip_fwd_ab.py       # from the root of a checkout; needs one card

K3 is the kPartial mode of the Hopper forward kernel
(deeplearning4j_tpu_torch/ops/csrc/flash_attention_fwd.cu). It waits for
each kv tile's P V before it issues the next tile's S, and its kv tiles are
64 keys. This script builds that source and copies with the designs it
replaced, under build/fwd_ab/:
  defer:   K1's loop: a tile's P V stays in flight while the next tile's S
           is issued, and the stage is released one tile later;
  keys128: K1's 128-key tiles (4 stages at D=64), with K3's loop.
For each it prints ptxas' registers, spills and its notes when it
serialised K3's wgmma (bf16, D=64), and times K3 at the visible and the
diagonal hop of T=8192 over a ring of 4 (B=4, Tq=Tk=2048, H=8, D=64,
bf16), and K1 non-causal on the same q, k, v (the same work, normalised;
no variant changes K1, so it reads the turns' spread), with CUDA events in
turns (current, variants, variants, current). "defer" must give the same
(acc, m, l) bit for bit; "keys128" rounds p against other running maxima,
so it is held within 1% of each tensor's largest entry. Prints the card's
name and power limit first, and a JSON line last.
"""
import json
import sys

import torch

from chip_bwd_ab import ROOT, build, card_line, in_turns, ptxas_report

SOURCE = "flash_attention_fwd.cu"
WAIT = "  constexpr bool kWaitPV = kMode == kPartial;\n"
KEYS = "  static constexpr int kBlockK = kMode == kPartial ? 64 : 128;\n"
VARIANTS = {"current": [],
            "defer": [(WAIT, "  constexpr bool kWaitPV = false;\n")],
            "keys128": [(KEYS, "  static constexpr int kBlockK = 128;\n")]}
K3_KERNEL = {"K3": r"flash_fwd_hopper_kernelI13__nv_bfloat16Li64ELi2E"}


def same(name, got, first):
    """Bit for bit, but keys128 within 1% of the tensor's largest entry: its
    p round against other running maxima, one bf16 step (2^-8) each, and
    acc is unnormalised, so entries near 0 carry its rows' error."""
    if name == "keys128":
        return bool((got - first).abs().max() <= 1e-2 * first.abs().max())
    return torch.equal(got, first)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_fwd_ab.py needs one card", file=sys.stderr)
        return 1
    print(card_line())
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ring_qkv
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    built = build(_build, SOURCE, VARIANTS, "fwd_ab")
    B, T, H, D = 4, 2048, 8, 64
    q, k, v = ring_qkv(B, T, H, D, torch.bfloat16, seed=21)
    times = in_turns(_build, fa, SOURCE, built, {
        "visible": lambda: fa.flash_attention_partial(q, k, v, 2 * T, 0),
        "diagonal": lambda: fa.flash_attention_partial(q, k, v, T, T),
        "K1": lambda: (fa.flash_attention(q, k, v, False),)}, same=same)
    result = {}
    for name, turns in times.items():
        mean = {call: sum(t[call] for t in turns) / len(turns)
                for call in turns[0]}
        result[name] = {**{f"{call}_ms": ms for call, ms in mean.items()},
                        "runs": turns,
                        "ptxas": ptxas_report(built[name][1], K3_KERNEL)}
        print(f"  {name}: K3 visible hop {mean['visible']:.4f} ms, diagonal "
              f"hop {mean['diagonal']:.4f} ms, K1 non-causal "
              f"{mean['K1']:.4f} ms (runs {turns}); ptxas "
              f"{json.dumps(result[name]['ptxas'])}")
    print(json.dumps({"shape": f"B={B} Tq=Tk={T} H={H} D={D} bf16; K3 "
                               f"causal at the visible (q_off {2 * T}, "
                               f"k_off 0) and diagonal (q_off = k_off = "
                               f"{T}) hops; K1 non-causal",
                      "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
