"""A/B of the Hopper backward kernels' loop designs on one NVIDIA card.

    python3 chip_bwd_ab.py       # from the root of a checkout; needs one card

K4 and K5 (deeplearning4j_tpu_torch/ops/csrc/flash_attention_bwd.cu) wait
for each tile's last wgmma before they release its stage, and every
consumer warpgroup runs every tile of its block's loop. This script builds
that source and copies of it with the two designs it replaced, under
build/bwd_ab/, and for each prints ptxas' registers, spills and its note
when it serialised the kernel's wgmma (bf16, D=64), and times K4 and K5 at
the training shape (B=4, T=8192, H=8, D=64, bf16, causal) with CUDA events,
in turns (current, variants, variants, current). The variants:
  defer: a tile's last products stay in flight while the next tile's score
         products are issued, and the stage is released one tile later (the
         forward's loop);
  skip:  a consumer skips the products of a tile none of whose pairs it may
         see (causal), releasing the stage at once.
Every variant's gradients must equal the current kernels' bit for bit.
Prints the card's name and power limit first, and a JSON line last.
`build`, `ptxas_report` and `in_turns` also serve chip_fwd_ab.py.
"""
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "flash_attention_bwd.cu"

# lines of the source that the variants rewrite: each kernel's loop end,
# its score products' wait and its stage wait
K4_END = """\
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);  \
// the stage's K and V have been read
    }
"""
K5_END = """\
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);  \
// the stage's Q and dO have been read
    }
"""
K4_SCORES = """\
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
"""
K5_SCORES = K4_SCORES.replace("(sc)", "(st)").replace("(dp)", "(dpt)")
K4_WAIT = """\
      const int k_start = j * BK;
      mbar_wait(full + 8 * s, (j / S) & 1);
"""
K5_WAIT = """\
      const int q_start = (first_tile + j) * BQ;
      mbar_wait(full + 8 * s, (j / S) & 1);
"""
RELEASE_PREVIOUS = \
    "      if (j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % S));\n"
SKIP_TILE = """\
        if (lane == 0) mbar_arrive(empty + 8 * s);
        continue;
      }
"""
DEFER = [
    (K4_END, "      wgmma_commit();\n    }\n    wgmma_wait_all();\n"
             "    fence_regs(acc);\n"),
    (K4_SCORES, K4_SCORES + "      fence_regs(acc);\n" + RELEASE_PREVIOUS),
    (K5_END, "      wgmma_commit();\n    }\n    wgmma_wait_all();\n"
             "    fence_regs(dk_acc);\n    fence_regs(dv_acc);\n"),
    (K5_SCORES, K5_SCORES + "      fence_regs(dk_acc);\n"
                "      fence_regs(dv_acc);\n" + RELEASE_PREVIOUS),
]
SKIP = [
    (K4_WAIT, K4_WAIT + "      if (causal && k_start > "
                        "min(seq_len, wg_row0 + 64) - 1 + dlt) {\n"
     + SKIP_TILE),
    (K5_WAIT, K5_WAIT + "      if (causal && q_start + BQ - 1 + dlt < kw0) {\n"
     + SKIP_TILE),
]
VARIANTS = {"current": [], "defer": DEFER, "skip": SKIP}


def build(_build, source, variants, out_name):
    """Compile `source` (a file of csrc/) with each variant's (old, new)
    patches, all in parallel, under build/<out_name>/; returns {name:
    (library, log)}."""
    out = ROOT / "build" / out_name
    shutil.rmtree(out, ignore_errors=True)
    csrc = ROOT / "deeplearning4j_tpu_torch" / "ops" / "csrc"
    running = {}
    for name, patches in variants.items():
        d = out / name
        d.mkdir(parents=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, d)
        src = (csrc / source).read_text()
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"variant {name}: the source no longer has "
                                 f"{old!r}")
            src = src.replace(old, new, 1)
        (d / source).write_text(src)
        log = open(d / "log.txt", "w")
        running[name] = (d, log, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / source)], stdout=log, stderr=subprocess.STDOUT))
    built = {}
    for name, (d, log, proc) in running.items():
        proc.wait()
        log.close()
        text = (d / "log.txt").read_text()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{text}")
        built[name] = (d / "lib.so", text)
    return built


# the bf16 D=64 instantiations of K4 and K5 with outputs in the input type
BWD_KERNELS = {label: rf"flash_bwd_{kernel}_hopper_kernel"
                      r"I13__nv_bfloat16S\d*_Li64E"
               for label, kernel in (("K4", "dq"), ("K5", "dkv"))}


def ptxas_report(log, kernels):
    """{label: {registers, spill_store_bytes, wgmma_serialized}} for each
    kernel of `kernels` ({label: regex of its mangled name})."""
    fields = (("registers", r"Used (\d+) registers"),
              ("spill_store_bytes", r"(\d+) bytes spill stores"))
    report = {}
    for label, pattern in kernels.items():
        entry = report[label] = {"wgmma_serialized": False}
        current = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = line.split("'")[1]
            elif current and re.search(pattern, current):
                for key, field in fields:
                    found = re.search(field, line)
                    if found:
                        entry[key] = int(found.group(1))
        notes = [f"{code}: {why}" for code, why, name in re.findall(
            r"\((C75\d\d)\)[^\n]*?wgmma\.mma_async instructions are "
            r"serialized due to (.*?) (?:in|for) the function '(\S+)'", log)
            if re.search(pattern, name)]
        if notes:
            entry["wgmma_serialized"] = "; ".join(notes)
    return report


def in_turns(_build, fa, source, built, calls, iters=20, same=None):
    """Bind the wrappers to each variant's library of `source` in turns (the
    variants, then again in reverse), check that every call of `calls`
    ({label: fn returning tensors}) gives the first variant's tensors (bit
    for bit, or as `same(variant, got, first)` says), and time each call
    with CUDA events. Returns {variant: [turn: {label: ms}]}."""
    from chip_smoke import cuda_ms
    same = same or (lambda name, a, b: torch.equal(a, b))
    times, reference = {name: [] for name in built}, None
    for name in list(built) + list(built)[::-1]:
        fa._fns.clear()   # bind the wrappers to this variant's library
        _build._libs[source[:-3]] = ctypes.CDLL(str(built[name][0]))
        outs = [t for fn in calls.values() for t in fn()]
        torch.cuda.synchronize()
        reference = reference or outs
        if not all(same(name, a, b) for a, b in zip(outs, reference)):
            raise SystemExit(f"variant {name}'s outputs differ from "
                             f"variant {list(built)[0]}'s")
        times[name].append({label: cuda_ms(fn, iters=iters)
                            for label, fn in calls.items()})
    return times


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_bwd_ab.py needs one card", file=sys.stderr)
        return 1
    print(card_line())
    sys.path.insert(0, str(ROOT))
    from chip_smoke import strided_qkv
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    built = build(_build, SOURCE, VARIANTS, "bwd_ab")
    B, T, H, D = 4, 8192, 8, 64
    q, k, v = strided_qkv(B, T, H, D, torch.bfloat16, seed=11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, True)
    args = (q, k, v, do, lse, fa.attention_delta(o, do))

    times = in_turns(_build, fa, SOURCE, built, {
        "K4": lambda: (fa.flash_attention_bwd_dq(*args, True),),
        "K5": lambda: fa.flash_attention_bwd_dkv(*args, True)})
    result = {}
    for name, turns in times.items():
        runs = [(t["K4"], t["K5"]) for t in turns]
        k4 = sum(t[0] for t in runs) / len(runs)
        k5 = sum(t[1] for t in runs) / len(runs)
        result[name] = {"K4_ms": k4, "K5_ms": k5, "K4_plus_K5_ms": k4 + k5,
                        "runs": runs,
                        "ptxas": ptxas_report(built[name][1], BWD_KERNELS)}
        print(f"  {name}: K4 {k4:.4f} ms, K5 {k5:.4f} ms, K4+K5 "
              f"{k4 + k5:.4f} ms (runs {runs}); ptxas "
              f"{json.dumps(result[name]['ptxas'])}")
    print(json.dumps({"shape": f"B={B} T={T} H={H} D={D} bf16 causal",
                      "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
