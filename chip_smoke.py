"""Smoke run of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build every CUDA kernel from the sources in the checkout (nvcc);
  3. each kernel against its plain PyTorch version on the card: first one
     128-key tile of the Hopper forward kernel (B=1, H=1, T=128, D=64,
     bf16, non-causal), then its tile edges (T=1, 127, 129, 193, 257), then
     the main path's shape and edge shapes, with stated tolerances;
  4. the Hopper forward kernel's registers, spills and shared memory (from
     ptxas' log beside the library), its blocks per SM (the occupancy API),
     its HGMMA / UTMALDG / HMMA / WARPGROUP.DEPBAR instruction counts
     (cuobjdump, where the toolkit has it) and ptxas' note if it serialised
     the kernel's wgmma; K1 timed with CUDA events beside its plain
     version, one PyTorch library call computing the same function (a
     yardstick only: the port never calls it) and its bound on an H100 SXM;
  5. the main path at full width: the flash-attention TransformerLM
     (vocab 512, d_model 512, 8 heads, 4 layers, max_len 8192, bf16, random
     weights from a seed) runs one full causal forward at B=4, T=8192 and
     answers a few generate / generate_batch requests, with every kernel
     launch counter set to 0 just before and read just after; then K1 is
     timed at the re-encode shape of generate(use_cache=False) (B=1,
     T=1024), on the card from a torch.profiler trace;
  6. a small-depth f32 copy of the model (same seed) on the card, through
     the kernel, agrees with the same model on the CPU through the plain
     versions; its greedy flash re-encode tokens equal its dense KV-cache
     tokens;
  7. the training kernels (K2 forward with logsumexp, K4 backward dQ, K5
     backward dK/dV) against their plain versions on the card: first single
     tiles of the Hopper kernels (B=1, H=1, T=64 and 128, D=64, bf16, both
     masks), then the tile edges (T=1, 63, 64, 65, 127, 128, 129, 191, 192,
     193, 257; both masks), then the training shape (B=4, T=8192, H=8, D=64,
     bf16, causal) and edge shapes, with stated tolerances;
  8. the kernel reports of K2, K4 and K5 as in phase 4 (the smoke fails
     unless each SASS has wgmma and TMA loads and no mma.sync); each
     training kernel timed with CUDA events beside its plain version, its
     bound and one PyTorch call (a yardstick only): the flash SDPA forward,
     which also returns the logsumexp, for K2; SDPA's backward alone (dq,
     dk, dv together; device time from a torch.profiler trace) for K4 and
     K5;
  9. the training main path at full width: the same TransformerLM
     (learning rate 0.1, momentum 0.9) takes 8 `fit_batch` steps at B=4,
     T=8192 on the shift task y = (x + 1) % 512, with every launch counter
     set to 0 just before and read just after: 4 launches each of K2, K4
     and K5 per step and none of K1; the losses are finite and fall;
 10. a small-depth f32 copy (same seed) trains three steps on the card
     (kernels) and on the CPU (plain versions); losses and parameters agree;
 11. the kernel reports of K3 (the Hopper forward kernel's third mode;
     bf16, D=64 and D=128) as in phase 4 (the smoke fails unless each SASS
     has wgmma and TMA loads and no mma.sync); the ring-attention partial
     (K3) against its plain version on the card: first single heads of 64
     and 128 rows (B=1, H=1, D=64, bf16, both masks), then the tile edges
     (T=1, 63, 64, 127, 128, 129, 191, 192, 193, 257, 385) on hops whose
     causal edge falls on and inside a tile, then the hop shape of T=8192
     over a ring of 4 (B=4, Tq=Tk=2048, H=8, D=64, bf16): the diagonal, a
     visible, a wholly masked and a non-causal hop, and edge shapes (ragged
     T=1025, fp16 D=128, f32);
 12. K4 and K5 with a hop's global offsets and f32 outputs against their
     plain versions on the same hops and edge shapes;
 13. K3, K4 and K5 (f32 outputs) timed on the visible hop beside their
     plain versions, their bounds and one PyTorch call: for K3 flash SDPA's
     forward (aten._scaled_dot_product_flash_attention, which returns o and
     the logsumexp), for K4+K5 SDPA's backward alone (device time, as in
     phase 8); K3 and its yardstick (causal) also on the diagonal hop, and
     K3 on both hops on the card from a torch.profiler trace;
 14. the ring main path at full width: four rank processes on one card
     (cuda:0), rotating K/V through the host over gloo, run
     `ring_self_attention(causal=True, use_flash=True)` on the global B=4,
     T=8192, H=8, D=64 bf16 input, each on its 2048-token chunk, with every
     launch counter set to 0 just before and read just after: (a) without
     grad, 4 launches of K3 per rank; (b) with grad (loss mean(o**2)), 4 of
     K3 and 4 each of K4 and K5 per rank; never K1 or K2. The gathered
     output agrees with the single-card flash attention (K2); the ring's
     gradients and the single card's (K2, K4, K5) each agree with the f32
     plain gradient, within limits that the same gradient from an o one
     bit coarser than bf16 fails; an f32 ring (T=1024) on the card agrees
     with the same ring on the CPU.
     With four cards it runs again over NCCL, one rank per card; with fewer
     it says that it skipped that step.
Phases 15-18 drive the DL4J training core (MultiLayerNetwork,
ComputationGraph, the model zips), whose path reaches none of the port's
kernels: cuDNN and cuBLAS run it, as XLA runs it for the JAX package. The
launch counters are set to 0 before them and must read 0 after. They run
with PyTorch's default `cudnn.allow_tf32 = True`: the port turns TF32 off
for its float32 networks inside its own calls.
 15. LeNet (MultiLayerNetwork, f32, batch 64, seeded weights): `output` and
     three Nesterov `fit` steps on the card and on the CPU; losses and
     parameters agree;
 16. ResNet-50 (ComputationGraph) at full depth, 64x64x3, batch 2, 10
     classes, f32: `output` and the first training loss, card against CPU
     (and, as controls that must break the limits, both with TF32 on);
     then two `fit` steps on the card, on the CPU and in float64 on
     the CPU: the card's parameter change is no more than twice as far
     (relative L2) from float64's as the CPU's f32 is (at batch 2 this
     deep BatchNorm net is ill-conditioned in f32: ~5%);
 17. ResNet-50 at full width: `resnet50(data_type="bfloat16")`, batch 128,
     224x224x3, 1000 classes, Nesterov lr 0.1, momentum 0.9, one repeated
     random batch on the card (as the JAX package's bench.py): 24 warm-up
     steps (cuDNN's algorithm search runs there, and the loss's early rise
     and fall; the last one is audited: every op of the step on the card),
     then 8 `fit` steps timed by CUDA events: finite losses, the last
     below the first, step ms, images/s
     and peak memory; f32 master parameters on the card; a timed `output`
     at batch 128; the device time of one step by kernel, from a
     torch.profiler trace;
 18. the golden model zips (tests/fixtures/golden/{mlp,lenet,cg}.zip)
     restored on the card: parameters equal, outputs as the zips' io["y"].
Then it prints a {"training_core": ...} JSON line, one {"kernels": [...]}
JSON line and, as the last line, {"ok": true, "device": {...}}. It imports
nothing of JAX.
"""
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from datetime import timedelta
from functools import partial
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16/fp16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FULL = dict(vocab_size=512, d_model=512, n_heads=8, n_layers=4,
            max_len=8192, seed=0, attention="flash")
B, T = 4, 8192
TRAIN_STEPS = 8
LSE_ATOL = 1e-5   # read 1.9e-6 (bf16, T=8192) on an H100
RING = 4          # ranks of the ring main path (phase 14)
HOP_T = T // RING
RING_GROUP_TIMEOUT_S, RING_JOIN_TIMEOUT_S = 60, 300
# Phase 14: (least atol at rtol 1e-2, max row err) of dq, dk, dv of
# mean(o**2) against the f32 gradient, in units of its rms. Each is 1.5x
# what the single card (K2, K4, K5) and the ring both read on an H100
# (dq 0.4304, 1.509e-2; dk 0.3091, 1.014e-2; dv 0.0707, 2.630e-3); the
# same gradient from an o rounded to 7 significant bits reads dq 1.590,
# dk 1.077 and 2.14e-2, dv 0.1335, over each.
GRAD_LIMITS = {"dq": (0.65, 0.023), "dk": (0.47, 0.016),
               "dv": (0.11, 0.004)}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names, iters=100):
    """Mean device time in ms of each kernel whose name holds one of
    `names`, from a torch.profiler trace of `iters` calls of fn after one
    warm-up; None for a kernel that the trace shows no device time for."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = []
    for name in names:
        events = [e for e in prof.key_averages() if name in e.key]
        total_us = sum(e.device_time_total for e in events)
        count = sum(e.count for e in events)
        times.append(total_us / 1e3 / count if total_us and count else None)
    return times


def strided_qkv(b, t, h, d, dtype, seed):
    """q, k, v as the model makes them: [B, T, H, d] views into one
    [B, T, 3*H*d] projection."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda").to(dtype)
    return [a.reshape(b, t, h, d) for a in qkv.split(h * d, -1)]


def flash_plain(fa, q, k, v, causal, scale=None):
    """The plain version one batch row at a time: at T=8192 its f32 scores
    take 2.1 GB per row."""
    return torch.cat([fa.flash_attention_reference(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], causal, scale)
        for i in range(q.shape[0])])


def compare(label, got, want, atol, rtol, row_rtol, row_floor=0.0):
    """Element-wise |err| <= atol + rtol*|plain|, and per row (last axis:
    one query or key, one head) ||err|| <= row_rtol*||plain|| + row_floor:
    most outputs are far smaller than 1, so the row check is the one that
    sees an error of a few percent (e.g. padded keys of a ragged tile left
    unmasked). The printed row error is ||err|| / (||plain|| +
    row_floor/row_rtol). Returns the max abs error."""
    diff = got.float() - want.float()
    err = diff.abs()
    max_abs = err.max().item()
    row_err, row_norm = diff.norm(dim=-1), want.float().norm(dim=-1)
    row_rel = (row_err / (row_norm + row_floor / row_rtol).clamp_min(1e-30)
               ).max().item()
    ok = (bool(torch.isfinite(got).all())
          and not (err > atol + rtol * want.float().abs()).any()
          and row_rel <= row_rtol)
    print(f"  {label}: max_abs_err {max_abs:.3e} "
          f"(|err| <= {atol:g} + {rtol:g}*|plain|), max row rel err "
          f"{row_rel:.3e} (<= {row_rtol:g}"
          f"{f', floor {row_floor:g}' if row_floor else ''}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel disagrees with its plain version ({label})")
    return max_abs


def check_flash(fa, label, q, k, v, causal, scale, atol, rtol, row_rtol):
    out = fa.flash_attention(q, k, v, causal, scale)
    want = flash_plain(fa, q, k, v, causal, scale)
    torch.cuda.synchronize()
    return compare(f"flash {label}", out, want, atol, rtol, row_rtol)


def per_row(fn, *args):
    """fn over one batch row at a time, results concatenated: the plain
    versions hold [H, T, T] f32 panels, 2.1 GB each at T=8192."""
    outs = [fn(*(a[i:i + 1] for a in args)) for i in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def shown_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time an H100 SXM takes."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def hopper_report(_build, label, library, kernel, occupancy):
    """What ptxas, the occupancy API and the SASS say of one Hopper kernel:
    registers, spills and static shared memory from the build log of
    `library`, resident blocks per SM, threads and dynamic shared memory per
    block (`occupancy`, a C entry's arguments before its two out-pointers),
    the count of wgmma (HGMMA), TMA load (UTMALDG), mma.sync (HMMA) and
    wgmma wait (WARPGROUP.DEPBAR) instructions in its SASS where the toolkit
    has cuobjdump, and ptxas' notes when it serialised the kernel's wgmma
    (as many waits as wgmma). `kernel` is a
    regex that picks the instantiation's mangled name. Fails unless the SASS
    has wgmma and TMA loads and no mma.sync. Returns the report as a dict and
    prints it."""
    import ctypes

    def ours(name):
        return re.search(kernel, name) is not None

    fields = {"registers": r"Used (\d+) registers",
              "spill_store_bytes": r"(\d+) bytes spill stores",
              "spill_load_bytes": r"(\d+) bytes spill loads",
              "static_smem_bytes": r"(\d+) bytes smem"}
    report, current = {}, None
    log = _build.log_path(library).read_text()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
        elif current and ours(current):
            for key, pattern in fields.items():
                found = re.search(pattern, line)
                if found:
                    report[key] = int(found.group(1))
    # ptxas' notes where it had to wait after every wgmma of the kernel
    # (C7515: accumulators written in flight; C7512: too few registers)
    notes = [f"{code}: {why}" for code, why, name in re.findall(
        r"\((C75\d\d)\)[^\n]*?wgmma\.mma_async instructions are serialized "
        r"due to (.*?) (?:in|for) the function '(\S+)'", log) if ours(name)]
    if notes:
        report["wgmma_serialized"] = "; ".join(notes)
    symbol, *args = occupancy
    fn = getattr(_build.load(library), symbol)
    fn.argtypes = ([ctypes.c_int] * len(args)
                   + [ctypes.POINTER(ctypes.c_int)] * 2)
    threads, smem = ctypes.c_int(), ctypes.c_int()
    report["blocks_per_sm"] = fn(*args, ctypes.byref(threads),
                                 ctypes.byref(smem))
    report["threads"], report["dynamic_smem_bytes"] = threads.value, smem.value
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(library))],
            capture_output=True, text=True, timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            if ours(part.split("\n", 1)[0]):
                report["sass_HGMMA"] = part.count("HGMMA")
                report["sass_UTMALDG"] = part.count("UTMALDG")
                report["sass_HMMA"] = part.count("HMMA.")
                report["sass_WARPGROUP_DEPBAR"] = part.count(
                    "WARPGROUP.DEPBAR")
    else:
        report["sass"] = "cuobjdump not found"
    print(f"  Hopper kernel {label}: {json.dumps(report)}")
    if "registers" not in report or (
            "sass" not in report and "sass_HGMMA" not in report):
        raise SystemExit(f"no kernel matching {kernel} in the build log or "
                         f"the SASS of {library}")
    if (report.get("sass_HGMMA") == 0 or report.get("sass_UTMALDG") == 0
            or report.get("sass_HMMA", 0) > 0):
        raise SystemExit(f"the Hopper kernel {label}'s SASS lacks wgmma or "
                         f"TMA loads, or has mma.sync")
    return report


def fwd_report(fa, _build, mode, d=64):
    """`hopper_report` of the Hopper forward kernel in `mode` (0: K1, 1: K2,
    2: K3, the source's `Mode`), bf16, head dim d."""
    return hopper_report(
        _build, f"K{mode + 1} bf16 D={d}", "flash_attention_fwd",
        rf"flash_fwd_hopper_kernelI13__nv_bfloat16Li{d}ELi{mode}E",
        ("dl4j_flash_fwd_occupancy", fa._DTYPE_CODE[torch.bfloat16], d,
         mode))


def bwd_report(fa, _build, dq):
    """`hopper_report` of K4's (dq True) or K5's Hopper kernel, bf16, D=64,
    outputs in bf16 (the mangled name repeats the type as a substitution)."""
    return hopper_report(
        _build, f"{'K4' if dq else 'K5'} bf16 D=64", "flash_attention_bwd",
        rf"flash_bwd_{'dq' if dq else 'dkv'}_hopper_kernel"
        r"I13__nv_bfloat16S\d*_Li64E",
        ("dl4j_flash_bwd_occupancy", fa._DTYPE_CODE[torch.bfloat16], 64,
         int(dq)))


def sdpa_backward_ms(q, k, v, do, causal, iters=20):
    """Device time in ms of SDPA's flash backward alone (dq, dk, dv together)
    on [B, T, H, D] inputs, from a torch.profiler trace of `iters` forwards
    and backwards: every kernel in the trace but the forward's (flash_fwd).
    Returns (ms or None where the trace shows no device time, {kernel: ms per
    call}). A yardstick only: the port never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    gt = do.transpose(1, 2).contiguous()

    def step():
        torch.autograd.grad(sdpa(qt, kt, vt, is_causal=causal), (qt, kt, vt),
                            gt)

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
    per_call = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:   # by kernel name, template arguments cut
            name = re.sub(r"<.*", "", e.key)
            per_call[name] = (per_call.get(name, 0.0)
                              + e.device_time_total / 1e3 / iters)
    bwd = {name: t for name, t in per_call.items() if "flash_fwd" not in name}
    if not bwd or len(bwd) == len(per_call):   # no trace, or no forward seen
        return None, per_call
    return sum(bwd.values()), bwd


def check_training_kernels(fa, label, b, t, h, d, dtype, causal, tol, seed):
    """K2 (o, lse), K4 (dq) and K5 (dk, dv) against their plain versions on
    the same inputs; the backward takes K2's o and lse as residuals.
    Returns (inputs, {kernel: max abs err})."""
    q, k, v = strided_qkv(b, t, h, d, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
    want_o, want_lse = per_row(
        partial(fa.flash_attention_lse_reference, causal=causal), q, k, v)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    dq = fa.flash_attention_bwd_dq(*args, causal)
    dk, dv = fa.flash_attention_bwd_dkv(*args, causal)
    want_dq = per_row(
        partial(fa.flash_attention_bwd_dq_reference, causal=causal), *args)
    want_dk, want_dv = per_row(
        partial(fa.flash_attention_bwd_dkv_reference, causal=causal), *args)
    torch.cuda.synchronize()
    atol, rtol, row_rtol = tol
    errs = {"fwd_lse": compare(f"K2 o   {label}", o, want_o, atol, rtol,
                               row_rtol)}
    lse_err = (lse - want_lse).abs().max().item()
    # lse: f32 max and sum of the same f32 scores, summed in another order
    lse_ok = bool(torch.isfinite(lse).all()) and lse_err <= LSE_ATOL
    print(f"  K2 lse {label}: max_abs_err {lse_err:.3e} (<= {LSE_ATOL:g}) "
          f"{'ok' if lse_ok else 'FAIL'}")
    if not lse_ok:
        raise SystemExit(f"K2 lse disagrees with its plain version ({label})")
    errs["lse"] = lse_err
    # gradient rows can be ~0 (dS = p(dP - delta) is a difference of two
    # near-equal sums), so the row bound has a floor of atol
    errs["bwd_dq"] = compare(f"K4 dq  {label}", dq, want_dq, atol, rtol,
                             row_rtol, atol)
    errs["bwd_dkv"] = max(
        compare(f"K5 dk  {label}", dk, want_dk, atol, rtol, row_rtol, atol),
        compare(f"K5 dv  {label}", dv, want_dv, atol, rtol, row_rtol, atol))
    return args, errs


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 1
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # f32 results are compared in f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    print("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    print("phase 3: kernels against their plain versions on the card")
    H, D = FULL["n_heads"], FULL["d_model"] // FULL["n_heads"]
    q, k, v = strided_qkv(B, T, H, D, torch.bfloat16, seed=1)
    # bf16/fp16, element-wise: one step of the output type (relative 2^-7 /
    # 2^-10) can flip between two roundings of nearly equal f32 sums. Per
    # row: the kernel rounds p = exp(s - running max) to the input type
    # where the plain version rounds exp(s - row max), so each p differs by
    # up to one rounding (2^-8 / 2^-11 relative); with the output's own
    # rounding that keeps a row within ~0.5% / ~0.07% of the plain row.
    # T=1000 and T=1025 leave 24 and 63 padded keys in the last kv tile.
    bf16_tol = dict(atol=1e-2, rtol=1e-2, row_rtol=1e-2)
    fp16_tol = dict(atol=2e-3, rtol=2e-3, row_rtol=2e-3)
    # one 128-key tile of the Hopper kernel first, then the tile edges: one
    # row, a key tile (128) less or more one row, a query tile (192 rows at
    # D=64) and one more, two key tiles and one
    check_flash(fa, "single tile B=1 T=128 H=1 D=64 bf16 full",
                *strided_qkv(1, 128, 1, 64, torch.bfloat16, seed=20),
                False, None, **bf16_tol)
    for t in (1, 127, 129, 193, 257):
        check_flash(fa, f"tile edge B=1 T={t} H=8 D=64 bf16 causal",
                    *strided_qkv(1, t, 8, 64, torch.bfloat16, seed=20 + t),
                    True, None, **bf16_tol)
    err_main = check_flash(fa, f"B={B} T={T} H={H} D={D} bf16 causal",
                           q, k, v, True, None, **bf16_tol)
    check_flash(fa, "B=2 T=1025 H=8 D=64 bf16 full",
                *strided_qkv(2, 1025, 8, 64, torch.bfloat16, seed=6),
                False, None, **bf16_tol)
    check_flash(fa, "B=2 T=1000 H=8 D=64 bf16 full scale=0.05",
                *strided_qkv(2, 1000, 8, 64, torch.bfloat16, seed=2),
                False, 0.05, **bf16_tol)
    check_flash(fa, "B=2 T=1000 H=8 D=128 fp16 causal",
                *strided_qkv(2, 1000, 8, 128, torch.float16, seed=3),
                True, None, **fp16_tol)
    # f32: the kernel's FMA order against cuBLAS's f32 products
    check_flash(fa, "B=2 T=300 H=4 D=64 f32 causal",
                *strided_qkv(2, 300, 4, 64, torch.float32, seed=4),
                True, None, atol=1e-5, rtol=1e-5, row_rtol=1e-5)

    print("phase 4: timing at the main path's shape")
    k1_report = fwd_report(fa, _build, 0)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True), iters=20)
    plain_ms = cuda_ms(lambda: flash_plain(fa, q, k, v, True), iters=2,
                       warmup=1)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=20)
    flops = 4 * B * H * D * T * (T + 1) / 2       # causal: keys <= row
    nbytes = 4 * B * T * H * D * q.element_size()  # q, k, v read; o written
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  flash kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"roofline share {bound_ms / ms:.3f}, "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    del q, k, v, qt, kt, vt

    print("phase 5: main path at full width (bf16)")
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, device="cuda")
    tokens = torch.randint(0, FULL["vocab_size"], (B, T),
                           generator=torch.Generator().manual_seed(5)).cuda()
    fa.reset_launches()
    t0 = time.perf_counter()
    logits = lm.logits(tokens)
    torch.cuda.synchronize()
    logits_ms = 1e3 * (time.perf_counter() - t0)
    n_logits = fa.launches["fwd"]
    if n_logits != FULL["n_layers"]:
        raise SystemExit(f"logits launched the flash kernel {n_logits} "
                         f"times, not {FULL['n_layers']}")
    if (logits.shape != (B, T, FULL["vocab_size"])
            or logits.dtype != torch.bfloat16
            or not bool(torch.isfinite(logits).all())):
        raise SystemExit(f"bad logits {tuple(logits.shape)} {logits.dtype}")
    del logits
    print(f"  logits [{B}, {T}]: first call {logits_ms:.1f} ms wall, "
          f"{n_logits} flash launches")

    prompt = tokens[0, :1024].tolist()
    requests = [
        ("generate(use_cache=False)", lambda: lm.generate(prompt, 8)),
        ("generate(use_cache=True)",
         lambda: lm.generate(prompt, 8, use_cache=True)),
        ("generate_batch", lambda: lm.generate_batch(tokens[:, :1024], 8)),
    ]
    for name, call in requests:
        before = fa.launches["fwd"]
        t0 = time.perf_counter()
        out = call()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = out if name == "generate_batch" else [out]
        new = [list(map(int, r[1024:])) for r in rows]
        if any(len(n) != 8 or not all(0 <= t < FULL["vocab_size"]
                                      for t in n) for n in new):
            raise SystemExit(f"{name} returned bad tokens {new}")
        added = fa.launches["fwd"] - before
        want = 8 * FULL["n_layers"] if name.endswith("False)") else 0
        if added != want:
            raise SystemExit(f"{name} launched the flash kernel {added} "
                             f"times, not {want}")
        print(f"  {name}: prompt 1024 -> 8 new tokens {new} in "
              f"{wall_ms:.1f} ms wall, {added} flash launches")
    main_launches = fa.launches["fwd"]    # read before the timing below
    if fa.launches != {"fwd": main_launches, "fwd_lse": 0, "partial": 0,
                       "bwd_dq": 0, "bwd_dkv": 0}:
        raise SystemExit(f"serving launched other kernels: {fa.launches}")
    warm_ms = cuda_ms(lambda: lm.logits(tokens), iters=3, warmup=1)
    print(f"  main path: {main_launches} flash launches; warm logits "
          f"[{B}, {T}] {warm_ms:.2f} ms ({B * T / warm_ms:.0f} tokens/ms), "
          f"of which flash {FULL['n_layers']} x {ms:.3f} ms = "
          f"{FULL['n_layers'] * ms / warm_ms:.1%}")
    # the re-encode of generate(use_cache=False): one K1 call at B=1 over
    # the prompt and its new tokens (8 heads x 6 query tiles at T=1024). At
    # this size CUDA events time the host's launches as much as the card,
    # so the device time comes from a trace.
    rq, rk, rv = strided_qkv(1, 1024, H, D, torch.bfloat16, seed=9)
    reencode = {"ms": cuda_ms(lambda: fa.flash_attention(rq, rk, rv, True),
                              iters=50)}
    reencode["device_ms"], = device_ms(
        lambda: fa.flash_attention(rq, rk, rv, True),
        ("flash_fwd_hopper_kernel",))
    print(f"  K1 at the re-encode shape B=1 T=1024 H={H} D={D}: "
          f"{shown_ms(reencode['ms'])} by CUDA events, "
          f"{shown_ms(reencode['device_ms'])} on the card (trace)")
    del lm, rq, rk, rv

    print("phase 6: same weights, f32, card (kernel) vs CPU (plain)")
    small = dict(FULL, n_layers=1, dtype=torch.float32)
    gpu = TransformerLM(**small, device="cuda")
    cpu = TransformerLM(**small, device="cpu")
    for (name, a), (_, b) in zip(gpu.state_dict().items(),
                                 cpu.state_dict().items()):
        if not torch.equal(a.cpu(), b):
            raise SystemExit(f"weights differ between devices: {name}")
    x = tokens[:2, :512]
    err = (gpu.logits(x).cpu() - cpu.logits(x)).abs().max().item()
    # 1e-4: cuBLAS and the CPU sum the width-512 and width-2048 products in
    # another order; logits are O(1)
    print(f"  logits [2, 512] max_abs_err {err:.3e} (tolerance 1e-4)")
    if not err <= 1e-4:
        raise SystemExit("card and CPU logits disagree")
    flash_toks = gpu.generate(prompt[:64], 8, use_cache=False)
    dense_toks = gpu.generate(prompt[:64], 8, use_cache=True)
    print(f"  greedy flash re-encode {flash_toks[64:]} == dense KV cache "
          f"{dense_toks[64:]}: {flash_toks == dense_toks}")
    if flash_toks != dense_toks:
        raise SystemExit("flash and dense greedy tokens differ")

    del gpu, cpu
    train = training_phases(fa, _build, TransformerLM, H, D)
    ring = ring_phases(fa, _build, H, D)
    core = training_core_phases(fa)

    shape = f"B={B} T={T} H={H} D={D} bf16 causal"
    src = "deeplearning4j_tpu_torch/ops/csrc/"
    ref = "deeplearning4j_tpu/ops/flash_attention.py:"
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": src + "flash_attention_fwd.cu", "replaces": ref + "108",
        "launches": main_launches, "max_abs_err": err_main, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "shape": shape, "kernel": k1_report,
        "reencode": dict(reencode,
                         shape=f"B=1 T=1024 H={H} D={D} bf16 causal")}]
    for name, source, line in (
            ("fwd_lse", "flash_attention_fwd.cu", "122"),
            ("bwd_dq", "flash_attention_bwd.cu", "298"),
            ("bwd_dkv", "flash_attention_bwd.cu", "344")):
        kernels.append(dict({
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": src + source, "replaces": ref + line,
            "launches": train["launches"][name]}, **train["kernels"][name],
            shape=shape, **ring["extra"].get(name, {})))
    kernels.insert(2, dict({
        "name": "flash_attention_partial", "route": "cuda",
        "source": src + "flash_attention_fwd.cu", "replaces": ref + "203"},
        **ring["partial"]))
    print(json.dumps({"training_core": core}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def training_phases(fa, _build, TransformerLM, H, D):
    """Phases 7-10. Returns {"launches": {kernel: main-path count},
    "kernels": {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, ...}}}."""
    print("phase 7: training kernels against their plain versions")
    # bf16/fp16 element-wise and per row as for K1 (one step of the output
    # type may flip; p and ds are rounded from f32 values that the kernel
    # and cuBLAS sum in another order)
    bf16_tol, fp16_tol = (1e-2, 1e-2, 1e-2), (2e-3, 2e-3, 2e-3)
    # single tiles first: one 128-key tile of K2's Hopper kernel; K4's own
    # 128-query tile against one or two 64-key halves of its first kv tile,
    # K5's 128-key tile against one or two 64-query tiles, both masks. Then
    # the tile edges: one row, a tile of 64 and of 128 rows less or more one,
    # three tiles of 64 and one more, four and one more.
    for t in (64, 128):
        for causal in (False, True):
            check_training_kernels(
                fa, f"single tile B=1 T={t} H=1 D=64 bf16 "
                f"{'causal' if causal else 'full'}", 1, t, 1, 64,
                torch.bfloat16, causal, bf16_tol, seed=20 + t + causal)
    for t in (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 257):
        for causal in (True, False):
            check_training_kernels(
                fa, f"tile edge B=1 T={t} H=8 D=64 bf16 "
                f"{'causal' if causal else 'full'}", 1, t, 8, 64,
                torch.bfloat16, causal, bf16_tol, seed=300 + t + causal)
    args, errs = check_training_kernels(
        fa, f"B={B} T={T} H={H} D={D} bf16 causal", B, T, H, D,
        torch.bfloat16, True, bf16_tol, seed=11)
    # T=1025: 63 padded keys and 63 padded queries in the last tiles
    check_training_kernels(fa, "B=2 T=1025 H=8 D=64 bf16 full", 2, 1025, 8,
                           64, torch.bfloat16, False, bf16_tol, seed=12)
    check_training_kernels(fa, "B=2 T=1000 H=8 D=128 fp16 causal", 2, 1000,
                           8, 128, torch.float16, True, fp16_tol, seed=13)
    check_training_kernels(fa, "B=2 T=300 H=4 D=64 f32 causal", 2, 300, 4,
                           64, torch.float32, True, (1e-5, 1e-5, 1e-5),
                           seed=14)

    print("phase 8: training kernels timed at the training shape")
    reports = {"fwd_lse": fwd_report(fa, _build, 1),
               "bwd_dq": bwd_report(fa, _build, True),
               "bwd_dkv": bwd_report(fa, _build, False)}
    q, k, v, do, lse, delta = args
    calls = {  # kernel wrapper, plain version, inputs
        "fwd_lse": (fa.flash_attention_fwd_lse,
                    fa.flash_attention_lse_reference, (q, k, v)),
        "bwd_dq": (fa.flash_attention_bwd_dq,
                   fa.flash_attention_bwd_dq_reference, args),
        "bwd_dkv": (fa.flash_attention_bwd_dkv,
                    fa.flash_attention_bwd_dkv_reference, args),
    }
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        # with inputs that need grad, flash SDPA also returns the logsumexp
        lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=20)
    lib_bwd, lib_bwd_kernels = sdpa_backward_ms(q, k, v, do, True)
    pairs = B * H * T * (T + 1) / 2            # causal (query, key) pairs
    panel = B * T * H * D * q.element_size()   # one [B, T, H, D] tensor
    row_stats = B * H * T * 4                  # one f32 [B, H, T] tensor
    work = {  # (FLOP, bytes: each input read once, each output written once)
        "fwd_lse": (4 * D * pairs, 4 * panel + row_stats),
        "bwd_dq": (6 * D * pairs, 5 * panel + 2 * row_stats),
        "bwd_dkv": (8 * D * pairs, 6 * panel + 2 * row_stats),
    }
    library = {"fwd_lse": lib_fwd, "bwd_dq": lib_bwd, "bwd_dkv": lib_bwd}
    kernels = {}
    for name, (kernel_fn, plain_fn, inputs) in calls.items():
        k_ms = cuda_ms(lambda: kernel_fn(*inputs, True), iters=10)
        p_ms = cuda_ms(lambda: per_row(partial(plain_fn, causal=True),
                                       *inputs), iters=2, warmup=1)
        b_ms, b_by = bound(*work[name])
        kernels[name] = {"max_abs_err": errs[name], "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": library[name], "kernel": reports[name]}
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"library {shown_ms(library[name])}, bound {b_ms:.4f} ms "
              f"({b_by}), roofline share {b_ms / k_ms:.3f}, "
              f"{work[name][0] / k_ms / 1e9:.1f} TFLOP/s")
    kernels["fwd_lse"]["lse_max_abs_err"] = errs["lse"]
    for name in ("bwd_dq", "bwd_dkv"):
        kernels[name]["library_call"] = (
            "SDPA flash backward alone, dq/dk/dv together (device time, "
            "torch.profiler)")
    print(f"  SDPA flash: forward {lib_fwd:.4f} ms (CUDA events); backward "
          f"{shown_ms(lib_bwd)} on the card (trace: "
          f"{json.dumps(lib_bwd_kernels)})")
    del args, q, k, v, do, lse, delta, qt, kt, vt

    print(f"phase 9: training main path at full width (bf16, "
          f"{TRAIN_STEPS} fit_batch steps)")
    lm = TransformerLM(**FULL, dtype=torch.bfloat16, learning_rate=0.1,
                       momentum=0.9, device="cuda")
    x = torch.randint(0, FULL["vocab_size"], (B, T),
                      generator=torch.Generator().manual_seed(7)).cuda()
    y = (x + 1) % FULL["vocab_size"]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(lm.fit_batch(x, y))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    launches = dict(fa.launches)
    n = FULL["n_layers"] * TRAIN_STEPS
    if launches != {"fwd": 0, "fwd_lse": n, "partial": 0, "bwd_dq": n,
                    "bwd_dkv": n}:
        raise SystemExit(f"fit_batch launches {launches}: want {n} each of "
                         f"K2, K4, K5 and no K1 or K3")
    warm_ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    print(f"  losses {losses}")
    print(f"  step ms (CUDA events) {[round(t, 2) for t in step_ms]}; warm "
          f"mean {warm_ms:.2f} ms, {B * T / warm_ms * 1e3:.0f} tokens/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}")
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise SystemExit(f"training losses not finite and falling: {losses}")
    del lm

    print("phase 10: same weights, f32, three steps: card (kernels) vs CPU "
          "(plain)")
    small = dict(FULL, n_layers=1, dtype=torch.float32)
    gpu = TransformerLM(**small, device="cuda")
    cpu = TransformerLM(**small, device="cpu")
    xs, ys = x[:2, :512], y[:2, :512]
    got = [gpu.fit_batch(xs, ys) for _ in range(3)]
    want = [cpu.fit_batch(xs.cpu(), ys.cpu()) for _ in range(3)]
    loss_err = max(abs(a - b) for a, b in zip(got, want))
    param_err = max((a.detach().cpu() - b.detach()).abs().max().item()
                    for a, b in zip(gpu.parameters(), cpu.parameters()))
    # 1e-5: cuBLAS and the CPU sum the 512- and 2048-wide products in
    # another order, and each update carries the difference on (read on an
    # H100: 4.8e-7, one f32 step of the loss, and 1.2e-7)
    print(f"  losses card {got} cpu {want}: max abs diff {loss_err:.3e}; "
          f"parameters max abs diff {param_err:.3e} (tolerance 1e-5 each)")
    if not (loss_err <= 1e-5 and param_err <= 1e-5):
        raise SystemExit("card and CPU training disagree")
    return {"launches": launches, "kernels": kernels}


def check_partial(fa, label, q, k, v, q_off, k_off, causal, tol):
    """K3 (acc, m, l) against its plain version. acc is held after dividing
    both by the plain l, which puts it on the output's scale, where K1's
    bounds (phase 3) apply; a row that sees no key of the hop (l = 0) must
    have exactly acc 0, m -1e30, l 0. Returns (max abs err of acc / l,
    (acc, m, l))."""
    got = fa.flash_attention_partial(q, k, v, q_off, k_off, causal)
    want = per_row(partial(fa.flash_attention_partial_reference, q_off=q_off,
                           k_off=k_off, causal=causal), q, k, v)
    torch.cuda.synchronize()
    (acc, m, l), (w_acc, w_m, w_l) = got, want
    norm = w_l.clamp_min(1e-30).transpose(1, 2)[..., None]
    err = compare(f"K3 acc/l {label}", acc / norm, w_acc / norm, *tol)
    # m: the max of the same f32 scores, summed in another order (K2's lse
    # reads 1.9e-6 at T=8192). l: f32 sums of up to T p's in another order,
    # each p carrying expf's error and one rescale per kv tile.
    m_err = (m - w_m).abs().max().item()
    l_rel = ((l - w_l).abs() / w_l.clamp_min(1e-30)).max().item()
    unseen = w_l == 0
    exact = bool((m[unseen] == fa.FINITE_NEG).all() and (l[unseen] == 0).all()
                 and not acc.transpose(1, 2)[unseen].any())
    ok = (m_err <= 1e-5 and l_rel <= 1e-4 and exact
          and bool(torch.isfinite(m).all() and torch.isfinite(l).all()))
    print(f"  K3 m, l {label}: m max_abs_err {m_err:.3e} (<= 1e-5), l max "
          f"rel err {l_rel:.3e} (<= 1e-4), {int(unseen.sum())} rows that see "
          f"no key exactly (0, -1e30, 0): {exact} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K3 m/l disagree with the plain version ({label})")
    return err, want


def check_hop_backward(fa, label, q, k, v, q_off, k_off, causal, tol, seed,
                       fwd):
    """K4 (dq) and K5 (dk, dv) with the hop's offsets and f32 outputs against
    their plain versions. lse and delta come from the plain partial `fwd`
    of the same hop, so every row with a visible key has its exact softmax.
    Returns ((q, k, v, delta, do, lse), {kernel: max abs err})."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    acc, m, l = fwd
    lc = l.clamp_min(1e-30)
    lse = m + torch.log(lc)
    delta = fa.attention_delta((acc / lc.transpose(1, 2)[..., None]).to(
        q.dtype), do)
    dq, dk, dv = fa.flash_attention_bwd_partial(q, k, v, delta, do, lse,
                                                q_off, k_off, causal)
    kw = dict(causal=causal, q_off=q_off, k_off=k_off,
              out_dtype=torch.float32)
    args = (q, k, v, do, lse, delta)
    want_dq = per_row(partial(fa.flash_attention_bwd_dq_reference, **kw),
                      *args)
    want_dk, want_dv = per_row(
        partial(fa.flash_attention_bwd_dkv_reference, **kw), *args)
    torch.cuda.synchronize()
    if causal and k_off >= q_off + q.shape[1] and (
            dq.any() or dk.any() or dv.any()):
        raise SystemExit(f"K4/K5 wrote a gradient for a wholly masked hop "
                         f"({label})")
    errs = {"bwd_dq": compare(f"K4 dq f32  {label}", dq, want_dq, *tol,
                              tol[0])}
    errs["bwd_dkv"] = max(
        compare(f"K5 dk f32  {label}", dk, want_dk, *tol, tol[0]),
        compare(f"K5 dv f32  {label}", dv, want_dv, *tol, tol[0]))
    return (q, k, v, delta, do, lse), errs


def ring_qkv(b, t, h, d, dtype, seed, device="cuda"):
    """The ring's global q, k, v, [B, T, H, D] contiguous, from a seed; the
    same on every process that asks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(3, b, t, h, d, generator=gen, device=device)
    return [a.to(dtype).contiguous() for a in qkv]


def ring_rank(rank, world, store, out_dir, backend, seed):
    """One rank of the ring main path (phase 14), started by spawn: join the
    group, run (a) and (b) on this rank's chunk with the counters set to 0
    before each and read after, time both warm, run the f32 case on the card
    and on the CPU, and save what the parent checks."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import ring_attention as ra
    ring_self_attention = ra.ring_self_attention
    device = rank if backend == "nccl" else 0
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=RING_GROUP_TIMEOUT_S))
    barrier = (partial(dist.barrier, device_ids=[device])
               if backend == "nccl" else dist.barrier)
    # the f32 case's CPU ring needs a group that carries CPU tensors
    cpu_group = dist.new_group(backend="gloo") if backend == "nccl" else None
    tq = T // world
    mine = slice(rank * tq, (rank + 1) * tq)
    q, k, v = (a[:, mine].contiguous() for a in ring_qkv(
        B, T, FULL["n_heads"], FULL["d_model"] // FULL["n_heads"],
        torch.bfloat16, seed))
    ring = partial(ring_self_attention, causal=True, use_flash=True)
    n_total = q.numel() * world

    def inference():
        with torch.no_grad():
            return ring(q, k, v)

    def training():
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        out = ring(*leaves)
        loss = (out.float() ** 2).sum() / n_total    # mean over the global o
        return out.detach(), torch.autograd.grad(loss, leaves)

    res = {}
    fa.reset_launches()
    res["out"] = inference()
    torch.cuda.synchronize()
    res["launches_inference"] = dict(fa.launches)
    fa.reset_launches()
    res["out_train"], res["grads"] = training()
    torch.cuda.synchronize()
    res["launches_training"] = dict(fa.launches)
    barrier()
    res["fwd_ms"] = cuda_ms(inference, iters=5, warmup=1)
    barrier()
    res["fwd_bwd_ms"] = cuda_ms(training, iters=3, warmup=1)
    # one rotation as the forward moves it (k, v) and as the backward does
    # (k, v and the f32 dk, dv accumulators)
    acc32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for key, payload in (("rotate_fwd_ms", (k, v)),
                         ("rotate_bwd_ms", (k, v, acc32, acc32))):
        barrier()
        res[key] = cuda_ms(lambda: ra._ppermute(payload, None), iters=5,
                           warmup=1)

    # f32, T=1024: the kernels on the card against the plain versions on the
    # CPU, through the same ring; loss sum(o**2)/2, so dO = o
    f32 = [a[:, rank * 256:(rank + 1) * 256].contiguous() for a in ring_qkv(
        2, 1024, 4, 64, torch.float32, seed + 1, "cpu")]
    f32_res = []
    for dev, group in (("cuda", None), ("cpu", cpu_group)):
        leaves = [a.to(dev).requires_grad_() for a in f32]
        out = ring(*leaves, group=group)
        grads = torch.autograd.grad((out ** 2).sum() / 2, leaves)
        f32_res.append([t.detach().cpu() for t in (out, *grads)])
    res["f32_err"] = max((a - b).abs().max().item()
                         for a, b in zip(*f32_res))
    res["f32_finite"] = all(bool(torch.isfinite(a).all())
                            for a in f32_res[0])
    to_cpu = lambda x: x.cpu() if torch.is_tensor(x) else x
    res = {key: ([to_cpu(t) for t in val] if isinstance(val, tuple)
                 else to_cpu(val)) for key, val in res.items()}
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def run_ring(world, backend, seed):
    """Spawn `world` ranks of `ring_rank`, wait at most
    RING_JOIN_TIMEOUT_S, kill what is left and fail unless every rank exits
    0. Returns each rank's saved results."""
    import torch.multiprocessing as mp
    work = Path(__file__).resolve().parent / "build" / f"ring_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ring_rank, args=(
        r, world, str(work / "store"), str(work), backend, seed))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RING_JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise SystemExit(f"ring ranks over {backend} exited {codes}")
    results = [torch.load(work / f"rank{r}.pt") for r in range(world)]
    shutil.rmtree(work, ignore_errors=True)
    return results


def check_ring(ranks, backend, want_o, label):
    """The ring's counts, its f32 case and its gathered output against the
    single-card flash attention `want_o`. Returns the timings of the slowest
    rank and the gathered gradients (dq, dk, dv)."""
    n = len(ranks)
    inference = {"fwd": 0, "fwd_lse": 0, "partial": n, "bwd_dq": 0,
                 "bwd_dkv": 0}
    training = dict(inference, bwd_dq=n, bwd_dkv=n)
    for r, res in enumerate(ranks):
        if (res["launches_inference"] != inference
                or res["launches_training"] != training):
            raise SystemExit(
                f"ring rank {r} ({backend}) launched "
                f"{res['launches_inference']} without grad and "
                f"{res['launches_training']} with grad: want {inference} "
                f"and {training}")
        # f32: the kernels' FMA order against the CPU's products
        if not (res["f32_finite"] and res["f32_err"] <= 1e-5):
            raise SystemExit(f"f32 ring on the card disagrees with the CPU "
                             f"ring on rank {r}: {res['f32_err']:.3e}")
    print(f"  {label}: launches per rank {inference} without grad, "
          f"{training} with grad; f32 T=1024 ring card vs CPU max abs err "
          f"{max(r['f32_err'] for r in ranks):.3e} (<= 1e-5)")
    gather = lambda get: torch.cat([get(r).cuda() for r in ranks], 1)
    out = gather(lambda r: r["out"])
    if not torch.equal(out, gather(lambda r: r["out_train"])):
        raise SystemExit("the ring's outputs with and without grad differ")
    # bf16 as in phases 3 and 7: a step of bf16 may flip between two
    # roundings of nearly equal f32 sums, and the ring rounds p against each
    # hop's max where the single-card kernel rounds it against its running
    # max
    compare(f"{label} o  vs single card", out, want_o, 1e-2, 1e-2, 1e-2)
    slowest = {key: max(r[key] for r in ranks) for key in (
        "fwd_ms", "fwd_bwd_ms", "rotate_fwd_ms", "rotate_bwd_ms")}
    print(f"  {label}: warm ring forward {slowest['fwd_ms']:.2f} ms, "
          f"forward+backward {slowest['fwd_bwd_ms']:.2f} ms; one rotation "
          f"of (k, v) {slowest['rotate_fwd_ms']:.2f} ms, of (k, v, dk, dv) "
          f"{slowest['rotate_bwd_ms']:.2f} ms (CUDA events, slowest rank)")
    grads = tuple(gather(lambda r: r["grads"][i]) for i in range(3))
    return slowest, grads


def coarse(x, bits):
    """x rounded to the nearest value with `bits` significant bits (bf16 has
    8), ties to even."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2 ** bits), e - bits)


def plain_gradients(fa, q, k, v, o, lse):
    """dq, dk, dv of mean(o**2) through the plain backward in f32, for f32
    q, k, v, their f32 lse and an output o, which may be rounded."""
    do = 2 * o / o.numel()
    args = (q, k, v, do, lse, fa.attention_delta(o, do))
    dq = per_row(partial(fa.flash_attention_bwd_dq_reference, causal=True),
                 *args)
    dk, dv = per_row(partial(fa.flash_attention_bwd_dkv_reference,
                             causal=True), *args)
    return dq, dk, dv


def check_gradients(fa, leaves, paths):
    """Holds each bf16 path's gradients of mean(o**2), `paths` = {name: (dq,
    dk, dv)}, against the f32 gradient (the plain forward and backward in
    f32 on the same bf16 inputs), divided by that gradient's rms, within
    GRAD_LIMITS. The controls are the f32 gradient from o rounded to 8
    significant bits (bf16's o: what that rounding alone moves) and to 7:
    the limits must reject the 7-bit one, or they would not tell a path one
    bit coarser than bf16."""
    qf, kf, vf = (a.detach().float() for a in leaves)
    o_ex, lse_ex = per_row(partial(fa.flash_attention_lse_reference,
                                   causal=True), qf, kf, vf)
    exact = plain_gradients(fa, qf, kf, vf, o_ex, lse_ex)
    controls = {f"control, o to {bits} bits": plain_gradients(
        fa, qf, kf, vf, coarse(o_ex, bits), lse_ex) for bits in (8, 7)}
    failed = []
    for name, grads in {**paths, **controls}.items():
        for i, g in enumerate(("dq", "dk", "dv")):
            rms = exact[i].pow(2).mean().sqrt()
            got, want = grads[i].float() / rms, exact[i] / rms
            atol = ((got - want).abs() - 1e-2 * want.abs()).max().item()
            row = ((got - want).norm(dim=-1) / (want.norm(dim=-1) + 1)
                   ).max().item()
            atol_max, row_max = GRAD_LIMITS[g]
            ok = (bool(torch.isfinite(got).all()) and atol <= atol_max
                  and row <= row_max)
            print(f"  {name} {g}/rms vs f32: least atol at rtol 1e-2 "
                  f"{atol:.4e} (<= {atol_max:g}), max row err {row:.4e} "
                  f"(<= {row_max:g}) {'ok' if ok else 'over'}")
            if ok == name.startswith("control, o to 7"):
                failed.append(f"{name} {g}")
    if failed:
        raise SystemExit(f"gradients vs the f32 gradient: {failed} broke "
                         f"the rule (paths within {GRAD_LIMITS}, the 7-bit "
                         f"control over them)")


def ring_main_path(fa, H, D, backend):
    """Phase 14 over one backend: the ranks (gloo: all on cuda:0; NCCL: one
    per card), the single-card flash attention (K2, K4, K5) on the same
    global input on cuda:0 as the output's reference, both paths' gradients
    against the f32 gradient, the checks. Returns the slowest rank's
    timings and the launches summed over the ranks."""
    seed = 51
    ranks = run_ring(RING, backend, seed)
    leaves = [a.requires_grad_() for a in ring_qkv(B, T, H, D,
                                                   torch.bfloat16, seed)]
    o = fa.flash_attention(*leaves, True)
    single = torch.autograd.grad((o.float() ** 2).mean(), leaves)
    label = (f"{RING} ranks sharing one card over gloo" if backend == "gloo"
             else f"{RING} ranks, one per card, over NCCL")
    result, ring_grads = check_ring(ranks, backend, o.detach(), label)
    del o
    check_gradients(fa, leaves, {
        "ring": ring_grads, "single card (K2, K4, K5)": single})
    result["launches"] = {
        name: sum(r["launches_inference"][name]
                  + r["launches_training"][name] for r in ranks)
        for name in ("partial", "bwd_dq", "bwd_dkv")}
    print("ring: " + json.dumps({
        "ranks": RING, "backend": backend,
        "cards": 1 if backend == "gloo" else RING,
        **{key: result[key] for key in ("fwd_ms", "fwd_bwd_ms",
                                        "rotate_fwd_ms", "rotate_bwd_ms")},
        "note": ("four ranks share one card and rotate K/V through the "
                 "host; not a multi-card figure") if backend == "gloo"
        else "one rank per card; NCCL P2P over NVLink"}))
    return result


def ring_phases(fa, _build, H, D):
    """Phases 11-14. Returns {"partial": K3's kernels-line fields, "extra":
    {kernel: K4/K5 hop fields}}."""
    print(f"phase 11: ring partial (K3) against its plain version, hop of "
          f"T={T} over a ring of {RING}")
    k3_reports = {f"D={d}": fwd_report(fa, _build, 2, d) for d in (64, 128)}
    bf16_tol, fp16_tol, f32_tol = (1e-2, 1e-2, 1e-2), (2e-3, 2e-3, 2e-3), (
        1e-5, 1e-5, 1e-5)
    # one head of 64 rows (one consumer warpgroup's rows against half a
    # 128-key tile) and of 128 rows (one whole kv tile) first; then the
    # Hopper kernel's tile edges (one row; 64, 128, 192 rows less, at and
    # past; two and three kv tiles and one), with the causal edge on a tile
    # edge and inside a tile (keys 37 rows later or earlier; a kv chunk whose
    # first key only the last row sees) and a non-causal hop at (100, 0)
    for t in (64, 128):
        for causal in (False, True):
            check_partial(fa, f"single tile B=1 T={t} H=1 D=64 bf16 (0, 0) "
                          f"{'causal' if causal else 'full'}",
                          *strided_qkv(1, t, 1, 64, torch.bfloat16,
                                       seed=60 + t), 0, 0, causal, bf16_tol)
    for t in (1, 63, 64, 127, 128, 129, 191, 192, 193, 257, 385):
        eq, ek, ev = strided_qkv(1, t, 8, 64, torch.bfloat16, seed=400 + t)
        for q_off, k_off, causal in ((0, 0, True), (t, 0, True), (0, t, True),
                                     (0, 37, True), (37, 0, True),
                                     (0, t - 1, True), (100, 0, False)):
            check_partial(fa, f"tile edge B=1 T={t} H=8 D=64 bf16 ({q_off}, "
                          f"{k_off}) {'causal' if causal else 'full'}", eq,
                          ek, ev, q_off, k_off, causal, bf16_tol)
    q, k, v = ring_qkv(B, HOP_T, H, D, torch.bfloat16, seed=21)
    hops = [("diagonal", HOP_T, HOP_T, True), ("visible", 2 * HOP_T, 0, True),
            ("wholly masked", 0, HOP_T, True),
            ("non-causal", 0, HOP_T, False)]
    shape = f"B={B} Tq=Tk={HOP_T} H={H} D={D} bf16"
    fwds, k3_err = {}, 0.0
    for label, q_off, k_off, causal in hops:
        err, fwds[label] = check_partial(
            fa, f"{shape} {label} ({q_off}, {k_off})", q, k, v, q_off, k_off,
            causal, bf16_tol)
        k3_err = max(k3_err, err)
    # T=1025: 63 padded keys and queries in the last tiles; part overlaps
    # leave rows that see no key of the hop inside computed tiles
    edges = [("B=2 T=1025 H=8 D=64 bf16 visible", (2, 1025, 8, 64,
                                                   torch.bfloat16),
              1025, 0, True, bf16_tol),
             ("B=2 T=1025 H=8 D=64 bf16 diagonal", (2, 1025, 8, 64,
                                                    torch.bfloat16),
              0, 0, True, bf16_tol),
             ("B=2 T=1000 H=8 D=128 fp16 part overlap", (2, 1000, 8, 128,
                                                         torch.float16),
              0, 500, True, fp16_tol),
             ("B=2 T=300 H=4 D=64 f32 part overlap", (2, 300, 4, 64,
                                                      torch.float32),
              150, 300, True, f32_tol)]
    edge_inputs = {}
    for i, (label, shp, q_off, k_off, causal, tol) in enumerate(edges):
        eq, ek, ev = strided_qkv(*shp, seed=22 + i)
        _, fwd = check_partial(fa, f"{label} ({q_off}, {k_off})", eq, ek, ev,
                               q_off, k_off, causal, tol)
        edge_inputs[label] = (eq, ek, ev, fwd)

    print("phase 12: K4 and K5 with hop offsets and f32 outputs against "
          "their plain versions")
    hop_errs = {"bwd_dq": 0.0, "bwd_dkv": 0.0}
    for i, (label, q_off, k_off, causal) in enumerate(hops):
        args, errs = check_hop_backward(
            fa, f"{shape} {label}", q, k, v, q_off, k_off, causal, bf16_tol,
            31 + i, fwds[label])
        hop_errs = {n: max(hop_errs[n], errs[n]) for n in hop_errs}
        if label == "visible":
            visible = args
    for i, (label, _, q_off, k_off, causal, tol) in enumerate(edges):
        eq, ek, ev, fwd = edge_inputs[label]
        check_hop_backward(fa, label, eq, ek, ev, q_off, k_off, causal, tol,
                           41 + i, fwd)
    del edge_inputs, fwds

    print(f"phase 13: K3, K4, K5 timed on the visible hop ({shape}, "
          f"q_off {2 * HOP_T}, k_off 0)")
    q, k, v, delta, do, lse = visible
    off = dict(q_off=2 * HOP_T, k_off=0)
    f32_out = dict(off, out_dtype=torch.float32)
    bwd_args = (q, k, v, do, lse, delta)
    calls = {  # kernel wrapper, plain version, inputs
        "partial": (partial(fa.flash_attention_partial, causal=True, **off),
                    partial(fa.flash_attention_partial_reference,
                            causal=True, **off), (q, k, v)),
        "bwd_dq": (partial(fa.flash_attention_bwd_dq, causal=True,
                           **f32_out),
                   partial(fa.flash_attention_bwd_dq_reference, causal=True,
                           **f32_out), bwd_args),
        "bwd_dkv": (partial(fa.flash_attention_bwd_dkv, causal=True,
                            **f32_out),
                    partial(fa.flash_attention_bwd_dkv_reference,
                            causal=True, **f32_out), bwd_args),
    }
    pairs = B * H * HOP_T * HOP_T              # every pair of the hop visible
    panel = B * HOP_T * H * D * q.element_size()
    panel32 = B * HOP_T * H * D * 4
    row_stats = B * H * HOP_T * 4
    work = {  # (FLOP, bytes: each input read once, each output written once)
        "partial": (4 * D * pairs, 3 * panel + panel32 + 2 * row_stats),
        "bwd_dq": (6 * D * pairs, 4 * panel + 2 * row_stats + panel32),
        "bwd_dkv": (8 * D * pairs, 4 * panel + 2 * row_stats + 2 * panel32),
    }
    lib_bwd, lib_bwd_kernels = sdpa_backward_ms(q, k, v, do, False)
    # K3's yardstick: flash SDPA's forward returns (o, logsumexp, ...), the
    # same information as K3's (acc, m, l) in normalised form; non-causal on
    # the visible hop, causal on the diagonal one
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    flash_sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    lib_partial = {causal: cuda_ms(lambda: flash_sdpa(qt, kt, vt, 0.0, causal),
                                   iters=20) for causal in (False, True)}
    _, m, l = fa.flash_attention_partial(q, k, v, causal=True, **off)
    lse_diff = (flash_sdpa(qt, kt, vt, 0.0, False)[1] - (m + torch.log(l))
                ).abs().max().item()
    print(f"  the yardstick computes K3's function: SDPA's logsumexp vs K3's "
          f"m + log l on the visible hop, max abs diff {lse_diff:.3e}")
    del qt, kt, vt, m, l
    library = {"partial": lib_partial[False], "bwd_dq": lib_bwd,
               "bwd_dkv": lib_bwd}
    timed = {}
    for name, (kernel_fn, plain_fn, inputs) in calls.items():
        k_ms = cuda_ms(lambda: kernel_fn(*inputs), iters=20)
        p_ms = cuda_ms(lambda: per_row(plain_fn, *inputs), iters=2,
                       warmup=1)
        b_ms, b_by = bound(*work[name])
        timed[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": library[name]}
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"library {shown_ms(library[name])}, bound {b_ms:.4f} ms "
              f"({b_by}), roofline share {b_ms / k_ms:.3f}, "
              f"{work[name][0] / k_ms / 1e9:.1f} TFLOP/s")
    # K3 on the diagonal hop (q_off = k_off): half the pairs, the same bytes.
    # Near 0.08 ms a K3 call is about as long as its wrapper takes on the
    # host, so CUDA events may time the host: the trace gives the card's
    # time, on both hops.
    diagonal = partial(fa.flash_attention_partial, q, k, v, HOP_T, HOP_T,
                       True)
    diag_ms = cuda_ms(diagonal, iters=20)
    diag_flops = 4 * D * B * H * HOP_T * (HOP_T + 1) / 2
    diag_bound, diag_by = bound(diag_flops, work["partial"][1])
    trace = {hop: device_ms(fn, ("flash_fwd_hopper_kernel",))[0] for hop, fn in
             (("visible", partial(calls["partial"][0], q, k, v)),
              ("diagonal", diagonal))}
    timed["partial"]["device_ms"] = trace["visible"]
    timed["partial"]["diagonal"] = {
        "ms": diag_ms, "device_ms": trace["diagonal"],
        "library_ms": lib_partial[True], "bound_ms": diag_bound,
        "bound_by": diag_by,
        "shape": f"{shape}, diagonal hop (q_off = k_off = {HOP_T})"}
    timed["partial"]["library_call"] = (
        "aten._scaled_dot_product_flash_attention on [B, H, T, D] (o and "
        "logsumexp), non-causal; causal on the diagonal hop")
    print(f"  partial, diagonal hop: kernel {diag_ms:.4f} ms, library "
          f"{lib_partial[True]:.4f} ms, bound {diag_bound:.4f} ms "
          f"({diag_by}), roofline share {diag_bound / diag_ms:.3f}, "
          f"{diag_flops / diag_ms / 1e9:.1f} TFLOP/s")
    print(f"  partial on the card (trace): visible hop "
          f"{shown_ms(trace['visible'])}, diagonal hop "
          f"{shown_ms(trace['diagonal'])}")
    print(f"  SDPA flash backward alone, non-causal, [{B}, {H}, {HOP_T}, {D}] "
          f"bf16 (the same dq, dk, dv rounded to bf16): {shown_ms(lib_bwd)} "
          f"on the card (trace: {json.dumps(lib_bwd_kernels)})")
    del visible, q, k, v, delta, do, lse, bwd_args, calls

    print(f"phase 14: ring main path at full width: {RING} ranks on cuda:0 "
          f"over gloo, global B={B} T={T} H={H} D={D} bf16 causal")
    torch.cuda.empty_cache()
    gloo = ring_main_path(fa, H, D, "gloo")
    if torch.cuda.device_count() >= RING:
        ring_main_path(fa, H, D, "nccl")
    else:
        print(f"  NCCL ring skipped: it needs {RING} cards, one per rank "
              f"(NCCL refuses two ranks on one device); this machine has "
              f"{torch.cuda.device_count()}")
    ring_launches = gloo["launches"]
    hop_shape = f"{shape}, visible hop (q_off {2 * HOP_T}, k_off 0)"
    return {
        "partial": dict(timed["partial"], launches=ring_launches["partial"],
                        max_abs_err=k3_err, shape=hop_shape,
                        err_on="acc / plain l", kernel=k3_reports,
                        launches_per_rank={"inference": RING,
                                           "training": RING}),
        "extra": {name: {"ring_launches": ring_launches[name], "hop": dict(
            timed[name], max_abs_err=hop_errs[name], shape=hop_shape,
            out_dtype="float32",
            library_call="SDPA flash backward alone, non-causal, dq/dk/dv "
                         "together, rounded to bf16 (device time, "
                         "torch.profiler)")}
            for name in ("bwd_dq", "bwd_dkv")},
    }


def _one_hot(rng, n, classes):
    import numpy as np
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def _max_err(a, b):
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _check(label, err, limit):
    print(f"  {label}: {err:.3e} (limit {limit:.3e})")
    if not err <= limit:
        raise SystemExit(f"{label}: {err} over {limit}")


class _DeviceAudit:
    """Every op dispatched while active, with any tensor argument or
    result that is not on the card (a TorchDispatchMode)."""

    def __new__(cls):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        class Audit(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.ops, self.off_card = 0, set()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                self.ops += 1
                for t in tree_flatten((args, kwargs, out))[0]:
                    if isinstance(t, torch.Tensor) and t.device.type != "cuda":
                        self.off_card.add(f"{func} on {t.device}")
                return out

        return Audit()


def lenet_card_vs_cpu():
    """Phase 15. Returns its readings."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    print("phase 15: LeNet (MultiLayerNetwork) f32, batch 64: card vs CPU, "
          "3 Nesterov steps")
    rng = np.random.default_rng(15)
    x = rng.random((64, 784), dtype=np.float32)
    y = _one_hot(rng, 64, 10)
    gpu, cpu = (lenet(device=d, data_type="float32") for d in ("cuda", "cpu"))
    if not np.array_equal(gpu.params(), cpu.params()):
        raise SystemExit("LeNet weights differ between devices")
    # 1e-5: cuDNN and the CPU sum the 5x5 windows and the 800- and
    # 500-wide products in other orders; outputs are probabilities
    out = {"output": _max_err(gpu.output(x), cpu.output(x))}
    _check("output [64, 10] max_abs_err", out["output"], 1e-5)
    losses = [[], []]
    for _ in range(3):
        for net, seen in zip((gpu, cpu), losses):
            net.fit(x, y)
            seen.append(net.score())
    out["losses"] = losses[0]
    out["loss_err"] = _max_err(*losses)
    out["param_err"] = _max_err(gpu.params(), cpu.params())
    print(f"  card losses {losses[0]}")
    _check("losses max_abs_err", out["loss_err"], 1e-5)
    _check("parameters after 3 steps max_abs_err", out["param_err"], 1e-5)
    if not losses[0][-1] < losses[0][0]:
        raise SystemExit("LeNet losses do not fall")
    return out


def resnet_f32_card_vs_cpu():
    """Phase 16. Returns its readings."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    print("phase 16: ResNet-50 (ComputationGraph) f32, full depth, 64x64x3, "
          "batch 2, 10 classes: card vs CPU (and CPU float64)")
    kw = dict(height=64, width=64, num_classes=10)
    gpu = resnet50(device="cuda", data_type="float32", **kw)
    cpu = resnet50(device="cpu", data_type="float32", **kw)
    f64 = resnet50(device="cpu", data_type="float64", **kw)
    f64.set_params(cpu.params())
    if not np.array_equal(gpu.params(), cpu.params()):
        raise SystemExit("ResNet-50 weights differ between devices")
    rng = np.random.default_rng(16)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    y = _one_hot(rng, 2, 10)
    outs = [net.output(x)[0] for net in (gpu, cpu, f64)]
    if outs[0].shape != (2, 10) or not np.isfinite(outs[0]).all():
        raise SystemExit(f"bad ResNet-50 output {outs[0].shape}")
    first = [net.score(DataSet(x, y), training=True) for net in (gpu, cpu,
                                                                 f64)]
    out = {"output": _max_err(*outs[:2]), "first_loss": abs(first[0] - first[1]),
           "output_f32_vs_f64": _max_err(*outs[1:]),
           "first_loss_f32_vs_f64": abs(first[1] - first[2])}
    # controls: the same output and training loss through cuDNN with TF32
    # on (the port's forward and loss called outside its own
    # `card_numerics` scope)
    with torch.no_grad():
        acts, _, _ = gpu._apply_graph(gpu._cast_params(), gpu._states(),
                                      gpu._inputs([x]), train=False, rng=None)
        tf32_out = acts["fc"].cpu().numpy()
        tf32 = float(gpu._loss(*gpu._batch(MultiDataSet([x], [y])), True,
                               None)[0])
    out["output_tf32"] = _max_err(tf32_out, outs[1])
    out["first_loss_tf32"] = abs(tf32 - first[1])
    print(f"  CPU f32 vs float64: output {out['output_f32_vs_f64']:.3e}, "
          f"first training loss {out['first_loss_f32_vs_f64']:.3e}; the "
          f"card with TF32 on, from the CPU: output "
          f"{out['output_tf32']:.3e}, loss {out['first_loss_tf32']:.3e}")
    # the same f32 function summed in other orders, through 53 layers and
    # BatchNorms over 8-32 values a channel (train mode): on the CPU, f32
    # reads 2.9e-6 (output) and 9.3e-5 (loss) from float64; cuDNN's f32
    # algorithms (benchmark mode
    # takes the fastest: Winograd, FFT) read up to 5.5e-5 (output) and
    # 2.8e-4 (loss) from the CPU on an H100. TF32 moves the loss by ~2e-2:
    # each control must break its limit.
    limits = {"output": 5e-4, "first_loss": 1e-3}
    _check("output [2, 10] max_abs_err", out["output"], limits["output"])
    _check("first training loss abs_err", out["first_loss"],
           limits["first_loss"])
    for what, limit in limits.items():
        if not out[f"{what}_tf32"] > limit:
            raise SystemExit(f"the TF32 control of the {what} stays inside "
                             f"the f32 limit {limit}")
    start = cpu.params().astype(np.float64)
    losses = {"card": [], "cpu": [], "f64": []}
    for _ in range(2):
        for name, net in (("card", gpu), ("cpu", cpu), ("f64", f64)):
            net.fit(x, y)
            losses[name].append(net.score())
    print(f"  losses: {json.dumps(losses)}")
    out["losses"] = losses["card"]
    # the two steps' parameter change: the step's gradient passes 16
    # BatchNorms over 8-32 values a channel, where f32 on the CPU is ~5%
    # (relative L2) off float64; lr 0.1 then
    # takes the loss from 3.3 to ~13 in one step, so two f32 runs part
    # and a per-entry or loss comparison only measures that chaos. The
    # card's change is held to float64's as the CPU's f32 is: its relative
    # L2 error at most twice the CPU's.
    want = f64.params() - start

    def rel(net):
        return float(np.linalg.norm(net.params() - start - want)
                     / np.linalg.norm(want))

    out["update_rel_err_card"], out["update_rel_err_cpu"] = rel(gpu), rel(cpu)
    out["update_rel_card_vs_cpu"] = float(
        np.linalg.norm(gpu.params() - cpu.params())
        / np.linalg.norm(cpu.params() - start))
    print(f"  2 steps: parameter change, relative L2 error against float64:"
          f" CPU f32 {out['update_rel_err_cpu']:.3e}; card vs CPU "
          f"{out['update_rel_card_vs_cpu']:.3e}")
    _check("2 steps: the card's parameter change, relative L2 error "
           "against float64", out["update_rel_err_card"],
           max(2 * out["update_rel_err_cpu"], 1e-5))
    if not all(np.isfinite(losses["card"])):
        raise SystemExit("ResNet-50 f32 losses are not finite")
    return out


def resnet_full_width():
    """Phase 17. Returns its readings."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50
    # 24 warm-up steps: cuDNN's algorithm search runs in the first; and
    # lr 0.1 with momentum 0.9 from He-initialised weights makes the loss
    # of the repeated batch rise and fall for up to 13 steps (the warm-up
    # losses printed below show it) before it falls step after step
    batch, warmup, steps = 128, 24, 8
    print(f"phase 17: ResNet-50 full width, bf16, batch {batch}, 224x224x3, "
          f"1000 classes, Nesterov lr 0.1 momentum 0.9")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    net = resnet50(data_type="bfloat16")
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(17)
    # one random batch, on the card, as bench.py feeds the JAX package
    x = torch.rand((batch, 224, 224, 3), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (batch,), generator=gen, device="cuda"),
        1000).float()
    ds = DataSet(x, y)
    t0 = time.perf_counter()
    warm = []
    for i in range(warmup):
        if i == warmup - 1:
            audit = _DeviceAudit()
            with audit:
                net.fit(ds)
        else:
            net.fit(ds)
        warm.append(net._score)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = [float(s) for s in warm]
    print(f"  warm-up losses {[round(l, 4) for l in warm]}")
    print(f"  init {init_s:.1f} s; {warmup} warm-up steps (cuDNN search) "
          f"{warm_s:.1f} s; audited step: {audit.ops} ops, off the card: "
          f"{sorted(audit.off_card)}")
    if audit.off_card or audit.ops == 0:
        raise SystemExit(f"the step used tensors off the card: "
                         f"{sorted(audit.off_card)}")
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    scores = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        net.fit(ds)
        scores.append(net._score)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    losses = [float(s) for s in scores]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    mean_ms = sum(step_ms) / steps
    out = {"step_ms": step_ms, "mean_step_ms": mean_ms,
           "images_per_s": batch * 1e3 / mean_ms,
           "images_per_s_wall": batch * steps / wall_s,
           "peak_memory_gib": peak_gib, "losses": losses,
           "warmup_s": warm_s, "warmup_losses": warm, "init_s": init_s}
    print(f"  losses {[round(l, 5) for l in losses]}")
    print(f"  step ms {[round(t, 2) for t in step_ms]}; mean {mean_ms:.2f} ms,"
          f" {out['images_per_s']:.1f} images/s ({out['images_per_s_wall']:.1f}"
          f" by the host clock over the {steps} steps); peak memory "
          f"{peak_gib:.2f} GiB")
    if not all(math.isfinite(l) for l in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"ResNet-50 losses not finite and falling: {losses}")
    bad = [n for n, p in net.named_parameters()
           if p.dtype != torch.float32 or not p.is_cuda]
    if bad:
        raise SystemExit(f"parameters not f32 on the card: {bad[:5]}")
    # inference: the same batch, the running statistics
    net.output(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    probs = net.output(x)[0]
    end.record()
    end.synchronize()
    out["output_ms"] = start.elapsed_time(end)
    out["output_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    if (probs.shape != (batch, 1000) or not np.isfinite(probs).all()
            or _max_err(probs.sum(axis=1), np.ones(batch)) > 1e-2):
        raise SystemExit(f"bad ResNet-50 output {probs.shape}")
    print(f"  output [{batch}, 1000]: {out['output_ms']:.2f} ms "
          f"({batch * 1e3 / out['output_ms']:.1f} images/s; "
          f"{out['output_wall_ms']:.2f} ms wall with the copy to the host)")
    # where one step's device time goes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net.fit(ds)
        torch.cuda.synchronize()
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages() if e.device_time_total),
                     reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    out["traced_device_ms"] = busy_ms
    out["device_busy_share"] = busy_ms / mean_ms
    out["by_kind_ms"] = {}
    for us, _, name in kernels:
        kind = _kernel_kind(name)
        out["by_kind_ms"][kind] = out["by_kind_ms"].get(kind, 0.0) + us / 1e3
    out["top_kernels"] = [{"name": k[2][:90], "ms": k[0] / 1e3, "count": k[1]}
                          for k in kernels[:15]]
    print(f"  one traced step: {busy_ms:.2f} ms of device time in "
          f"{sum(k[1] for k in kernels)} kernels ({out['device_busy_share']:.1%}"
          f" of the mean step); by kind: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in sorted(
                  out["by_kind_ms"].items(), key=lambda kv: -kv[1])))
    print("  the largest:")
    for k in out["top_kernels"]:
        print(f"    {k['ms']:8.3f} ms  x{k['count']:<4d} {k['name']}")
    del net, x, y, ds
    torch.cuda.empty_cache()
    return out


def _kernel_kind(name):
    """A device kernel's kind, from its name (cuDNN, cuBLAS and ATen's)."""
    kinds = (("pooling", ("pool",)), ("reduction", ("reduce_kernel",)),
             ("copy or cast", ("copy",)),
             ("convolution", ("fprop", "dgrad", "wgrad", "implicit", "conv",
                              "cudnn")),
             ("matrix product", ("gemm", "gemv", "xmma", "cutlass")),
             ("elementwise", ("elementwise",)))
    for kind, keys in kinds:
        if any(k in name for k in keys):
            return kind
    return "other"


def golden_zips_on_card():
    """Phase 18. Returns each zip's output error."""
    import numpy as np
    from deeplearning4j_tpu_torch.util import model_serializer as ms
    print("phase 18: golden model zips restored on the card")
    golden = Path(__file__).resolve().parent / "tests" / "fixtures" / "golden"
    out = {}
    for name, restore in (("mlp", ms.restore_multi_layer_network),
                          ("lenet", ms.restore_multi_layer_network),
                          ("cg", ms.restore_computation_graph)):
        net = restore(str(golden / f"{name}.zip"))
        io = np.load(golden / f"{name}_io.npz")
        if net.device.type != "cuda" or not np.array_equal(net.params(),
                                                           io["params"]):
            raise SystemExit(f"{name}.zip: parameters not restored on the card")
        y = net.output(io["x"])
        y = y[0] if name == "cg" else y
        # 1e-5: the zips' outputs were computed by the JAX package on the
        # CPU in f32; cuDNN may pick Winograd or FFT algorithms
        out[name] = _max_err(y, io["y"])
        _check(f"{name}.zip output vs io['y']", out[name], 1e-5)
    return out


def training_core_phases(fa):
    """Phases 15-18 (no kernel of the port on their path)."""
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launches()
    core = {"lenet_f32": lenet_card_vs_cpu(),
            "resnet50_f32_64px": resnet_f32_card_vs_cpu(),
            "resnet50_bf16_full": resnet_full_width(),
            "golden_zips_err": golden_zips_on_card()}
    if any(fa.launches.values()):
        raise SystemExit(f"the training core launched flash kernels: "
                         f"{fa.launches}")
    if not torch.backends.cudnn.allow_tf32:
        raise SystemExit("the port left cudnn.allow_tf32 off")
    print(f"  phases 15-18 launched no kernel of the port: {fa.launches}")
    return core


if __name__ == "__main__":
    sys.exit(main())
