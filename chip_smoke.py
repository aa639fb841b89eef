"""Smoke run of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build every CUDA kernel from the sources in the checkout (nvcc);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shape and at edge shapes, with stated tolerances;
  4. each kernel timed with CUDA events beside its plain version, one
     PyTorch library call computing the same function (a yardstick only:
     the port never calls it) and its bound on an H100 SXM;
  5. the main path at full width: the flash-attention TransformerLM
     (vocab 512, d_model 512, 8 heads, 4 layers, max_len 8192, bf16, random
     weights from a seed) runs one full causal forward at B=4, T=8192 and
     answers a few generate / generate_batch requests, with every kernel
     launch counter set to 0 just before and read just after;
  6. a small-depth f32 copy of the model (same seed) on the card, through
     the kernel, agrees with the same model on the CPU through the plain
     versions; its greedy flash re-encode tokens equal its dense KV-cache
     tokens;
  7. the training kernels (K2 forward with logsumexp, K4 backward dQ, K5
     backward dK/dV) against their plain versions on the card, at the
     training shape (B=4, T=8192, H=8, D=64, bf16, causal) and at edge
     shapes, with stated tolerances;
  8. each training kernel timed with CUDA events beside its plain version,
     its bound and one PyTorch call (a yardstick only): the flash SDPA
     forward, which also returns the logsumexp, for K2; SDPA's backward
     (forward+backward minus forward; dq, dk, dv together) for K4 and K5;
  9. the training main path at full width: the same TransformerLM
     (learning rate 0.1, momentum 0.9) takes 8 `fit_batch` steps at B=4,
     T=8192 on the shift task y = (x + 1) % 512, with every launch counter
     set to 0 just before and read just after: 4 launches each of K2, K4
     and K5 per step and none of K1; the losses are finite and fall;
 10. a small-depth f32 copy (same seed) trains three steps on the card
     (kernels) and on the CPU (plain versions); losses and parameters agree.
Then it prints one {"kernels": [...]} JSON line and, as the last line,
{"ok": true, "device": {...}}. It imports nothing of JAX.
"""
import json
import math
import subprocess
import sys
import time
from functools import partial

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16/fp16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FULL = dict(vocab_size=512, d_model=512, n_heads=8, n_layers=4,
            max_len=8192, seed=0, attention="flash")
B, T = 4, 8192
TRAIN_STEPS = 8
LSE_ATOL = 1e-5   # read 1.9e-6 (bf16, T=8192) on an H100


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


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time an H100 SXM takes."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    if sum(fa.launches.values()) != main_launches:
        raise SystemExit(f"serving launched training kernels: {fa.launches}")
    warm_ms = cuda_ms(lambda: lm.logits(tokens), iters=3, warmup=1)
    print(f"  main path: {main_launches} flash launches; warm logits "
          f"[{B}, {T}] {warm_ms:.2f} ms ({B * T / warm_ms:.0f} tokens/ms), "
          f"of which flash {FULL['n_layers']} x {ms:.3f} ms = "
          f"{FULL['n_layers'] * ms / warm_ms:.1%}")
    del lm

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
    train = training_phases(fa, TransformerLM, H, D)

    shape = f"B={B} T={T} H={H} D={D} bf16 causal"
    src = "deeplearning4j_tpu_torch/ops/csrc/"
    ref = "deeplearning4j_tpu/ops/flash_attention.py:"
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": src + "flash_attention_fwd.cu", "replaces": ref + "108",
        "launches": main_launches, "max_abs_err": err_main, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "shape": shape}]
    for name, source, line in (
            ("fwd_lse", "flash_attention_fwd.cu", "122"),
            ("bwd_dq", "flash_attention_bwd.cu", "298"),
            ("bwd_dkv", "flash_attention_bwd.cu", "344")):
        kernels.append(dict({
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": src + source, "replaces": ref + line,
            "launches": train["launches"][name]}, **train["kernels"][name],
            shape=shape))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def training_phases(fa, TransformerLM, H, D):
    """Phases 7-10. Returns {"launches": {kernel: main-path count},
    "kernels": {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, ...}}}."""
    print("phase 7: training kernels against their plain versions")
    # bf16/fp16 element-wise and per row as for K1 (one step of the output
    # type may flip; p and ds are rounded from f32 values that the kernel
    # and cuBLAS sum in another order)
    bf16_tol, fp16_tol = (1e-2, 1e-2, 1e-2), (2e-3, 2e-3, 2e-3)
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
    gt = do.transpose(1, 2).contiguous()
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        # with inputs that need grad, flash SDPA also returns the logsumexp
        lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=20)
        lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
            sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), gt), iters=10)
    lib_bwd = lib_fwd_bwd - lib_fwd
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
                         "library_ms": library[name]}
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"library {library[name]:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), roofline share {b_ms / k_ms:.3f}, "
              f"{work[name][0] / k_ms / 1e9:.1f} TFLOP/s")
    kernels["fwd_lse"]["lse_max_abs_err"] = errs["lse"]
    for name in ("bwd_dq", "bwd_dkv"):
        kernels[name]["library_call"] = (
            "SDPA flash backward, dq/dk/dv together (fwd+bwd minus fwd)")
    print(f"  SDPA flash: forward {lib_fwd:.4f} ms, forward+backward "
          f"{lib_fwd_bwd:.4f} ms, backward {lib_bwd:.4f} ms")
    del args, q, k, v, do, lse, delta, qt, kt, vt, gt

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
    if launches != {"fwd": 0, "fwd_lse": n, "bwd_dq": n, "bwd_dkv": n}:
        raise SystemExit(f"fit_batch launches {launches}: want {n} each of "
                         f"K2, K4, K5 and no K1")
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


if __name__ == "__main__":
    sys.exit(main())
