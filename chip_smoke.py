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
     tokens.
Then it prints one {"kernels": [...]} JSON line and, as the last line,
{"ok": true, "device": {...}}. It imports nothing of JAX.
"""
import json
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16/fp16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FULL = dict(vocab_size=512, d_model=512, n_heads=8, n_layers=4,
            max_len=8192, seed=0, attention="flash")
B, T = 4, 8192


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


def check_flash(fa, label, q, k, v, causal, scale, atol, rtol, row_rtol):
    """Element-wise |err| <= atol + rtol*|plain|, and per output row (one
    query, one head) ||err|| <= row_rtol*||plain||: most outputs are far
    smaller than 1, so the row check is the one that sees an error of a
    few percent (e.g. padded keys of a ragged tile left unmasked)."""
    out = fa.flash_attention(q, k, v, causal, scale)
    want = flash_plain(fa, q, k, v, causal, scale)
    torch.cuda.synchronize()
    diff = out.float() - want.float()
    err = diff.abs()
    max_abs = err.max().item()
    row_rel = (diff.norm(dim=-1)
               / want.float().norm(dim=-1).clamp_min(1e-30)).max().item()
    ok = (bool(torch.isfinite(out).all())
          and not (err > atol + rtol * want.float().abs()).any()
          and row_rel <= row_rtol)
    print(f"  flash {label}: max_abs_err {max_abs:.3e} "
          f"(|err| <= {atol:g} + {rtol:g}*|plain|), max row rel err "
          f"{row_rel:.3e} (<= {row_rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"flash kernel disagrees with its plain version "
                         f"({label})")
    return max_abs


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
    fa.launches = 0
    t0 = time.perf_counter()
    logits = lm.logits(tokens)
    torch.cuda.synchronize()
    logits_ms = 1e3 * (time.perf_counter() - t0)
    n_logits = fa.launches
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
        before = fa.launches
        t0 = time.perf_counter()
        out = call()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = out if name == "generate_batch" else [out]
        new = [list(map(int, r[1024:])) for r in rows]
        if any(len(n) != 8 or not all(0 <= t < FULL["vocab_size"]
                                      for t in n) for n in new):
            raise SystemExit(f"{name} returned bad tokens {new}")
        added = fa.launches - before
        want = 8 * FULL["n_layers"] if name.endswith("False)") else 0
        if added != want:
            raise SystemExit(f"{name} launched the flash kernel {added} "
                             f"times, not {want}")
        print(f"  {name}: prompt 1024 -> 8 new tokens {new} in "
              f"{wall_ms:.1f} ms wall, {added} flash launches")
    main_launches = fa.launches    # read before the timing below
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

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:108",
        "launches": main_launches, "max_abs_err": err_main, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": f"B={B} T={T} H={H} D={D} bf16 causal"}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
