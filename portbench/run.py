#!/usr/bin/env python3
"""One run of one cell of the benchmark of `deeplearning4j_tpu_torch`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and last `checks`: each number compared
with its limit, which also end standard error. Without the cards, or
with a module of JAX or of the JAX package loaded once the window has
closed, it exits non-zero and prints no result.

`--rank`, `--world` and `--store-port` start one of the other ranks of a
data-parallel cell (the run's own process starts them). `--device cpu`
and `--bench-file` run a cell on the CPU from another benchmark file:
the tests' way in, never a measurement.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the package and the program import from the checkout's root, and
# nothing of this directory shadows a module of the standard library
sys.path[0] = str(ROOT)

# the program's build and kernel caches at fixed paths inside the checkout
_CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(_CACHE / "inductor")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's share of a step is the eager
# launch loop on one thread, and other pools only contend with it
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "2"

import argparse  # noqa: E402
import json  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--bench-file", default=str(ROOT / "BENCHMARK.json"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--store-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def session(args, argv):
    from types import SimpleNamespace

    from portbench.harness import load_cell
    cell = load_cell(args.bench_file, args.workload)
    return SimpleNamespace(cell=cell, seed=args.seed % (1 << 63),
                           seconds=args.seconds, trace=args.trace,
                           device=args.device, argv=list(argv),
                           agree=lambda n: n, barrier=lambda: None)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    import torch
    s = session(args, argv)
    if args.rank:
        from portbench.loops import parallel_wrapper as dp
        store = dp.connect(args.store_port, args.world)
        dp.rank_main(s, args.rank, args.world, store)
        return 0
    if args.device == "cuda" and not (
            torch.cuda.is_available()
            and torch.cuda.device_count() >= s.cell.chips):
        print(f"{args.workload} needs {s.cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return report(s, s.cell.loop.run(s))


def report(s, measured):
    from portbench.harness import device_info, forbidden_modules, result_line
    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark must not load are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    dev = "cuda:0" if s.device.startswith("cuda") else s.device
    out, rows = result_line(s.cell, measured, s.trace,
                            device_info(dev, s.cell.chips))
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
