"""The readings a cell's limits are set from, in one process: the
program's numbers on each of `--seeds` (a run of the cell at a short
window: its first steps, or the window's served rows), the control's on
each of `--control-seeds` (the reference in float8 against itself in
float32), and, for a training cell, the fault "half of the batch left
out, the mean taken over the rest" planted in the program on each of
`--fault-seeds`, and planted in the reference put in the program's
place on each of `--planted-seeds` (for a data-parallel cell also "the
exchange between cards left out": the loss over one rank's rows), and
BatchNorm's gamma and beta left un-updated by the program's updater on
each of `--bn-fault-seeds`. One JSON line a reading, on standard output
and appended to `--out`: the numbers the cell compares, and for a
training cell those looked at and not compared (`looked_at`) and the
leaves that read worst.

    python3 portbench/tools/readings.py --workload <cell> \
        --seeds 1,2,3 --control-seeds 4,5,6 [--fault-seeds 7,8,9] \
        --out readings.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)


@contextlib.contextmanager
def half_batch():
    """The fault: every loss the port computes takes the mean of the
    first half of the batch's per-example losses."""
    from deeplearning4j_tpu_torch.nn import multilayer
    from deeplearning4j_tpu_torch.nn.graph import computation_graph
    real = multilayer.mean_score

    def half(per_example):
        return real(per_example[: max(1, per_example.shape[0] // 2)])

    multilayer.mean_score = computation_graph.mean_score = half
    try:
        yield
    finally:
        multilayer.mean_score = computation_graph.mean_score = real


@contextlib.contextmanager
def batch_norm_left_behind():
    """The fault: the updater leaves BatchNorm's parameters (gamma, beta)
    and their state as they were; every other layer is updated."""
    from deeplearning4j_tpu_torch.nn.updater import updaters
    real = updaters.apply_layer

    def apply(layer, params, grads, ustate, *args, **kwargs):
        if type(layer).__name__ == "BatchNormalization":
            return ustate if kwargs.get("inplace") else {}
        return real(layer, params, grads, ustate, *args, **kwargs)

    updaters.apply_layer = apply
    try:
        yield
    finally:
        updaters.apply_layer = real


def looked_at(prog, ref):
    """Numbers read and not compared: the first step's loss gap, the
    median leaf's gradient, change and running-statistic gaps, and what
    `far_leaves` would read with every leaf left unmoved (a step that
    returns its state unchanged)."""
    import statistics

    from portbench.check import leaf_sets, scaled_gaps, train_readings
    params, moved, stats = leaf_sets(ref)
    unmoved = dict(prog, change={k: 0.0 for k in ref["change"]})
    out = {"loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
           / abs(ref["losses"][0]),
           "grad_median_gap": statistics.median(
               scaled_gaps(prog["grad"], ref["grad"], params)),
           "change_median_gap": statistics.median(
               scaled_gaps(prog["change"], ref["change"], moved))}
    if stats:
        out["stats_median_gap"] = statistics.median(
            scaled_gaps(prog["change"], ref["change"], stats))
    out["far_leaves_if_unmoved"] = train_readings(unmoved, ref)["far_leaves"]
    return out


def detail(m):
    """Per-leaf detail of a training cell's first steps: each step's loss
    on both sides, and the leaves whose gaps are largest."""
    if "first_steps" not in m:
        return {}
    import statistics
    prog, ref = m["first_steps"]

    def ranked(key):
        floor = statistics.median(ref[key].values())
        gaps = {k: abs(prog[key][k] - ref[key][k]) / max(ref[key][k], floor,
                                                          1e-30)
                for k in ref[key]}
        worst = sorted(gaps, key=lambda k: -gaps[k])
        return {"median_gap": statistics.median(gaps.values()),
                "floor": floor,
                "worst": [[str(k), gaps[k], prog[key][k], ref[key][k]]
                          for k in worst[:8]]}

    total = {side: sum(v * v for v in d["grad"].values()) ** 0.5
             for side, d in (("prog", prog), ("ref", ref))}
    return {"looked_at": looked_at(prog, ref),
            "losses": [prog["losses"], ref["losses"]],
            "grad_total": total, "grad": ranked("grad"),
            "change": ranked("change")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--planted-seeds", default="",
                    help="faults planted in the reference: the loss over "
                         "half of the batch, and over one rank's rows")
    ap.add_argument("--bn-fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench-file", default=str(ROOT / "BENCHMARK.json"))
    ap.add_argument("--out", required=True,
                    help="a JSON-lines file the readings are appended to")
    args = ap.parse_args(argv)
    from types import SimpleNamespace

    from portbench.harness import load_cell
    from portbench.loops.fit import free
    cell = load_cell(args.bench_file, args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def session(seed):
        # a data-parallel cell's other ranks start as run.py with these
        argv = ["--workload", args.workload, "--seed", str(seed),
                "--seconds", str(args.seconds), "--trace", "0",
                "--device", args.device, "--bench-file", args.bench_file]
        return SimpleNamespace(cell=cell, seed=seed, seconds=args.seconds,
                               trace=0, device=args.device, argv=argv,
                               agree=lambda n: n, barrier=lambda: None)

    def emit(kind, seed, readings, extra=None):
        line = {"workload": args.workload, "kind": kind, "seed": seed,
                "readings": readings, **(extra or {})}
        print(json.dumps(line), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(line) + "\n")

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    for seed in seeds(args.seeds):
        t = time.perf_counter()
        m = cell.loop.run(session(seed))
        emit("program", seed, m["readings"],
             {"e2e": m["e2e"], "s": time.perf_counter() - t,
              **detail(m)})
        free()
    for seed in seeds(args.control_seeds):
        m = cell.loop.control(session(seed))
        emit("control", seed, m["readings"], detail(m))
        free()
    for seed in seeds(args.planted_seeds):
        from portbench.loops import fit
        tr = cell.traffic
        rows = tr["batch"] * tr.get("ranks", 1)
        plants = [("planted_half_batch", rows // 2)]
        if tr.get("ranks", 1) > 1:
            plants.append(("planted_exchange_left_out", tr["batch"]))
        for kind, n in plants:
            m = fit.planted(session(seed), n)
            emit(kind, seed, m["readings"], detail(m))
            free()
    for seed in seeds(args.fault_seeds):
        with half_batch():
            m = cell.loop.run(session(seed))
        emit("fault_half_batch", seed, m["readings"], detail(m))
        free()
    for seed in seeds(args.bn_fault_seeds):
        with batch_norm_left_behind():
            m = cell.loop.run(session(seed))
        emit("fault_batch_norm_left_behind", seed, m["readings"], detail(m))
        free()


if __name__ == "__main__":
    main()
