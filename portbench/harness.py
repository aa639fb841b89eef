"""What every run shares: the cell as the files name it, the session a
loop runs in, and the result line.

A cell is an entry of `BENCHMARK.json`'s `workloads`. Its configuration
file (`configs/`, by the entry of `configs`) names the model family
(`families/<family>.py`); its traffic file (`traffic/<traffic>.json`)
names the loop that drives it (`loops/<loop>.py`); its limits are in
`cells/<cell>.json` (data files under the benchmark file's first path); each per-layer metric is read by
`readers/<name before the first dot>.py`. Nothing here names a cell, a
configuration, a traffic mix or a metric.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


def _module(kind, name):
    return importlib.import_module(f"portbench.{kind}.{name}")


def load_cell(bench_file, workload):
    """The cell `workload` of the benchmark file, with its configuration,
    traffic, family, loop, limits and metrics."""
    root = Path(bench_file).resolve().parent
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_file}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    data = root / bench["paths"][0]
    traffic = json.loads((data / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((data / "cells" / f"{workload}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]

    return SimpleNamespace(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        family=_module("families", config["family"]),
        loop=_module("loops", traffic["loop"]),
        limits=limits["limits"], end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]))


def process_age():
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def note(what):
    """A progress line on standard error, with the process's age."""
    print(f"portbench {process_age():8.2f} s: {what}", file=sys.stderr,
          flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_per_layer(cell, ctx):
    """{metric: value} of the cell's per-layer metrics that found
    something to read."""
    out = {}
    for m in cell.per_layer:
        reader = _module("readers", m["name"].split(".")[0])
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, measured, trace, device_info):
    """The run's result: the end-to-end metrics (trace 0) or the
    per-layer ones (trace 1), the device, the breakdown of a traced run,
    and the numbers compared with their limits, last."""
    from .check import judge
    ok, rows = judge(measured["readings"], cell.limits)
    finite = measured["finite"]
    rows.append(("loss_finite", 1.0 if finite else 0.0, 1.0))
    ok = ok and finite
    if trace:
        metrics = read_per_layer(cell, measured["ctx"])
    else:
        metrics = {m["name"]: {"value": measured["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = dict(device_info)
    device["memory_peak_bytes"] = int(measured["memory_peak_bytes"])
    out = {"correct": bool(ok), "attempted": int(measured["attempted"]),
           "failed": int(measured["failed"]), "metrics": metrics,
           "device": device}
    if trace:
        ranks = measured["ctx"].ranks
        device["busy_s"] = sum(r["trace"]["busy_s"] for r in ranks) / len(
            ranks)
        device["window_s"] = sum(r["trace"]["window_s"] for r in ranks) / len(
            ranks)
        first = ranks[0]["trace"]
        out["breakdown"] = {"device_ops": [list(x) for x in first["top_ops"]],
                            "idle_gaps": [list(x) for x in first["idle_gaps"]]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out, rows


def device_info(device, count):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count}
    return {"platform": "cpu", "kind": "cpu", "count": count}
