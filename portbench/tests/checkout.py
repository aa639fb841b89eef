"""A checkout for the tests: the benchmark's files, the extension's files
added beside them (`extension/`: toy configurations, traffic, limits and
a per-layer reader) and its entries added to BENCHMARK.json, with the
program linked in. Adding them edits no file that is already there."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
EXT = PB / "tests" / "extension"


def make(tmp, with_program=True, extension=True):
    tmp = Path(tmp)
    shutil.copytree(PB, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if extension:
        for sub in ("configs", "traffic", "cells", "readers"):
            for f in (EXT / sub).iterdir():
                dest = tmp / "portbench" / sub / f.name
                if dest.exists():
                    raise FileExistsError(dest)
                shutil.copy(f, dest)
        add = json.loads((EXT / "entries.json").read_text())
        bench["configs"] += add["configs"]
        bench["workloads"] += add["workloads"]
        bench["per_layer"] += add["per_layer"]
        for key in ("end_to_end", "per_layer"):
            for m in bench[key]:
                m.get("workloads", []).extend(
                    add[f"{key}_workloads"].get(m["name"], []))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    if with_program:
        (tmp / "deeplearning4j_tpu_torch").symlink_to(
            ROOT / "deeplearning4j_tpu_torch")
    return tmp
