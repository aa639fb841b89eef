"""Spreads of a cell's two sets of runs and the bounds they give, from
result lines gathered as JSON lines of {"cell", "tag": "A" | "B" | ..., "seed",
"trace", "line": <the run's result>} (lines without "cell" are grouped by
their metrics' names).

    python3 portbench/tools/spread.py runs.jsonl [--skip-first]

For each end-to-end metric: each set's median and spread (the quartile
distance over the median, as `statistics.quantiles(n=4)` gives it), the
same with each set's run farthest from the median left out, the bound
five times the wider spread (at least 1%), and the second set's median
against the first's.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

from portbench.stats import spread  # noqa: E402


def without_farthest(xs):
    med = statistics.median(xs)
    far = max(range(len(xs)), key=lambda i: abs(xs[i] - med))
    return xs[:far] + xs[far + 1:]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("runs")
    args = ap.parse_args(argv)
    rows = [json.loads(x) for x in Path(args.runs).read_text().splitlines()
            if x.strip()]
    cells = {}
    for r in rows:
        if r.get("trace") == 0 and r.get("line"):
            key = r.get("cell") or " ".join(sorted(r["line"]["metrics"]))
            cells.setdefault(key, {}).setdefault(r["tag"], []).append(
                r["line"])
    for key, sets in cells.items():
        print(f"== {key}")
        report(sets)


def report(sets):
    names = sorted({m for lines in sets.values() for line in lines
                    for m in line["metrics"]})
    for name in names:
        print(name)
        widest = 0.0
        meds = {}
        for tag in sorted(sets):
            xs = [line["metrics"][name]["value"] for line in sets[tag]]
            if len(xs) < 3:
                continue
            meds[tag] = statistics.median(xs)
            sp, sp5 = spread(xs), spread(without_farthest(xs))
            widest = max(widest, sp)
            print(f"  set {tag}: n {len(xs)} median {meds[tag]!r} spread "
                  f"{sp:.4%} (without the farthest {sp5:.4%}) "
                  f"min {min(xs)!r} max {max(xs)!r}")
        if len(meds) >= 2:
            a, b = [meds[t] for t in sorted(meds)[:2]]
            print(f"  second median over first: {b / a - 1:+.4%}")
        print(f"  widest spread {widest:.4%}: bound 5x = "
              f"{max(0.01, 5 * widest):.4f}")
    for tag in sorted(sets):
        bad = [line for line in sets[tag] if not line["correct"]]
        print(f"set {tag}: {len(sets[tag])} runs, {len(bad)} not correct")


if __name__ == "__main__":
    main()
