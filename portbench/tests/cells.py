"""Running a cell inside the test's process, on the CPU: what `run.py`
does after its look for a card."""
from __future__ import annotations

from types import SimpleNamespace

from portbench.harness import load_cell, result_line, device_info


def session(bench_file, workload, seed, seconds=0.5, trace=0):
    return SimpleNamespace(cell=load_cell(bench_file, workload), seed=seed,
                           seconds=seconds, trace=trace, device="cpu",
                           argv=[], agree=lambda n: n, barrier=lambda: None)


def result(s, measured):
    out, _ = result_line(s.cell, measured, s.trace,
                            device_info("cpu", s.cell.chips))
    return out


def run(bench_file, workload, seed, seconds=0.5, trace=0):
    s = session(bench_file, workload, seed, seconds, trace)
    return result(s, s.cell.loop.run(s))
