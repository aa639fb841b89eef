"""The device profiler: port of deeplearning4j_tpu/optimize/profiler.py
over `torch.profiler`.

The reference's listeners (PerformanceListener) say *that* iterations are
slow; a device trace says *why*. `trace(logdir)` records the host's and
the card's activity (CUPTI) and writes a Chrome trace (`*.pt.trace.json`,
the format `torch.profiler` exports) under `logdir`; `ProfilerListener`
records a steady-state window of training iterations, not the first
steps that pay cuDNN's search; `summarize_trace` aggregates the device
lanes' kernel, memcpy and memset time of the newest trace, with no UI.

The reference also parses XLA's `.xplane.pb` when its JSON has no device
lane; torch writes no XPlane, so that branch has no counterpart here: a
trace without a device lane raises.

Usage:
    from deeplearning4j_tpu_torch.optimize.profiler import (
        ProfilerListener, summarize_trace, trace)
    with trace("build/prof"):
        net.fit(ds)
    for row in summarize_trace("build/prof")[:20]:
        print(row)
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import socket
import time
from collections import defaultdict

import torch

from .listeners import IterationListener

# the Chrome trace's categories of device work (kineto's names)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _start():
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop(prof, logdir):
    """Stop `prof` and write its Chrome trace under `logdir`; returns the
    file's path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir):
    """Record the host's and the card's activity inside the block into a
    Chrome trace under `logdir`."""
    logdir = str(logdir)
    prof = _start()
    try:
        yield logdir
    finally:
        _stop(prof, logdir)


class ProfilerListener(IterationListener):
    """Trace a steady-state window of training iterations: start at the
    `start_iteration`-th call, stop `num_iterations` calls later (after a
    `torch.cuda.synchronize()` when the network is on the card, so the
    window holds the device work it queued)."""

    def __init__(self, logdir, start_iteration=5, num_iterations=3):
        self.logdir = str(logdir)
        self.start_iteration = int(start_iteration)
        self.num_iterations = int(num_iterations)
        self._seen = 0
        self._prof = None
        self.done = False
        self.path = None

    def iteration_done(self, model, iteration):
        self._seen += 1
        if self.done:
            return
        if self._prof is None and self._seen >= self.start_iteration:
            self._prof = _start()
            self._stop_at = self._seen + self.num_iterations
        elif self._prof is not None and self._seen >= self._stop_at:
            device = getattr(model, "device", None)
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.path = _stop(self._prof, self.logdir)
            self._prof = None
            self.done = True


def _find(logdir):
    """The trace files under `logdir`, oldest first."""
    paths = [p for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(str(logdir), "**", pattern),
                                recursive=True)]
    return sorted(paths, key=lambda p: (os.path.getmtime(p), p))


def _rows_from_totals(totals, counts):
    grand = sum(totals.values()) or 1.0
    rows = [{"name": k, "total_ms": round(v, 3), "count": counts[k],
             "pct": round(100.0 * v / grand, 2)}
            for k, v in totals.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def _merge_name(name, merge):
    # the reference's rule: cut at the first "." so that numbered fusions
    # ("fusion.123") aggregate; a CUDA kernel name with a dot inside its
    # template arguments is cut there too (merge_fusion_names=False keeps
    # every name whole)
    return name.split(".")[0] if (merge and name) else name


def _device_pids(events):
    """The pids of the trace's device lanes: kineto names them "GPU <n>"
    (process_name, process_labels)."""
    pids = set()
    for ev in events:
        if ev.get("ph") != "M" or ev.get("name") not in ("process_name",
                                                          "process_labels"):
            continue
        args = ev.get("args", {})
        label = str(args.get("name", args.get("labels", "")))
        if "GPU" in label and "host" not in label.lower():
            pids.add(ev.get("pid"))
    return pids


def summarize_trace(logdir, merge_fusion_names=True):
    """Aggregate the device time of the newest trace under `logdir`.

    Returns a list of dicts sorted by total device time, descending:
    {"name", "total_ms", "count", "pct"}, ms rounded to 3 places and the
    share to 2, over the kernel, memcpy and memset events of the device
    lanes. Raises RuntimeError when there is no trace, or the trace holds
    no device lane or no device event."""
    paths = _find(logdir)
    if not paths:
        raise FileNotFoundError(f"no .pt.trace.json under {logdir}")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as fh:
        data = json.load(fh)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    device_pids = _device_pids(events)
    totals = defaultdict(float)
    counts = defaultdict(int)
    for ev in events:
        if (ev.get("ph") != "X" or ev.get("pid") not in device_pids
                or ev.get("cat") not in DEVICE_CATEGORIES):
            continue
        name = _merge_name(ev.get("name", ""), merge_fusion_names)
        totals[name] += ev.get("dur", 0) / 1000.0   # us -> ms
        counts[name] += 1
    if not totals:
        raise RuntimeError(f"no device lane with device events in "
                           f"{paths[-1]} (a trace of the CPU only?)")
    return _rows_from_totals(totals, counts)
