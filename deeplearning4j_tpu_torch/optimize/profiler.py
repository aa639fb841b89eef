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

The program's own spans follow a running profiler. `span(name)` marks a
phase of the hot path (the fit loop's steps and phases, each layer's
forward, BatchNorm's backward, the iterator's wait, scoring's stages;
ARCHITECTURE.md, "Observability", lists them); `follow(name)` does the
same at a step, a scored batch or an entry, and first checks whether a
profiler runs (`torch.autograd.profiler._is_profiler_enabled`), again at
its end. While none runs, a span is one attribute check returning a
shared no-op: no clock read, no event, no range. While one runs, a span
is recorded in `obs.TRACER`'s ring (whether the tracer is enabled or not;
its state is left as it was) and opens a `record_function` range of the
same name, so it lands in the device trace on that trace's clock; a span
given the device it times records a CUDA event on that device's current
stream at its start and at its end (the fit loop's phases, `output`'s
forward and BatchNorm's forward and backward do). The events are read
only by `program_spans()`: each span name's count, host seconds, self
host seconds (less its child spans on the same thread) and device
seconds, over the spans recorded since a profiler was last seen starting
(or `trace()` / `ProfilerListener` started one). So `trace(logdir)` and
a `ProfilerListener` window carry the program's spans.

Usage:
    from deeplearning4j_tpu_torch.optimize.profiler import (
        ProfilerListener, program_spans, summarize_trace, trace)
    with trace("build/prof"):
        net.fit(ds)
    for row in summarize_trace("build/prof")[:20]:
        print(row)
    print(program_spans()["train.forward"])
"""
from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

from ..obs import TRACER
from ..obs.trace import monotonic_ns
from .listeners import IterationListener

# the Chrome trace's categories of device work (kineto's names)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# the newest program spans `program_spans()` reads: ~270 ResNet-50 steps
SPAN_CAPACITY = 65536


class _Following:
    """Whether the program's spans record (`on`: a profiler ran at the
    last check) and what they recorded since a profiler was last seen
    starting (`records`: name, thread, start ns, duration ns and the two
    CUDA events or None). One per process, as the profiler it follows."""

    __slots__ = ("on", "records")

    def __init__(self):
        self.on = False
        self.records = collections.deque(maxlen=SPAN_CAPACITY)

    def check(self):
        running = _autograd_profiler._is_profiler_enabled
        if running and not self.on:
            self.records.clear()
        self.on = running


_FOLLOWING = _Following()
_OFF = contextlib.nullcontext()
# a `record_function` range through its C entry and exit: a fifth of the
# Python class's cost, the same user_annotation in the trace
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit
_STREAMS = {}       # raw CUDA stream -> its torch.cuda.Stream


def _timing_stream(device):
    """`device`'s current stream, or None where a span cannot time it: off
    the card, or inside a CUDA graph capture (an event there is a node of
    the graph, not a timestamp; the legacy default stream, raw 0, never
    captures)."""
    if device is None or device.type != "cuda":
        return None
    index = torch._C._cuda_getDevice() if device.index is None \
        else device.index
    raw = torch._C._cuda_getCurrentRawStream(index)
    if raw and torch.cuda.is_current_stream_capturing():
        return None
    stream = _STREAMS.get(raw)
    if stream is None:
        stream = _STREAMS[raw] = torch.cuda.current_stream(index)
    return stream


def _event(stream):
    """A timing CUDA event recorded on `stream` (the C base of
    `torch.cuda.Event`: no Python wrapper, not tracked by the collector)."""
    ev = torch._C._CudaEventBase(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    """A program span while a profiler runs (see the module docstring)."""

    __slots__ = ("name", "device", "cat", "args", "_range", "_stream",
                 "_ev0", "_t0")

    def __init__(self, name, device, cat, args):
        self.name, self.device, self.cat, self.args = name, device, cat, args

    def __enter__(self):
        self._range = _range_enter(self.name)
        stream = self._stream = (None if self.device is None
                                 else _timing_stream(self.device))
        self._ev0 = None if stream is None else _event(stream)
        self._t0 = monotonic_ns()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        dur = monotonic_ns() - t0
        ev1 = None if self._stream is None else _event(self._stream)
        _range_exit(self._range)
        thread = threading.current_thread()
        _FOLLOWING.records.append((self.name, thread.ident, t0, dur,
                                   self._ev0, ev1))
        TRACER.record(self.name, t0, dur, self.cat, thread.name, self.args)
        return False


def span(name, device=None, cat="program", tracer=False, **args):
    """A context manager marking one phase of the program: recorded while
    a profiler runs (as of the last `follow` check), a shared no-op
    otherwise. `device`: the torch.device whose current stream the span
    also times with CUDA events (None: host only). `tracer`: off the
    profiler the span is `obs.TRACER.span`'s, recorded while the tracer
    is enabled, as the fit loop's own spans always were."""
    if not _FOLLOWING.on:
        return TRACER.span(name, cat=cat, **args) if tracer else _OFF
    return _Span(name, device, cat, args or None)


class _Checked:
    __slots__ = ("_span",)

    def __init__(self, inner):
        self._span = inner

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        _FOLLOWING.check()
        return False


def follow(name, device=None, cat="program", tracer=False, **args):
    """`span` at a step, a scored batch or an entry of the program: check
    first whether a profiler runs, and again at the span's end, so spans
    start recording at the first step a profiler sees and stop at the
    step it stopped in."""
    _FOLLOWING.check()
    return _Checked(span(name, device, cat, tracer, **args))


def _self_ns(records):
    """Each record's duration less its direct children's on its thread
    (spans nest by time containment), in the records' order."""
    out = [r[3] for r in records]
    by_thread = defaultdict(list)
    for i, r in enumerate(records):
        by_thread[r[1]].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (records[i][2], -records[i][3]))
        open_ = []
        for i in idx:
            t0 = records[i][2]
            while open_ and records[open_[-1]][2] + records[open_[-1]][3] \
                    <= t0:
                open_.pop()
            if open_:
                out[open_[-1]] -= records[i][3]
            open_.append(i)
    return out


def program_spans():
    """{span name: {"count", "host_s", "self_s", "device_s"}} over the
    program spans recorded since a profiler was last seen starting: how
    many, their host seconds, their self host seconds (each less its
    child spans on the same thread) and their device seconds (the sum of
    their CUDA event intervals, waiting for the events here; None where
    no span of the name timed a device)."""
    records = list(_FOLLOWING.records)
    out = {}
    for r, self_ns in zip(records, _self_ns(records)):
        name, _, _, dur, ev0, ev1 = r
        row = out.setdefault(name, {"count": 0, "host_s": 0.0,
                                    "self_s": 0.0, "device_s": None})
        row["count"] += 1
        row["host_s"] += dur / 1e9
        row["self_s"] += self_ns / 1e9
        if ev0 is not None:
            ev1.synchronize()
            row["device_s"] = (row["device_s"] or 0.0) + \
                ev0.elapsed_time(ev1) / 1e3
    return out


def _start():
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    _FOLLOWING.records.clear()
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
