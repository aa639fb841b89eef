"""A traced window: `torch.profiler` over a few of the loop's own steps,
reduced to what the per-layer readers read.

`_kernel_kind`, `_gpu_intervals` and `_union` are copies of
`chip_smoke.py`'s (the busy-interval union and the kernel-kind classifier
its phases 17 and 20 report); the benchmark keeps its own so that it
reads traces alike whatever happens to the smoke.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

WINDOW = "portbench.window"


def _kernel_kind(name):
    """A device kernel's kind, from its name (cuDNN, cuBLAS and ATen's)."""
    kinds = (("pooling", ("pool",)), ("reduction", ("reduce_kernel",)),
             ("copy or cast", ("copy",)),
             ("convolution", ("fprop", "dgrad", "wgrad", "implicit", "conv",
                              "cudnn")),
             ("matrix product", ("gemm", "gemv", "xmma", "cutlass",
                                 "nvjet")),
             ("elementwise", ("elementwise",)))
    for kind, keys in kinds:
        if any(k in name for k in keys):
            return kind
    return "other"


def kernel_kind(name):
    """`_kernel_kind`, with NCCL's kernels apart."""
    if "nccl" in name.lower():
        return "collective"
    return _kernel_kind(name)


def _gpu_intervals(trace, window):
    """(kernels by stream, host-to-device copies as (stream, t0, t1)) of a
    chrome trace, clipped to window = (t0, t1), in us."""
    lo, hi = window
    kernels, copies = {}, []
    for e in trace:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                       "gpu_memset"):
            continue
        t0, t1 = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if t1 <= t0:
            continue
        stream = e.get("args", {}).get("stream")
        if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            copies.append((stream, t0, t1))
        else:
            kernels.setdefault(stream, []).append((t0, t1))
    return kernels, copies


def _union(intervals):
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


@contextlib.contextmanager
def traced(device):
    """Profile the body (CPU and CUDA activities) inside a range named
    `WINDOW`; the profiler is left in `box[0]`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    box = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield box
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    box.append(prof)


def load_events(prof):
    """The profiler's chrome-trace events (written to a file under the
    temporary directory, read and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _short(name, n=100):
    return name if len(name) <= n else name[:n]


def summarize(events, steps):
    """What the readers take from one traced window of `steps` steps:
    its length and busy time (the union of every device operation), the
    kernels' count and device seconds by kind and by name, and the idle
    gaps, each named by what the training thread was doing on the host
    when it began."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no window range")
    lo = win[0]["ts"]
    hi = lo + win[0]["dur"]
    tid = win[0]["tid"]
    kernels, copies = _gpu_intervals(events, (lo, hi))
    busy = _union([iv for ivs in kernels.values() for iv in ivs]
                  + [(t0, t1) for _, t0, t1 in copies])
    by_kind, by_name, n_kernels = {}, {}, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        t0, t1 = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if t1 <= t0:
            continue
        n_kernels += 1
        s = (t1 - t0) / 1e6
        kind = kernel_kind(e["name"])
        by_kind[kind] = by_kind.get(kind, 0.0) + s
        key = _short(e["name"])
        by_name[key] = by_name.get(key, 0.0) + s
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("tid") == tid
                   and e.get("cat") in ("cpu_op", "user_annotation",
                                        "cuda_runtime", "cuda_driver")
                   and e.get("name") != WINDOW), key=lambda h: h[0])

    def doing(t):
        """The innermost host range of the training thread open at t."""
        best = None
        for h0, h1, name in host:
            if h0 > t:
                break
            if h1 >= t:
                best = name
        return best or "host: outside any traced range"

    gaps = []
    prev = lo
    for t0, t1 in busy + [[hi, hi]]:
        if t0 > prev:
            gaps.append((prev, t0))
        prev = max(prev, t1)
    gaps.sort(key=lambda g: g[0] - g[1])
    busy_s = sum(t1 - t0 for t0, t1 in busy) / 1e6
    return {
        "steps": steps,
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_s,
        "kernels": n_kernels,
        "by_kind_s": by_kind,
        "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[_short(doing(g0)), (g1 - g0) / 1e6]
                      for g0, g1 in gaps[:10]],
    }
