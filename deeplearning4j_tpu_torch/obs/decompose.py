"""Span-derived latency decomposition: where did each request's time go?

The port's copy of deeplearning4j_tpu/obs/decompose.py (stdlib only), held against it
by tests/test_torch_*.py; the text below is the reference's.

The PR 6 tracer already records the full serving timeline — a
`serve.request` span per request on its own `req-<id>` lane, its
`serve.queue_wait` (closed at batch formation / slot admission), the
`decode.prefill` dispatch tagged with the request's trace id, and the
shared server-lane dispatch windows (`decode.dispatch` /
`decode.verify` / `serve.dispatch`). This module walks those lanes
post-hoc and attributes each completed request's total latency to four
phases:

  * `queue_wait_ms` — submit -> admission (the `serve.queue_wait` span;
    queueing pressure, the thing arrival rate controls);
  * `prefill_ms`    — the request's OWN prompt prefill (zero for the
    micro-batch server, which has no prefill phase);
  * `decode_ms`     — time inside device-dispatch windows overlapping
    the request's active window (admission -> completion);
  * `sched_gap_ms`  — the remainder: host scheduling, batch formation,
    and OTHER requests' prefills stalling this request's decode. A fat
    sched_gap under load is exactly the head-of-line signal the
    chunked-prefill round exists to attack.

The server lane is single-threaded, so its spans never overlap each
other: after clipping every term to the request's active window the four
phases partition the total (fractions sum to 1, up to clock jitter).

Input is anything `tools/obs_report.py` accepts — a live `Tracer`, a
list of `Span` tuples (e.g. a flight-recorder capture), or a saved
Chrome trace dict. Stdlib-only like the rest of obs/: the analyzer runs
post-hoc on host data and can never add a device dispatch.
"""
from __future__ import annotations

from .registry import fmt, percentile

__all__ = ["decompose", "decompose_requests"]

# server-lane spans that represent a device dispatch in flight (prefill
# is named separately so it can be attributed as its own phase)
_BUSY_NAMES = ("decode.dispatch", "decode.verify", "serve.dispatch")
_PHASES = ("queue_wait_ms", "prefill_ms", "decode_ms", "sched_gap_ms")


def _normalize(spans_or_trace):
    """-> list of {name, t0, dur, trace_id, pid} dicts in MILLISECONDS
    on one consistent clock (monotonic for live spans, rebased for a
    saved Chrome trace — decomposition only ever subtracts timestamps
    from the same source, so the two bases never mix). `pid` carries
    the trace's process group (0 for live spans / single traces): a
    MERGED multi-instance trace (obs.fleet.merge_traces) has one
    single-threaded server lane PER instance, so busy windows and
    request lanes must attribute within their own pid — pooling them
    would charge every request with the other replicas' concurrent
    dispatch windows."""
    if spans_or_trace is None:
        return []
    if hasattr(spans_or_trace, "spans"):        # Tracer
        spans_or_trace = spans_or_trace.spans()
    out = []
    if isinstance(spans_or_trace, dict):        # chrome trace JSON
        for e in spans_or_trace.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            args = e.get("args") or {}
            out.append({"name": e.get("name"),
                        "t0": e.get("ts", 0) / 1e3,
                        "dur": e.get("dur", 0) / 1e3,
                        "trace_id": args.get("trace_id"),
                        "pid": e.get("pid", 0)})
    else:
        for s in spans_or_trace:                # Span namedtuples
            out.append({"name": s.name, "t0": s.t0_ns / 1e6,
                        "dur": s.dur_ns / 1e6, "trace_id": s.trace_id,
                        "pid": 0})
    return out


def _overlap(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def decompose_requests(spans_or_trace):
    """Per-request phase attribution: one row per `serve.request` span,
    sorted by request start time. Rows carry the four phase durations
    plus `total_ms`; phases are clipped to the request's window so they
    partition the total."""
    evs = _normalize(spans_or_trace)
    # keyed by (pid, trace_id): a merged fleet trace carries one
    # single-threaded server lane PER process group, and a MIGRATED
    # request's trace id legitimately appears on two pids (one
    # serve.request per instance that served it) — each attributes
    # against its OWN instance's busy windows only
    reqs, queues, prefills, busy = {}, {}, {}, {}
    for e in evs:
        key = (e["pid"], e["trace_id"])
        if e["name"] == "serve.request" and e["trace_id"] is not None:
            reqs[key] = e
        elif e["name"] == "serve.queue_wait" and \
                e["trace_id"] is not None:
            queues[key] = e
        elif e["name"] == "decode.prefill":
            prefills.setdefault(key, []).append(e)
        elif e["name"] in _BUSY_NAMES:
            busy.setdefault(e["pid"], []).append(
                (e["t0"], e["t0"] + e["dur"]))
    for windows in busy.values():
        windows.sort()
    rows = []
    for (pid, tid), req in sorted(reqs.items(),
                                  key=lambda kv: kv[1]["t0"]):
        total = req["dur"]
        t0, t1 = req["t0"], req["t0"] + total
        qw = min(queues[(pid, tid)]["dur"], total) \
            if (pid, tid) in queues else 0.0
        win0 = t0 + qw          # active window: admission -> completion
        pf = sum(_overlap(p["t0"], p["t0"] + p["dur"], win0, t1)
                 for p in prefills.get((pid, tid), ()))
        dec = sum(_overlap(b0, b1, win0, t1)
                  for b0, b1 in busy.get(pid, ()))
        gap = max(0.0, total - qw - pf - dec)
        rows.append({"trace_id": tid, "total_ms": total,
                     "queue_wait_ms": qw, "prefill_ms": pf,
                     "decode_ms": dec, "sched_gap_ms": gap})
    return rows


def decompose(spans_or_trace):
    """Aggregate decomposition: per-phase total/mean/p50/p99 over every
    completed request plus each phase's fraction of total request time.
    The shape `tools/obs_report.py` renders and `tools/load_sweep.py`
    ships in its combined report."""
    rows = decompose_requests(spans_or_trace)
    out = {"n_requests": len(rows), "phases": {}, "fractions": {},
           "requests": rows}
    if not rows:
        return out
    grand = sum(r["total_ms"] for r in rows) or 1e-12
    for ph in _PHASES + ("total_ms",):
        vals = sorted(r[ph] for r in rows)
        tot = sum(vals)
        out["phases"][ph] = {
            "total_ms": fmt(tot), "mean_ms": fmt(tot / len(vals)),
            "p50_ms": fmt(percentile(vals, 50)),
            "p99_ms": fmt(percentile(vals, 99))}
        if ph != "total_ms":
            out["fractions"][ph] = fmt(tot / grand, 4)
    return out
