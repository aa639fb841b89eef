"""Span tracer: monotonic-clock spans in a lock-light bounded ring.

The port's copy of deeplearning4j_tpu/obs/trace.py (stdlib only), held against it
by tests/test_torch_*.py; the text below is the reference's. The port adds
`Tracer.record`, through which its profiler-following spans
(`optimize.profiler.span`) land in the ring whatever the tracer's state.

Dapper-style (Sigelman et al., 2010) host-side tracing for both servers
and the training fit loops: a span is (name, category, track, trace_id,
start_ns, duration_ns, args), timed with `time.monotonic_ns()` and
appended to a bounded `collections.deque` — CPython deque appends are
atomic under the GIL, so the hot path takes NO lock and old spans fall
off the far end instead of growing memory. Spans export as Chrome
trace-event JSON (`chrome_trace()` / `save()`) that loads directly in
Perfetto or chrome://tracing; nesting comes from time containment on a
track, so a request's `queue_wait` span draws inside its `request` span.

Contracts (pinned by tests/test_obs.py):

  * Disabled is free. `span()`/`emit()` on a disabled tracer is a single
    attribute check returning a shared no-op — nanosecond-scale, no
    allocation, no clock read. Serving and training ship with tracing
    OFF and pay nothing.
  * Zero device work. This module (the whole obs/ package) never imports
    jax or numpy: recording a span can never add a device dispatch. The
    only device interaction is the OPTIONAL flight-recorder seam, which
    takes `optimize.profiler.trace` as an injected callable.

Tracks map to Chrome trace "threads": give request-scoped spans
`track=f"req-{id}"` and scheduler spans `track="server"` so concurrent
requests render as parallel lanes instead of false nesting.

`FlightRecorder` makes SLO violations self-document: feed it request
latencies, and when the rolling p99 crosses the threshold it arms the
tracer for the next N spans (and optionally starts a jax.profiler device
trace through the injected seam), storing the capture for post-mortem.
"""
from __future__ import annotations

import collections
import datetime
import json
import threading
import time

monotonic_ns = time.monotonic_ns

Span = collections.namedtuple(
    "Span", ["name", "cat", "track", "trace_id", "t0_ns", "dur_ns", "args"])


class TraceContext(collections.namedtuple(
        "TraceContext", ["trace_id", "parent_span", "origin"])):
    """The cross-process trace baton (Dapper's propagated context):
    `trace_id` identifies the request across every process that ever
    served it, `parent_span` names the lane (`req-<id>`) the
    continuation should extend, `origin` names the instance that
    emitted the context. It rides the `RequestArtifact` manifest
    through preempt/migrate (serving/kvstate.py) as a plain dict —
    `to_manifest()`/`from_manifest()` — so the wire format stays
    JSON and the destination server can continue the request's lane
    under the SAME trace id, making a migrated request read as one
    timeline after `obs.fleet.merge_traces`."""

    __slots__ = ()

    def to_manifest(self):
        return {"trace_id": self.trace_id,
                "parent_span": self.parent_span,
                "origin": self.origin}

    @classmethod
    def from_manifest(cls, d):
        """None-tolerant: artifacts written before trace propagation
        (or by a producer that never traced) read as no context."""
        if not d or d.get("trace_id") is None:
            return None
        return cls(d.get("trace_id"), d.get("parent_span"),
                   d.get("origin"))


class _Noop:
    """Shared do-nothing context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_cat", "_track", "_trace_id",
                 "_args", "_t0")

    def __init__(self, tracer, name, cat, track, trace_id, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._trace_id = trace_id
        self._args = args

    def __enter__(self):
        self._t0 = monotonic_ns()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        self._tracer.emit(self._name, t0, monotonic_ns() - t0,
                          cat=self._cat, track=self._track,
                          trace_id=self._trace_id, args=self._args)
        return False


class Tracer:
    """Bounded span recorder; disabled by default."""

    def __init__(self, capacity=16384, enabled=False, instance=None):
        self._buf = collections.deque(maxlen=int(capacity))
        self._enabled = bool(enabled)
        # instance name: the default process_name of this tracer's
        # chrome_trace() export. A fleet names its replicas' tracers so
        # obs.fleet.merge_traces renders each as its own process group.
        self.instance = None if instance is None else str(instance)
        self._auto = None        # [remaining, restore_enabled, callback]
        self._lock = threading.Lock()    # export/clear only, never emit
        # wallclock anchor: ONE (wall_ns, monotonic_ns) pair captured at
        # construction. Span timestamps stay monotonic (immune to NTP
        # steps); the anchor lets chrome_trace() emit a `clock_sync`
        # metadata event so two saved traces — different runs, different
        # processes — can be aligned on the wall clock in Perfetto.
        self._wall_anchor = (time.time_ns(), monotonic_ns())

    @property
    def enabled(self):
        return self._enabled

    def enable(self):
        self._enabled = True
        return self

    def disable(self):
        self._enabled = False
        return self

    def enable_for(self, n_spans, on_done=None, restore=None):
        """Flight-recorder arm: record the next `n_spans` spans, then
        restore the previous enabled state (or the explicit `restore`
        value) and call `on_done()`. A tracer that was already enabled
        stays enabled afterwards."""
        self._auto = [int(n_spans),
                      self._enabled if restore is None else bool(restore),
                      on_done]
        self._enabled = True
        return self

    # -- hot path ------------------------------------------------------
    def span(self, name, cat="host", track=None, trace_id=None, **args):
        """Context manager timing one span. Disabled: returns a shared
        no-op without reading the clock or allocating."""
        if not self._enabled:
            return _NOOP
        return _SpanCtx(self, name, cat, track, trace_id, args or None)

    def emit(self, name, t0_ns, dur_ns, cat="host", track=None,
             trace_id=None, args=None):
        """Record one completed span with explicit timing — for spans
        whose start was a plain timestamp taken before the outcome was
        known (queue wait: t_submit -> batch formation)."""
        if not self._enabled:
            return
        self._buf.append(Span(name, cat, track, trace_id,
                              int(t0_ns), int(dur_ns), args))
        if self._auto is not None:
            self._tick_auto()

    def _tick_auto(self):
        """Flight-recorder countdown. Only runs while a capture is armed
        (the steady-state emit path never takes a lock); the lock makes
        the decrement atomic so concurrent emitters can neither strand
        the capture (lost decrement -> tracer enabled forever) nor fire
        the completion callback twice. The callback runs OUTSIDE the
        lock — it reads the span buffer through spans(), which takes it."""
        with self._lock:
            auto = self._auto
            if auto is None:        # another emitter already completed it
                return
            auto[0] -= 1
            if auto[0] > 0:
                return
            self._auto = None
            self._enabled = auto[1]
            cb = auto[2]
        if cb is not None:
            cb()

    def record(self, name, t0_ns, dur_ns, cat="host", track=None,
               args=None):
        """Record one completed span whether or not the tracer is
        enabled: for spans whose caller already decided to record them
        (the port's spans that follow a running device profiler,
        `optimize.profiler.span`). Does not count toward an armed
        flight-recorder capture."""
        self._buf.append(Span(name, cat, track, None, int(t0_ns),
                              int(dur_ns), args))

    def instant(self, name, cat="host", track=None, **args):
        """Zero-duration marker (flight-recorder trigger, swap installed,
        rollback landed)."""
        if not self._enabled:
            return
        self._buf.append(Span(name, cat, track, None,
                              monotonic_ns(), 0, args or None))

    # -- read-out ------------------------------------------------------
    def spans(self, name=None):
        with self._lock:
            out = list(self._buf)
        return out if name is None else [s for s in out if s.name == name]

    def clear(self):
        with self._lock:
            self._buf.clear()

    def __len__(self):
        return len(self._buf)

    def chrome_trace(self, process_name=None, pid=0):
        """Chrome trace-event JSON (loads in Perfetto / chrome://tracing):
        one complete ("ph":"X") event per span, ts/dur in microseconds
        rebased to the earliest span, tracks mapped to tids with
        thread_name metadata so lanes are labeled. Every event carries
        an EXPLICIT `pid` (default 0, schema-compatible with every
        existing consumer) and the `process_name` metadata defaults to
        the tracer's `instance` name when one was set — so a
        multi-server merge (`obs.fleet.merge_traces`) renders each
        instance as its own labeled process group in Perfetto.

        A `clock_sync` metadata event anchors ts=0 to the wall clock
        (`wallclock_ns_at_ts0`): spans are timed on the bare monotonic
        clock, whose zero is arbitrary per boot/process, so WITHOUT the
        anchor two saved traces cannot be aligned. To overlay trace B on
        trace A in Perfetto, shift B's events by
        (B.wallclock_ns_at_ts0 - A.wallclock_ns_at_ts0) / 1e3 us —
        exactly what merge_traces does."""
        if process_name is None:
            process_name = self.instance or "deeplearning4j_tpu"
        pid = int(pid)
        spans = self.spans()
        wall_ns, mono_ns = self._wall_anchor
        base = min((s.t0_ns for s in spans), default=mono_ns)
        tracks = {}
        for s in spans:
            tracks.setdefault(s.track or "main", len(tracks))
        wall_at_base = wall_ns + (base - mono_ns)
        sync_args = {
            "wallclock_ns_at_ts0": wall_at_base,
            "monotonic_ns_at_ts0": base,
            "wallclock_iso": datetime.datetime.fromtimestamp(
                wall_at_base / 1e9,
                datetime.timezone.utc).isoformat()}
        if self.instance is not None:
            sync_args["instance"] = self.instance
        events = [{"ph": "M", "pid": pid, "tid": 0,
                   "name": "process_name",
                   "args": {"name": process_name}},
                  {"ph": "M", "pid": pid, "tid": 0, "name": "clock_sync",
                   "args": sync_args}]
        for track, tid in tracks.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": track}})
        for s in spans:
            args = dict(s.args) if s.args else {}
            if s.trace_id is not None:
                args["trace_id"] = s.trace_id
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": (s.t0_ns - base) / 1e3, "dur": s.dur_ns / 1e3,
                "pid": pid, "tid": tracks[s.track or "main"],
                "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path, process_name=None, pid=0):
        """Write the Chrome trace JSON to `path` (open in Perfetto)."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(process_name, pid=pid), fh)
        return path


class FlightRecorder:
    """Capture-on-SLO-violation: arm the tracer when rolling p99 degrades.

    Feed request latencies via `observe(latency_ms)` (the serving loops
    do this on every completion when a recorder is attached). Over a
    rolling window of `window` samples, once at least `min_samples` have
    arrived and the window p99 crosses `threshold_ms`, the recorder:

      1. marks the trigger (`tracer.instant("flight.trigger")`),
      2. arms the tracer for the next `capture_spans` spans
         (`enable_for` — a tracer that was already on stays on), and
      3. optionally starts a device trace through `device_tracer`, a
         `contextmanager(logdir)` callable — pass
         `optimize.profiler.trace` to capture a jax.profiler window; the
         obs package itself never imports jax.

    When the capture completes, the spans are snapshotted into
    `captures` (bounded) so the violation self-documents even if the
    ring has since wrapped. `cooldown_s` rate-limits re-triggering."""

    def __init__(self, tracer, threshold_ms, window=256, min_samples=32,
                 capture_spans=512, cooldown_s=30.0, max_captures=8,
                 device_tracer=None, device_trace_dir=None):
        self.tracer = tracer
        self.threshold_ms = float(threshold_ms)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.capture_spans = int(capture_spans)
        self.cooldown_s = float(cooldown_s)
        self.device_tracer = device_tracer
        self.device_trace_dir = device_trace_dir
        self._lat = collections.deque(maxlen=self.window)
        self._above = 0     # samples in the window at/over the threshold
        self._lock = threading.Lock()
        self._capturing = False
        self._last_trigger = None
        self._device_ctx = None
        self.captures = collections.deque(maxlen=int(max_captures))
        self.triggers = 0

    def rolling_p99(self):
        from .registry import percentile
        with self._lock:
            vals = sorted(self._lat)
        return percentile(vals, 99)

    def observe(self, latency_ms):
        """Record one request latency; trigger a capture when the rolling
        p99 crosses the threshold. O(1) except on the (rare) trigger."""
        from .registry import percentile
        with self._lock:
            latency_ms = float(latency_ms)
            # O(1) count of over-threshold samples currently in the
            # window (the deque evicts silently, so track the evictee
            # ourselves). The p99 sort only runs while at least one such
            # sample is in the window — and a violation that arrived
            # earlier keeps arming the check until it ages out, so
            # fast-requests-after-a-spike can still trigger (the spike
            # IS the p99).
            if len(self._lat) == self._lat.maxlen and \
                    self._lat[0] >= self.threshold_ms:
                self._above -= 1
            self._lat.append(latency_ms)
            if latency_ms >= self.threshold_ms:
                self._above += 1
            if (self._capturing
                    or len(self._lat) < self.min_samples
                    or self._above == 0):
                return
            now = time.monotonic()
            if (self._last_trigger is not None
                    and now - self._last_trigger < self.cooldown_s):
                return
            p99 = percentile(sorted(self._lat), 99)
            if p99 < self.threshold_ms:
                return
            self._capturing = True
            self._last_trigger = now
            self.triggers += 1
        self._trigger(p99)

    def _trigger(self, p99):
        if self.device_tracer is not None and \
                self.device_trace_dir is not None:
            try:
                self._device_ctx = self.device_tracer(
                    self.device_trace_dir)
                self._device_ctx.__enter__()
            except Exception:       # device trace is best-effort
                self._device_ctx = None
        # remember the PRE-trigger state before enabling for the marker:
        # a tracer the recorder itself turned on must turn back off when
        # the capture completes
        prev = self.tracer.enabled
        self.tracer.enable()        # marker must land in the ring
        self.tracer.instant("flight.trigger", cat="flight",
                            p99_ms=round(p99, 3),
                            threshold_ms=self.threshold_ms)
        self.tracer.enable_for(self.capture_spans, on_done=self._on_done,
                               restore=prev)

    def _on_done(self):
        if self._device_ctx is not None:
            try:
                self._device_ctx.__exit__(None, None, None)
            except Exception:
                pass
            self._device_ctx = None
        spans = self.tracer.spans()[-(self.capture_spans + 1):]
        p99 = self.rolling_p99()
        with self._lock:
            self.captures.append({
                "p99_ms": p99,
                "threshold_ms": self.threshold_ms,
                "spans": spans,
                "device_trace_dir": (self.device_trace_dir
                                     if self.device_tracer else None)})
            self._capturing = False
