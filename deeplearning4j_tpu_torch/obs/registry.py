"""MetricsRegistry — the one named surface every subsystem publishes
through.

The port's copy of deeplearning4j_tpu/obs/registry.py (stdlib only), held against it
by tests/test_torch_*.py; the text below is the reference's.

Before this module each subsystem grew its own ad-hoc counters:
`ServingMetrics` kept a Counter + deques, the training-health policy a
dict, the PS transport logged retries, the async iterator exposed
nothing. The registry generalizes the counter/gauge/reservoir machinery
ServingMetrics proved out into one shared, named, thread-safe store:

  * `Counter`  — monotonically increasing int (requests, retries, sheds,
    dispatches, health skips).
  * `Gauge`    — last-written value (queue depth, slot occupancy).
  * `Reservoir`— bounded deque of recent samples with nearest-rank
    percentiles (latency p50/p99) — RECENT percentiles, not all-time,
    exactly the ServingMetrics window semantics.
  * `Histogram` — FIXED-BUCKET cumulative distribution (Prometheus
    `histogram` kind: `_bucket{le=...}` / `_sum` / `_count`). Unlike a
    reservoir, bucket counts are all-time, mergeable across scrapes /
    processes, and scrape as a real distribution; `quantile()` is the
    classic interpolate-within-bucket estimate — resolution bounded by
    the bucket grid, which is the price of aggregability. The serving
    SLO metrics (TTFT, inter-token latency, the load-sweep read-outs)
    use this kind.

Export surfaces:
  * `snapshot()`        — flat JSON-able dict (the UI-storage shape).
  * `prometheus_text()` — Prometheus text exposition format, served by
    `ui/server.py`'s `/metrics` route (counters as `counter`, gauges as
    `gauge`, reservoirs as `summary` with quantile labels).

Constraints (pinned by tests/test_obs.py):
  * stdlib-only — no jax, no numpy. Publishing a metric can NEVER add a
    device dispatch, and the module stays importable everywhere the
    stdlib-only resilience layer is (numpy-free PS workers).
  * O(1), lock-light hot path: one small lock per metric object, none on
    reads of counters (int read is atomic under the GIL).
"""
from __future__ import annotations

import bisect
import collections
import re
import threading

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_INF_LABEL = 'le="+Inf"'


def sanitize(name):
    """Map an internal dotted metric name onto the Prometheus grammar
    ([a-zA-Z_:][a-zA-Z0-9_:]*): dots/dashes/spaces become underscores."""
    out = _NAME_RE.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def fmt(v, nd=3):
    """None-safe rounding for metric read-outs: empty reservoirs report
    their percentiles/means as None (no data is not 0.0), and every
    consumer that prints or JSON-encodes a snapshot (tools/serve_ab.py,
    bench.py, tools/obs_report.py) must not crash on the idle case.
    ONE shared helper so the guard cannot drift per call site."""
    if v is None:
        return None
    try:
        return round(float(v), nd)
    except (TypeError, ValueError):
        return v


def percentile(sorted_vals, q):
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return None
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def bucket_quantile(bounds, counts, q):
    """Interpolated quantile from fixed-bucket counts: `bounds` are the
    finite upper bounds, `counts` the per-bucket counts (an extra final
    entry, the +Inf overflow, is allowed; overflow mass clamps to the
    largest finite bound). Shared by `Histogram.quantile` and the
    loadgen's per-run DELTA quantiles (bucket counts are cumulative and
    subtractable — the property reservoirs lack)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = (q / 100.0) * total
    # signed grids (the admission-error histogram spans negative bounds):
    # the first bucket's lower edge is its own bound, not 0.0 — otherwise
    # interpolation inside a negative first bucket would run BACKWARDS
    # (from 0 down to the bound) and misplace the whole quantile
    cum, lo = 0, min(0.0, bounds[0])
    for i, ub in enumerate(bounds):
        c = counts[i] if i < len(counts) else 0
        if cum + c >= target:
            if c == 0:
                return lo
            return lo + (target - cum) / c * (ub - lo)
        cum += c
        lo = ub
    return bounds[-1]


class Counter:
    """Monotonic counter. `inc` is the only writer."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-written value (None until first set)."""

    __slots__ = ("name", "_value")

    def __init__(self, name):
        self.name = name
        self._value = None

    def set(self, v):
        self._value = v

    @property
    def value(self):
        return self._value


class Reservoir:
    """Bounded sample window with percentile read-out.

    Keeps the most recent `window` samples (deque) so a long-running
    process reports RECENT percentiles; `total` counts every sample ever
    recorded (the Prometheus `_count`)."""

    __slots__ = ("name", "_buf", "_lock", "total")

    def __init__(self, name, window=2048):
        self.name = name
        self._buf = collections.deque(maxlen=int(window))
        self._lock = threading.Lock()
        self.total = 0

    def record(self, v):
        with self._lock:
            self._buf.append(float(v))
            self.total += 1

    def values(self):
        with self._lock:
            return list(self._buf)

    def percentile(self, q):
        return percentile(sorted(self.values()), q)

    def mean(self):
        vals = self.values()
        return (sum(vals) / len(vals)) if vals else None

    def last(self):
        with self._lock:
            return self._buf[-1] if self._buf else None

    def max(self):
        vals = self.values()
        return max(vals) if vals else None


class Histogram:
    """Fixed-bucket cumulative histogram (the Prometheus `histogram`
    kind).

    `buckets` are the FINITE upper bounds (le semantics: a sample lands
    in the first bucket whose bound >= value); everything above the
    largest bound goes to the implicit +Inf bucket. Counts are all-time
    cumulative — two scrapes (or two processes' exposition) can be
    summed bucket-by-bucket, which a Reservoir's sample window can't.

    `quantile(q)` interpolates linearly inside the bucket holding the
    q-th sample (what PromQL's `histogram_quantile()` computes
    server-side): an ESTIMATE whose error is bounded by bucket width.
    Samples past the largest finite bound clamp to that bound."""

    __slots__ = ("name", "buckets", "_counts", "_sum", "total", "_lock")

    # default grid tuned for millisecond latencies: sub-ms inter-token
    # gaps up through multi-second tail requests
    DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
                       250, 500, 1000, 2500, 5000, 10000)

    def __init__(self, name, buckets=None):
        self.name = name
        bs = tuple(sorted(float(b) for b in
                          (buckets or self.DEFAULT_BUCKETS)))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)      # last = +Inf overflow
        self._sum = 0.0
        self.total = 0
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self.total += 1

    def _state(self):
        """Atomic (per-bucket counts incl. overflow, sum, total) — the
        exposition must be self-consistent (cumulative counts that sum
        to `_count`), so all three are read under one lock."""
        with self._lock:
            return list(self._counts), self._sum, self.total

    def counts(self):
        return self._state()[0]

    @property
    def sum(self):
        return self._sum

    def quantile(self, q):
        """Estimated q-th percentile (None while empty)."""
        counts, _, _ = self._state()
        return bucket_quantile(self.buckets, counts, q)

    def mean(self):
        _, s, total = self._state()
        return (s / total) if total else None


class MetricsRegistry:
    """Named store of counters/gauges/reservoirs/histograms.

    get-or-create accessors (`counter(name)`, `gauge(name)`,
    `reservoir(name, window)`) so publishers never coordinate creation;
    a name registered as one kind and requested as another raises — a
    rename/typo fails loudly instead of splitting a metric in two."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, name, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def reservoir(self, name, window=2048):
        return self._get(name, Reservoir, window)

    def histogram(self, name, buckets=None):
        """Get-or-create; like `reservoir`'s window, `buckets` only
        applies on first registration (a later caller with a different
        grid gets the existing metric — one name, one grid)."""
        return self._get(name, Histogram, buckets)

    def names(self, prefix=""):
        with self._lock:
            return sorted(n for n in self._metrics if n.startswith(prefix))

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    # -- export surfaces ----------------------------------------------
    def snapshot(self, prefix=""):
        """Flat JSON-able dict: counters/gauges by name, reservoirs as
        `<name>_p50` / `<name>_p99` / `<name>_mean` / `<name>_count`."""
        with self._lock:
            items = [(n, m) for n, m in sorted(self._metrics.items())
                     if n.startswith(prefix)]
        out = {}
        for name, m in items:
            key = name[len(prefix):] if prefix else name
            if isinstance(m, Counter):
                out[key] = m.value
            elif isinstance(m, Gauge):
                out[key] = m.value
            elif isinstance(m, Histogram):
                # ONE atomic state read feeds every derived value, like
                # the exposition path: p50/p99/mean/count must describe
                # the same instant even while another thread observes
                counts, s, total = m._state()
                out[key + "_p50"] = bucket_quantile(m.buckets, counts, 50)
                out[key + "_p99"] = bucket_quantile(m.buckets, counts, 99)
                out[key + "_mean"] = (s / total) if total else None
                out[key + "_count"] = total
            else:
                vals = sorted(m.values())
                out[key + "_p50"] = percentile(vals, 50)
                out[key + "_p99"] = percentile(vals, 99)
                out[key + "_mean"] = (sum(vals) / len(vals)) if vals \
                    else None
                out[key + "_count"] = m.total
        return out

    def kind_snapshot(self, prefix=""):
        """KIND-TAGGED state export — the federation hook
        (obs/fleet.py): unlike `snapshot()`'s flat dict, every entry
        says what it IS, so a merger can apply the correct semantics
        per kind (counters sum, gauges stay per-instance, histogram
        bucket counts add element-wise, summaries don't merge at all).
        Histograms export their full bucket state (bounds + per-bucket
        counts incl. the +Inf overflow + sum + total) from ONE atomic
        read; reservoirs export derived percentiles only — their
        sample windows are NOT aggregable, which is exactly why the
        Histogram kind exists."""
        with self._lock:
            items = [(n, m) for n, m in sorted(self._metrics.items())
                     if n.startswith(prefix)]
        out = {}
        for name, m in items:
            key = name[len(prefix):] if prefix else name
            if isinstance(m, Counter):
                out[key] = {"kind": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[key] = {"kind": "gauge", "value": m.value}
            elif isinstance(m, Histogram):
                counts, s, total = m._state()
                out[key] = {"kind": "histogram",
                            "buckets": list(m.buckets),
                            "counts": counts, "sum": s, "total": total}
            else:
                vals = sorted(m.values())
                out[key] = {"kind": "summary",
                            "p50": percentile(vals, 50),
                            "p99": percentile(vals, 99),
                            "mean": (sum(vals) / len(vals)) if vals
                            else None,
                            "count": m.total}
        return out

    def prometheus_text(self, namespace="", instance=None):
        """Prometheus text exposition format (version 0.0.4): counters,
        gauges (skipped while unset), reservoirs as summaries with
        quantile labels. Served by ui/server.py's `/metrics` route.

        `instance` adds an `instance="..."` label to EVERY sample — the
        federation-friendly form: N replicas' expositions stay
        distinguishable after a scrape aggregates them, and
        `obs.fleet.parse_prometheus_text` round-trips it. Default None
        keeps the output byte-identical to the pre-label format."""
        with self._lock:
            items = sorted(self._metrics.items())
        ns = sanitize(namespace) + "_" if namespace else ""
        inst = (None if instance is None else
                str(instance).replace("\\", r"\\").replace('"', r'\"'))

        def lbl(extra=""):
            parts = [p for p in (extra,
                                 f'instance="{inst}"' if inst else "")
                     if p]
            return "{" + ",".join(parts) + "}" if parts else ""

        lines = []
        for name, m in items:
            pname = ns + sanitize(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname}{lbl()} {m.value}")
            elif isinstance(m, Gauge):
                if m.value is None:
                    continue
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname}{lbl()} {float(m.value)}")
            elif isinstance(m, Histogram):
                counts, total_sum, _ = m._state()
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for b, c in zip(m.buckets, counts):
                    cum += c
                    le = 'le="%g"' % b
                    lines.append(f"{pname}_bucket{lbl(le)} {cum}")
                # +Inf closes over the SAME atomic state read, so the
                # exposition is always internally consistent
                lines.append(
                    f"{pname}_bucket{lbl(_INF_LABEL)} {sum(counts)}")
                lines.append(f"{pname}_sum{lbl()} {total_sum}")
                lines.append(f"{pname}_count{lbl()} {sum(counts)}")
            else:
                vals = sorted(m.values())
                lines.append(f"# TYPE {pname} summary")
                for q, label in ((50, "0.5"), (90, "0.9"), (99, "0.99")):
                    v = percentile(vals, q)
                    if v is not None:
                        qlbl = 'quantile="%s"' % label
                        lines.append(f"{pname}{lbl(qlbl)} {v}")
                lines.append(f"{pname}_count{lbl()} {m.total}")
        return "\n".join(lines) + "\n"


_default = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry():
    """The process-wide registry: PS-transport retries, async-iterator
    queue depth, training-health counters, and any ServingMetrics built
    without an explicit registry all publish here, and ui/server.py's
    `/metrics` route serves it by default."""
    return _default


def reset_default_registry():
    """Swap in a fresh default registry (tests: isolate counters)."""
    global _default
    with _default_lock:
        _default = MetricsRegistry()
    return _default
