"""Fleet observability plane: metrics federation, trace stitching, and
the autoscaling signal as a tested object.

The port's copy of deeplearning4j_tpu/obs/fleet.py (stdlib only), held
against it by tests/test_torch_fleet.py; the text below is the
reference's, less its history notes.

A router over N decode replicas (the ROADMAP's replica-fleet item)
needs three things no single-process module provided:

  * **Metrics federation** — `FleetView` merges N instances' metric
    state with KIND-CORRECT semantics, the table every derived fleet
    read-out rests on:

        counter    SUM across instances (requests, tokens, sheds)
        gauge      kept PER-INSTANCE + min/mean/max aggregate (a
                   queue-depth or service-rate gauge summed across
                   replicas is meaningful only as an explicit derived
                   read-out, never silently; averaged into a counter,
                   never)
        histogram  bucket counts add ELEMENT-WISE (same fixed grid) —
                   the aggregability the fixed-bucket design
                   exists for: the merged `bucket_quantile` equals the
                   quantile of a histogram that observed the pooled
                   samples, exactly, because the merged counts ARE that
                   histogram's counts
        summary    (reservoir percentiles) kept per-instance only —
                   sample windows are not aggregable, which is exactly
                   why the Histogram kind exists

    Sources are in-process (`ServingMetrics.kind_snapshot()` /
    `MetricsRegistry.kind_snapshot()`) or a parsed `/metrics`
    Prometheus text exposition (`parse_prometheus_text`) — the same
    merge code serves a unit test and a real scrape. Derived fleet
    read-outs (fleet SLO attainment, fleet goodput-under-SLO,
    per-instance shed share) are computed FROM the merged state, never
    re-sampled.

  * **Trace stitching** — `merge_traces` aligns N saved Chrome traces
    by their `clock_sync` wall-clock anchors into ONE
    Perfetto-loadable file with per-instance process groups (distinct
    `pid` + `process_name` metadata). With the `TraceContext` that
    rides a migrated request's artifact (obs/trace.py +
    serving/kvstate.py), a request moved between servers reads as a
    single timeline: enqueue -> decode on A -> spill -> resume on B,
    same trace id, two process groups.

  * **`AutoscaleSignal`** — the ROADMAP recipe ("shed rising while
    service rate is flat = add replicas, not queue") promoted from
    prose to a windowed, hysteresis-bounded detector over merged fleet
    snapshots:

        sheds accruing + service NOT rising   -> scale_up   (capacity:
                                                 flat = exhausted,
                                                 sagging = degrading
                                                 under overload —
                                                 measured: the
                                                 admission estimator's
                                                 rate drops ~2x past
                                                 the knee)
        sheds accruing + service rate RISING  -> hold       (queue —
                                                 capacity still
                                                 ramping, adding
                                                 replicas would chase a
                                                 transient)
        sheds quiet + flat + LOW occupancy    -> scale_down
        anything else / warm-up               -> hold

    A decision only changes after `hysteresis` consecutive identical
    raw verdicts, so a single-window blip can never flap the fleet.
    The detector is pure state-in/decision-out (no clock, no rng):
    seeded synthetic traces pin it deterministically
    (tests/test_fleet.py).

Like the rest of obs/, this module is STDLIB-ONLY — it never imports
jax or numpy (the structural no-device-dispatch pin covers every file
in the package), so federating a fleet's metrics can never add a
device dispatch to any serving path.
"""
from __future__ import annotations

import collections
import re

from .registry import bucket_quantile

__all__ = ["FleetView", "AutoscaleSignal", "parse_prometheus_text",
           "merge_traces", "SHED_KEYS"]


# ---------------------------------------------------------------------------
# Prometheus text exposition -> kind snapshot
# ---------------------------------------------------------------------------
_TYPE_RE = re.compile(r"^#\s*TYPE\s+(\S+)\s+(\S+)\s*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _labels(s):
    return {m.group(1): m.group(2).replace(r"\"", '"')
            .replace(r"\\", "\\")
            for m in _LABEL_RE.finditer(s or "")}


def _num(s):
    v = float(s)
    return int(v) if v == int(v) and "e" not in s.lower() \
        and "." not in s else v


def parse_prometheus_text(text, strip_prefix="", instance=None):
    """Parse a `/metrics` text exposition (the format
    `MetricsRegistry.prometheus_text` emits, `instance` label included
    or not) back into the kind-tagged snapshot shape
    `MetricsRegistry.kind_snapshot` produces — so `FleetView` merges a
    real scrape and an in-process registry through ONE code path.

    Histogram cumulative `_bucket{le=}` samples are de-cumulated back
    to per-bucket counts (the +Inf bucket becomes the overflow entry);
    summaries keep their quantiles per-instance (not mergeable).
    `strip_prefix` removes a namespace prefix (e.g.
    `dl4j_tpu_serving_i0_`) so names line up with in-process
    kind-snapshots across the fleet.

    ONE instance per call: this returns a single instance's snapshot,
    so a text carrying samples from SEVERAL distinct `instance` labels
    (an aggregated scrape) must say which one to read — pass
    `instance=` to filter, otherwise the mix raises LOUDLY (silently
    last-wins counters and doubled histogram buckets are exactly the
    corruption kind-correct federation exists to prevent). Feed an
    aggregated scrape once per instance label, one FleetView.add each."""
    kinds = {}          # exposition name -> declared kind
    hist = {}           # name -> {"le": [(bound, cum)], "sum":, "count":}
    summ = {}           # name -> {"quantiles": {...}, "count":}
    out = {}
    seen_instances = set()

    def key(name):
        return name[len(strip_prefix):] \
            if strip_prefix and name.startswith(strip_prefix) else name

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        mt = _TYPE_RE.match(line)
        if mt:
            kinds[mt.group(1)] = mt.group(2)
            continue
        if line.startswith("#"):
            continue
        ms = _SAMPLE_RE.match(line)
        if ms is None:
            continue
        name, lbl, val = ms.group(1), _labels(ms.group(2)), ms.group(3)
        seen_instances.add(lbl.get("instance"))
        if instance is not None and \
                lbl.get("instance") != str(instance):
            continue
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    kinds.get(name[:-len(suffix)]) in ("histogram",
                                                       "summary"):
                base = name[:-len(suffix)]
                break
        kind = kinds.get(base)
        if kind == "histogram":
            h = hist.setdefault(base, {"le": [], "sum": 0.0, "count": 0})
            if name.endswith("_bucket"):
                h["le"].append((lbl.get("le"), _num(val)))
            elif name.endswith("_sum"):
                h["sum"] = float(val)
            elif name.endswith("_count"):
                h["count"] = _num(val)
        elif kind == "summary":
            s = summ.setdefault(base, {"quantiles": {}, "count": 0})
            if name.endswith("_count"):
                s["count"] = _num(val)
            elif "quantile" in lbl:
                s["quantiles"][lbl["quantile"]] = float(val)
        elif kind == "counter":
            out[key(base)] = {"kind": "counter", "value": _num(val)}
        elif kind == "gauge":
            out[key(base)] = {"kind": "gauge", "value": float(val)}
    if instance is None and len(seen_instances) > 1:
        raise ValueError(
            f"exposition carries samples from several instances "
            f"({sorted(str(i) for i in seen_instances)}): pass "
            f"instance= to pick one — parsing a mixed scrape as one "
            f"snapshot would last-win counters and double histogram "
            f"buckets")
    for base, h in hist.items():
        finite = [(float(le), cum) for le, cum in h["le"]
                  if le not in (None, "+Inf")]
        finite.sort()
        inf_cum = max((cum for le, cum in h["le"] if le == "+Inf"),
                      default=h["count"])
        counts, prev = [], 0
        for _, cum in finite:
            counts.append(cum - prev)
            prev = cum
        counts.append(inf_cum - prev)       # +Inf overflow entry
        out[key(base)] = {"kind": "histogram",
                          "buckets": [b for b, _ in finite],
                          "counts": counts, "sum": h["sum"],
                          "total": inf_cum}
    for base, s in summ.items():
        q = s["quantiles"]
        out[key(base)] = {"kind": "summary",
                          "p50": q.get("0.5"), "p99": q.get("0.99"),
                          "mean": None, "count": s["count"]}
    return out


def _as_kind_snapshot(source, strip_prefix=""):
    """Normalize one federation source: a kind-snapshot dict, a
    Prometheus text exposition, or any object exposing
    `kind_snapshot()` (ServingMetrics, MetricsRegistry)."""
    if isinstance(source, str):
        return parse_prometheus_text(source, strip_prefix=strip_prefix)
    if hasattr(source, "kind_snapshot"):
        return source.kind_snapshot()
    if isinstance(source, dict):
        return source
    raise TypeError(
        f"cannot federate {type(source).__name__}: need a kind-snapshot "
        f"dict, a Prometheus text exposition, or an object with "
        f"kind_snapshot() (ServingMetrics / MetricsRegistry)")


def _mean(vals):
    vals = [v for v in vals if v is not None]
    return (sum(vals) / len(vals)) if vals else None


# shed counters whose fleet total / per-instance share the federation
# report renders — the ONE canonical copy of serving/metrics.py's
# by-cause counter names on the fleet side (tools/fleet_report.py
# imports it; a new shed cause is added HERE and every fleet read-out
# follows)
SHED_KEYS = ("shed_queue_full", "shed_deadline", "shed_blocks",
             "shed_predicted", "shed_brownout")


class FleetView:
    """Merged view over N instances' kind-snapshots (module docstring:
    counters sum, gauges per-instance + min/mean/max, histograms
    bucket-wise, summaries per-instance only)."""

    def __init__(self, signal=None):
        self._instances = {}        # name -> kind snapshot (insertion
        #                             order = pid order in reports)
        self.signal = signal        # optional AutoscaleSignal whose
        #                             last decision snapshot() reports

    def add(self, name, source, strip_prefix=""):
        self._instances[str(name)] = _as_kind_snapshot(
            source, strip_prefix=strip_prefix)
        return self

    @property
    def instances(self):
        return list(self._instances)

    def _kind_of(self, name):
        kinds = {snap[name]["kind"] for snap in self._instances.values()
                 if name in snap}
        if len(kinds) > 1:
            raise ValueError(
                f"metric {name!r} has conflicting kinds across the "
                f"fleet: {sorted(kinds)} — same rename-fails-loudly "
                f"rule as the registry")
        return kinds.pop() if kinds else None

    # -- merged read-outs ---------------------------------------------
    def counters(self):
        """All counter-kind metrics summed across instances. Gauges
        and histograms NEVER land here — kind separation is the
        federation contract, not a convention."""
        out = {}
        names = {n for snap in self._instances.values() for n in snap}
        for name in sorted(names):
            if self._kind_of(name) != "counter":
                continue
            out[name] = sum(snap[name]["value"]
                            for snap in self._instances.values()
                            if name in snap)
        return out

    def counter(self, name, default=0):
        if self._kind_of(name) not in (None, "counter"):
            raise ValueError(f"metric {name!r} is not a counter")
        return sum((snap[name]["value"] or 0)
                   for snap in self._instances.values()
                   if name in snap) if self._kind_of(name) else default

    def gauge_view(self, name):
        """Per-instance gauge values + min/mean/max aggregate. None
        while no instance has set the gauge."""
        if self._kind_of(name) not in (None, "gauge"):
            raise ValueError(f"metric {name!r} is not a gauge")
        per = {inst: snap[name]["value"]
               for inst, snap in self._instances.items()
               if name in snap}
        vals = [v for v in per.values() if v is not None]
        return {"per_instance": per,
                "min": min(vals) if vals else None,
                "mean": _mean(vals),
                "max": max(vals) if vals else None}

    def gauge_sum(self, name):
        """Explicit derived read-out: the SUM of one gauge across
        instances (fleet capacity from per-replica service rates).
        Deliberately a separate verb from `gauge_view` — summing a
        gauge is a modeling decision the caller states, never a merge
        default."""
        vals = [v for v in self.gauge_view(name)["per_instance"]
                .values() if v is not None]
        return sum(vals) if vals else None

    def histogram(self, name):
        """Bucket-wise merged histogram state: (buckets, counts, sum,
        total). Grids must match exactly across instances (one name,
        one grid — the registry's first-registration rule, enforced
        across the fleet)."""
        if self._kind_of(name) not in (None, "histogram"):
            raise ValueError(f"metric {name!r} is not a histogram")
        buckets = None
        counts, total, s = None, 0, 0.0
        for inst, snap in self._instances.items():
            if name not in snap:
                continue
            h = snap[name]
            if buckets is None:
                buckets = list(h["buckets"])
                counts = [0] * len(h["counts"])
            elif list(h["buckets"]) != buckets:
                raise ValueError(
                    f"histogram {name!r} has mismatched bucket grids "
                    f"across the fleet ({inst}: {h['buckets']} vs "
                    f"{buckets}) — bucket-wise merge is only exact on "
                    f"one shared grid")
            counts = [a + b for a, b in zip(counts, h["counts"])]
            total += h["total"]
            s += h["sum"]
        if buckets is None:
            return None
        return {"buckets": buckets, "counts": counts, "sum": s,
                "total": total}

    def quantile(self, name, q):
        """Interpolated quantile of the MERGED histogram — equal to the
        pooled-sample histogram's quantile within bucket resolution
        (exactly equal to a histogram that observed every instance's
        samples, since the merged counts are its counts)."""
        h = self.histogram(name)
        if h is None:
            return None
        return bucket_quantile(h["buckets"], h["counts"], q)

    def shed_share(self):
        """Per-instance share of the fleet's total sheds (all causes) —
        the imbalance read-out: one replica absorbing most of the
        shedding is a router bug, not an autoscaling signal."""
        per = {}
        for inst, snap in self._instances.items():
            per[inst] = sum((snap[k]["value"] or 0) for k in SHED_KEYS
                            if k in snap
                            and snap[k]["kind"] == "counter")
        total = sum(per.values())
        return {inst: (n / total if total else 0.0)
                for inst, n in per.items()}

    def flat(self, name):
        """One instance's kind-snapshot flattened to the familiar
        snapshot() shape (counters/gauges by name, histograms and
        summaries as _p50/_p99/_mean/_count) — the per-instance table
        row and the obs_report metrics-section input."""
        snap = self._instances[name]
        out = {}
        for key, m in snap.items():
            if m["kind"] in ("counter", "gauge"):
                out[key] = m["value"]
            elif m["kind"] == "histogram":
                out[key + "_p50"] = bucket_quantile(
                    m["buckets"], m["counts"], 50)
                out[key + "_p99"] = bucket_quantile(
                    m["buckets"], m["counts"], 99)
                out[key + "_mean"] = (m["sum"] / m["total"]) \
                    if m["total"] else None
                out[key + "_count"] = m["total"]
            else:
                out[key + "_p50"] = m["p50"]
                out[key + "_p99"] = m["p99"]
                out[key + "_mean"] = m["mean"]
                out[key + "_count"] = m["count"]
        return out

    def snapshot(self):
        """The fleet read-out dict. ALWAYS-PRESENT keys (pinned in
        tests/test_obs.py, exposed on the federation report):
        `fleet_instances`, `fleet_slo_attainment`,
        `fleet_goodput_tokens_per_sec`, `autoscale_decision` — plus the
        merged inputs the autoscale detector consumes
        (`fleet_shed_predicted`, `fleet_service_rate_tokens_per_sec`,
        `fleet_occupancy_mean`). Every derived value is computed from
        the MERGED state (counters summed, gauges aggregated) — never
        re-sampled from a live instance, so a snapshot is a consistent
        artifact even while the fleet keeps serving."""
        counters = self.counters()
        out = {"fleet_instances": len(self._instances),
               "instances": self.instances}
        slo_total = counters.get("slo_total", 0)
        slo_met = counters.get("slo_met", 0)
        out["fleet_slo_attainment"] = (slo_met / slo_total
                                       if slo_total else None)
        # fleet capacity = sum of per-replica service-rate gauges (an
        # EXPLICIT derived read-out — see gauge_sum); goodput scales it
        # by the fleet-wide within-SLO token fraction
        rate = self.gauge_sum("service_rate_tokens_per_sec")
        out["fleet_service_rate_tokens_per_sec"] = rate
        toks = counters.get("tokens_out", 0)
        frac = (min(1.0, counters.get("slo_tokens_met", 0) / toks)
                if toks else None)
        out["fleet_goodput_tokens_per_sec"] = (
            rate * frac if rate is not None and frac is not None
            else None)
        out["fleet_tokens_out"] = toks
        out["fleet_shed_predicted"] = counters.get("shed_predicted", 0)
        out["fleet_sheds_total"] = sum(
            counters.get(k, 0) for k in SHED_KEYS)
        out["fleet_shed_share"] = self.shed_share()
        # fleet-control event counters (serving/fleet.py FleetManager):
        # summed like any counter (the manager's own metrics carry
        # them; a FleetManager.fleet_snapshot() overlays its live
        # values) — always present so tools/fleet_report.py renders
        # the control plane's activity next to the federation keys
        for key in ("replica_spawned", "replica_drained", "replica_dead",
                    "failover_resubmitted", "canary_rollbacks",
                    "wire_reconnects", "wire_retries",
                    "migrate_refused", "manager_epoch",
                    "replicas_adopted", "fenced_ops",
                    "journal_records", "requests_quarantined",
                    "breaker_open_total", "retry_budget_exhausted",
                    "degraded_mode_ticks", "infant_deaths",
                    "fused_windows", "decode_iterations",
                    "routed_affinity", "routed_spill",
                    "prefix_pull_hits", "prefix_pull_refused",
                    "prefix_pull_bytes"):
            out["fleet_" + key] = counters.get(key, 0)
        # fleet-wide dispatch amortization (fused decode windows): the
        # same ratio each instance derives, recomputed from the MERGED
        # counters so it weights instances by their dispatch volume
        disp = counters.get("dispatches", 0)
        out["fleet_iterations_per_dispatch"] = (
            counters.get("decode_iterations", 0) / disp
            if disp else None)
        # the breaker's live state is a GAUGE — federation can't sum
        # it; the manager's fleet_snapshot() overlays its own. Here the
        # per-instance max stands in (any open breaker reads open).
        states = [v for v in self.gauge_view(
            "breaker_state")["per_instance"].values() if v is not None]
        out["fleet_breaker_state"] = max(states) if states else 0.0
        # mean of per-instance occupancy statistics (summary kind:
        # recent scheduling-iteration slot occupancy) — the scale_down
        # input. A PARSED exposition carries no window mean (summaries
        # expose quantiles + count only), so the p50 stands in: for the
        # bounded [0,1] occupancy gate the median is an equally valid
        # idle read-out, and without the fallback a text-federated
        # fleet could never emit scale_down at all.
        occ = _mean([
            snap["occupancy"]["mean"]
            if snap["occupancy"].get("mean") is not None
            else snap["occupancy"].get("p50")
            for snap in self._instances.values()
            if snap.get("occupancy", {}).get("kind") == "summary"])
        out["fleet_occupancy_mean"] = occ
        out["autoscale_decision"] = (self.signal.decision
                                     if self.signal is not None
                                     else None)
        return out


# ---------------------------------------------------------------------------
# trace stitching
# ---------------------------------------------------------------------------
def _trace_meta(trace, name):
    for e in trace.get("traceEvents", ()):
        if e.get("ph") == "M" and e.get("name") == name:
            return e.get("args") or {}
    return {}


def merge_traces(traces, names=None):
    """Stitch N Chrome traces into ONE Perfetto-loadable trace.

    Alignment: each trace's `clock_sync` anchor
    (`wallclock_ns_at_ts0`) maps its ts=0 onto the wall clock;
    every trace's events shift onto the EARLIEST anchor's timeline
    (shift_us = (anchor_i - min_anchor) / 1e3). Within one process the
    wall and monotonic clocks tick together (pinned), so cross-instance
    span ORDER in the merged file is the real order. A trace with no
    anchor merges unshifted (its spans still render, on its own ts
    base — degraded, not dropped).

    Separation: trace i becomes process group pid=i+1 with its own
    `process_name` metadata (from `names`, else the trace's
    process_name / clock_sync instance metadata, else `instance<i>`)
    and its thread_name lanes preserved — so a migrated request's
    `req-<id>` lane appears once per instance, tied together by the
    shared trace id in its spans' args."""
    anchors, labels = [], []
    for i, t in enumerate(traces):
        sync = _trace_meta(t, "clock_sync")
        anchors.append(sync.get("wallclock_ns_at_ts0"))
        if names is not None and i < len(names):
            labels.append(str(names[i]))
        else:
            labels.append(
                sync.get("instance")
                or _trace_meta(t, "process_name").get("name")
                or f"instance{i}")
    known = [a for a in anchors if a is not None]
    base = min(known) if known else None
    events = []
    if base is not None:
        events.append({"ph": "M", "pid": 0, "tid": 0,
                       "name": "clock_sync",
                       "args": {"wallclock_ns_at_ts0": base,
                                "merged_instances": labels}})
    for i, t in enumerate(traces):
        pid = i + 1
        shift_us = ((anchors[i] - base) / 1e3
                    if anchors[i] is not None and base is not None
                    else 0.0)
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": labels[i]}})
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_sort_index",
                       "args": {"sort_index": i}})
        for e in t.get("traceEvents", ()):
            if e.get("ph") == "M":
                # per-trace process_name/clock_sync already rewritten
                # above; thread_name lanes carry over under the new pid
                if e.get("name") in ("process_name", "clock_sync",
                                     "process_sort_index"):
                    continue
                ne = dict(e)
                ne["pid"] = pid
                events.append(ne)
                continue
            ne = dict(e)
            ne["pid"] = pid
            if "ts" in ne:
                ne["ts"] = ne["ts"] + shift_us
            events.append(ne)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# autoscaling signal
# ---------------------------------------------------------------------------
class AutoscaleSignal:
    """Windowed, hysteresis-bounded scale decision over fleet
    snapshots (module docstring has the decision table).

    Feed `observe()` one fleet snapshot per observation window (the
    load_sweep fleet harness observes once per schedule slice); it
    returns the CURRENT decision. Inputs per observation:

      * `fleet_shed_predicted` — the merged CUMULATIVE shed counter
        (any monotone shed counter works; predicted-miss sheds are the
        ROADMAP's chosen leading indicator because they fire at
        enqueue, before goodput is lost);
      * `fleet_service_rate_tokens_per_sec` — the fleet capacity
        estimate (sum of per-replica admission-estimator gauges);
      * `fleet_occupancy_mean` — mean recent slot occupancy (the
        scale_down input; None disables scale_down).

    Mechanics: over the last `window` observations, sheds-per-window
    deltas are split into early/late halves. Sheds are ACCRUING when
    the late-half MEDIAN delta >= `min_shed_rate` (a cumulative
    counter actively rising — steady-state overload counts; the
    recipe's "shed rising" is about the counter, not its second
    derivative). The median, not the mean: one anomalous burst window
    lingers in the delta window for half its length and a mean would
    keep the raw verdict flipped that whole time — the same
    outlier-rejection argument the admission estimator's median makes
    against compile spikes. Service rate is RISING when the late-half
    mean exceeds the early-half mean by more than `flat_tol`
    (relative); FLAT when within +/- `flat_tol`. On top of that,
    decisions change only after `hysteresis` consecutive identical
    raw verdicts. Deterministic: no clock reads, no randomness — the
    same observation sequence always yields the same decision
    sequence."""

    SCALE_UP = "scale_up"
    SCALE_DOWN = "scale_down"
    HOLD = "hold"

    def __init__(self, window=6, min_shed_rate=1.0, flat_tol=0.25,
                 low_occupancy=0.25, hysteresis=2):
        if window < 4:
            raise ValueError(f"window must be >= 4 (two halves of "
                             f"deltas), got {window}")
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got "
                             f"{hysteresis}")
        self.window = int(window)
        self.min_shed_rate = float(min_shed_rate)
        self.flat_tol = float(flat_tol)
        self.low_occupancy = float(low_occupancy)
        self.hysteresis = int(hysteresis)
        self._obs = collections.deque(maxlen=self.window)
        self._pending = self.HOLD
        self._pending_n = 0
        self.decision = self.HOLD
        self.transitions = []       # (observation index, decision)
        self._n_obs = 0

    # -- inputs --------------------------------------------------------
    def observe(self, snapshot=None, *, sheds=None, service_rate=None,
                occupancy=None):
        """One observation window: pass a `FleetView.snapshot()` dict
        or the three inputs explicitly. Returns the current
        (hysteresis-bounded) decision."""
        if snapshot is not None:
            sheds = snapshot.get("fleet_shed_predicted", 0) \
                if sheds is None else sheds
            if service_rate is None:
                service_rate = snapshot.get(
                    "fleet_service_rate_tokens_per_sec")
            if occupancy is None:
                occupancy = snapshot.get("fleet_occupancy_mean")
        self._n_obs += 1
        self._obs.append((float(sheds or 0), float(service_rate or 0.0),
                          None if occupancy is None
                          else float(occupancy)))
        raw = self._raw()
        if raw == self._pending:
            self._pending_n += 1
        else:
            self._pending, self._pending_n = raw, 1
        if raw != self.decision and self._pending_n >= self.hysteresis:
            self.decision = raw
            self.transitions.append((self._n_obs, raw))
        return self.decision

    def reset(self):
        """Forget the observation window and re-enter warm-up (decision
        back to HOLD; transition history kept). The fleet manager calls
        this after ACTING on a decision — the actuation twin of the
        hysteresis bound: one action per argued regime, so the next
        scale move must be argued entirely from observations of the NEW
        fleet shape instead of the stale window that justified the
        last one (without it a sustained-overload window would spawn a
        replica per tick)."""
        self._obs.clear()
        self._pending, self._pending_n = self.HOLD, 0
        self.decision = self.HOLD

    # -- classification ------------------------------------------------
    def _raw(self):
        if len(self._obs) < self.window:
            return self.HOLD        # warm-up: never act on a part-window
        sheds = [o[0] for o in self._obs]
        # cumulative counter deltas; a counter reset (restarted
        # instance) reads as a one-window zero, not a negative spike
        deltas = [max(0.0, b - a) for a, b in zip(sheds, sheds[1:])]
        h = len(deltas) // 2
        late = sorted(deltas[h:])
        # LOWER median (even-length halves round down): a lone burst
        # window can never be the statistic, whatever the window size
        late_median = late[(len(late) - 1) // 2] if late else 0.0
        shed_active = late_median >= self.min_shed_rate
        rates = [o[1] for o in self._obs]
        rh = len(rates) // 2
        r_early = _mean(rates[:rh]) or 0.0
        r_late = _mean(rates[rh:]) or 0.0
        denom = max(abs(r_early), abs(r_late), 1e-9)
        rel = (r_late - r_early) / denom
        service_rising = rel > self.flat_tol
        service_flat = abs(rel) <= self.flat_tol
        occs = [o[2] for o in self._obs if o[2] is not None]
        occ = _mean(occs)
        if shed_active:
            # rising service = the fleet is still ramping into its
            # capacity (queue transient — adding replicas would chase
            # it); flat OR sagging service under sheds = capacity
            return self.HOLD if service_rising else self.SCALE_UP
        if (sum(deltas[h:]) == 0.0 and service_flat
                and occ is not None and occ < self.low_occupancy):
            return self.SCALE_DOWN      # idle capacity, no pressure
        return self.HOLD
