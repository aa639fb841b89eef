"""Serving metrics: request-level latency percentiles + operational
gauges + SLO attainment counters.

The port's copy of deeplearning4j_tpu/serving/metrics.py (stdlib only), held against it
by tests/test_torch_*.py; the text below is the reference's.

A serving SLO is a percentile, not a mean (bench.py's decode config makes
the same point for token latency) — so the core structure here is a
bounded latency reservoir per phase (queue wait, dispatch, total) with
p50/p99 read out in `snapshot()`. Everything is host-side and O(1) per
request: metrics must never add a device round-trip or a blocking call
to the serving hot path.

Since PR 6 the counter/gauge/reservoir machinery lives in
`obs.registry.MetricsRegistry` — this class is a named view over a
registry (its own private one by default, or a shared/default registry
so the `/metrics` Prometheus route on ui/server.py exports serving
counters next to training-health and transport counters). The
`snapshot()` dict is unchanged and remains the ONE export surface — the
same dict feeds `ui.stats.ServingStatsReporter` (the existing UI storage
path), the `served_throughput` bench entry, and `tools/serve_ab.py`.

Queue-depth staleness fix (PR 6): depth used to be sampled ONLY at batch
formation, so an idle-then-bursty server reported the depth of the last
batch formed minutes ago. The serving loops now also record depth at
enqueue and shed time (`record_queue_depth`), so `queue_depth_last`
reflects admission pressure even before a batch forms.

TTFT + inter-token latency (PR 7): the decode server records
time-to-first-token (submit -> the slot's FIRST generated token, closed
at prefill where token 1 is produced) and an inter-token sample per
decode iteration per slot. Both are `obs.registry.Histogram`s — fixed
cumulative buckets, so they scrape as real distributions on the
Prometheus route and aggregate across endpoints, unlike the recent-
window reservoirs. These are the serving SLO metrics the fixed-backlog
A/B never needed: under ARRIVING traffic, TTFT is what queueing does to
users and inter-token is what co-residency does to streams.

SLO counters (PR 6): pass `slo_target_ms` (or have the server report
explicit per-request deadlines) and `snapshot()` carries
`slo_total` / `slo_met` / `slo_tokens_met` / `slo_attainment` — the
deadline-attainment and goodput-under-SLO numerators the ROADMAP's
production-traffic harness starts from. Shed/evicted deadline-carrying
requests count as misses: attainment is over requests ADMITTED to an
SLO, not just the ones that survived to completion.

Overload-control view (PR 9, serving/admission.py): the decode server's
service-rate estimator publishes `service_rate_tokens_per_sec` (gauge)
and the signed `admission_error_ms` histogram — (predicted - actual)
completion error per completed request, NEGATIVE when the estimator was
optimistic (the dangerous direction: optimism admits doomed requests,
pessimism sheds feasible ones) — so a wrongly-shedding estimator is
visible on the Prometheus route before it costs goodput. The shed
counters split by CAUSE (`shed_queue_full` / `shed_deadline` /
`shed_blocks` / `shed_predicted` / `shed_brownout`), rendered together
by `shed_view()` — the one breakdown implementation behind
loadgen/load_sweep/serve_ab/bench, as `slo_view` is for goodput.
"""
from __future__ import annotations

import itertools

from ..obs.registry import (MetricsRegistry, bucket_quantile, fmt,
                            percentile as _pct)

__all__ = ["ServingMetrics", "fmt", "slo_view", "shed_view"]

_ANON = itertools.count()


def slo_view(snap, throughput=None, base=None):
    """Deadline-attainment + goodput-under-SLO from one snapshot() dict:
    goodput = raw rate x fraction of output that landed within the SLO
    (tokens for decode servers, requests for batch endpoints). `base` is
    a snapshot taken AFTER any compile-off-the-clock warm-up — the
    counters are all-time, and first-compile requests are guaranteed SLO
    misses that would permanently deflate attainment. The ONE
    implementation behind tools/serve_ab.py and bench.py's serving
    records, so the attainment/goodput definition cannot drift between
    reports."""
    def delta(key):
        return snap.get(key, 0) - (base.get(key, 0) if base else 0)

    total, met = delta("slo_total"), delta("slo_met")
    out = {"slo_total": total, "slo_met": met,
           "attainment": fmt(met / total if total else None, 4)}
    produced = delta("tokens_out")
    if produced:
        frac = min(1.0, delta("slo_tokens_met") / produced)
        out["goodput_fraction"] = fmt(frac, 4)
        if throughput is not None:
            out["goodput_tokens_per_sec"] = fmt(throughput * frac, 1)
    elif total and throughput is not None:
        frac = met / total
        out["goodput_fraction"] = fmt(frac, 4)
        out["goodput_requests_per_sec"] = fmt(throughput * frac, 1)
    return out


def shed_view(snap, base=None):
    """Shed-reason breakdown from one snapshot() dict (deltas vs `base`,
    like `slo_view`): the distinct counters behind what used to print as
    one "sheds" number. ONE implementation shared by
    `serving.loadgen.run_load`, `tools/load_sweep.py`,
    `tools/serve_ab.py`, and bench.py so the column set cannot drift
    between reports. `evicted_mid_decode` rides along (it is the shed
    the admission predictor exists to prevent: work paid for, then
    thrown away)."""
    def delta(key):
        return snap.get(key, 0) - (base.get(key, 0) if base else 0)

    return {"shed_queue": delta("shed_queue_full"),
            "shed_deadline": delta("shed_deadline"),
            "shed_blocks": delta("shed_blocks"),
            "shed_predicted": delta("shed_predicted"),
            "shed_brownout": delta("shed_brownout"),
            "evicted_mid_decode": delta("evicted_mid_decode")}


class ServingMetrics:
    """Thread-safe counters + latency reservoirs for one serving endpoint.

    Counters: received / completed / failed / shed_deadline /
    shed_queue_full / retries / swaps / unhealthy_outputs + the SLO
    family. Gauges: queue depth (sampled at enqueue, shed, AND batch
    formation), batch occupancy (real requests / bucket slots — the
    padding waste measure), decode slot occupancy. Reservoirs keep the
    most recent `window` samples so a long-running server reports RECENT
    percentiles, not all-time ones.

    `registry` / `name`: where the metrics live. Default is a private
    `MetricsRegistry` (two servers never collide); pass
    `obs.default_registry()` (and a distinct `name`) to export this
    endpoint on the process-wide `/metrics` Prometheus route.
    """

    def __init__(self, window=2048, registry=None, name=None,
                 slo_target_ms=None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        if name is None:
            name = f"srv{next(_ANON)}" if registry is not None else "srv"
        self.name = name
        self._prefix = f"serving.{name}."
        self._window = int(window)
        self.slo_target_ms = (None if slo_target_ms is None
                              else float(slo_target_ms))
        res = self.registry.reservoir
        p = self._prefix
        self._lat_ms = res(p + "latency_ms", self._window)
        self._queue_wait_ms = res(p + "queue_wait_ms", self._window)
        self._queue_depth = res(p + "queue_depth", self._window)
        self._occupancy = res(p + "occupancy", self._window)
        self._batch_sizes = res(p + "batch_size", self._window)
        # speculative decode reservoirs (serving/speculate.py): accepted
        # tokens per slot-dispatch and draft acceptance rate
        self._spec_accepted = res(p + "spec_accepted", self._window)
        self._spec_accept_rate = res(p + "spec_accept_rate", self._window)
        # decode-server SLO histograms (fixed cumulative buckets — the
        # Prometheus `histogram` kind, scrapeable/aggregatable where a
        # reservoir is not); recorded by ContinuousDecodeServer
        hist = self.registry.histogram
        self._ttft_ms = hist(p + "ttft_ms")
        self._inter_token_ms = hist(p + "inter_token_ms")
        # admission-estimator observability (serving/admission.py):
        # signed (predicted - actual) completion error — the grid spans
        # NEGATIVE bounds because optimistic predictions (actual later
        # than predicted) are the dangerous direction and must not be
        # folded into the first nonnegative bucket
        self._admission_error_ms = hist(
            p + "admission_error_ms",
            buckets=(-10000, -2500, -1000, -250, -100, -25, 0,
                     25, 100, 250, 1000, 2500, 10000))
        self._service_rate = self.registry.gauge(
            p + "service_rate_tokens_per_sec")
        # paged KV-cache view (serving/kvpool.py): arena pressure as a
        # reservoir (last/max like queue depth), capacity as a gauge,
        # live decode streams as a reservoir whose MAX is the measured
        # concurrency — all on the registry, so the Prometheus route
        # exports them next to the serving counters
        self._blocks_in_use = res(p + "blocks_in_use", self._window)
        self._pool_blocks = self.registry.gauge(p + "pool_blocks")
        self._live_streams = res(p + "live_streams", self._window)
        self._counters = {}     # key -> Counter, resolved once per key
        # durable KV state (serving/kvstate.py): counters created
        # EAGERLY, not on first event — preemption/migration/restore
        # are rare by design, and a dashboard (or the Prometheus
        # route) must read zero, not absence, on a server that simply
        # has not preempted yet
        for key in ("preempted", "resumed", "migrated", "migrated_out",
                    "spill_bytes", "prefix_restore_hits"):
            self.count(key, 0)
        # fleet-control events (serving/fleet.py FleetManager): same
        # eager rule — a fleet that never failed over must scrape zero,
        # not absence, on every one of its control verbs. The wire
        # counters (serving/wire.py RemoteReplica via the manager's
        # metrics): reconnects after a severed connection, in-flight
        # frames re-sent under the at-most-once dedup, and migrations
        # a destination refused (degraded to prompt replay).
        for key in ("replica_spawned", "replica_drained", "replica_dead",
                    "replica_degraded", "failover_resubmitted",
                    "canary_rollbacks", "wire_reconnects",
                    "wire_retries", "migrate_refused"):
            self.count(key, 0)
        # durable control plane (serving/fleetjournal.py + recovery/
        # fencing in serving/fleet.py + serving/wire.py): same eager
        # rule — a fleet that never restarted its manager must scrape
        # zero, not absence, on its epoch, adoptions, fenced control
        # ops, and journal records
        for key in ("manager_epoch", "replicas_adopted", "fenced_ops",
                    "journal_records"):
            self.count(key, 0)
        # blast-radius containment (serving/fleet.py): poison-pill
        # quarantine verdicts + admission sheds, spawn-breaker opens,
        # fleet retry-budget denials, degraded-mode ticks, and
        # infant deaths — same eager rule; the breaker's live state is
        # the `breaker_state` gauge (0 closed / 0.5 half-open / 1 open)
        for key in ("requests_quarantined", "breaker_open_total",
                    "retry_budget_exhausted", "degraded_mode_ticks",
                    "infant_deaths"):
            self.count(key, 0)
        # prefix-affinity routing + the fleet prefix tier
        # (serving/fleet.py affinity policy, serving/decode.py
        # prefix_export/prefix_adopt, serving/wire.py PREFIX ops): same
        # eager rule — a fleet that never spilled or pulled must scrape
        # zero, not absence, on its routing verdicts and tier traffic
        for key in ("routed_affinity", "routed_spill",
                    "prefix_pull_hits", "prefix_pull_refused",
                    "prefix_pull_bytes"):
            self.count(key, 0)
        self._breaker_state = self.registry.gauge(p + "breaker_state")
        self._breaker_state.set(0.0)    # a fresh endpoint reads CLOSED

    @property
    def instance(self):
        """The endpoint's instance label — the identity it federates
        under (`obs.fleet.FleetView`) and exports on a labeled
        `/metrics` route. Same string as `name`; the alias exists so
        fleet code reads the intent, not the storage detail."""
        return self.name

    def kind_snapshot(self):
        """Kind-tagged state export for federation: this endpoint's
        metrics with their registry prefix stripped, each entry tagged
        counter/gauge/histogram/summary so `obs.fleet.FleetView` can
        merge N endpoints with kind-correct semantics (counters sum,
        gauges stay per-instance, histogram buckets add element-wise,
        summaries never merge). The authoritative hook — fleet code
        never reaches into the registry's private prefix scheme."""
        return self.registry.kind_snapshot(self._prefix)

    # -- hot-path recorders -------------------------------------------
    def count(self, key, n=1):
        # memoized per key: the hot path pays one dict hit + the
        # counter's own lock, never the registry lock or a string concat
        # (the module contract: O(1), lock-light per request)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = self.registry.counter(
                self._prefix + key)
        c.inc(n)

    def record_request(self, total_ms, queue_wait_ms=None, tokens=None,
                       deadline_met=None):
        """One completed request. `tokens` (generated tokens, or None
        for non-generative endpoints) and `deadline_met` (True/False for
        an explicit per-request deadline, None for none) feed the SLO
        counters; without an explicit deadline, `slo_target_ms` decides
        attainment from the total latency."""
        self.count("completed")
        self._lat_ms.record(float(total_ms))
        if queue_wait_ms is not None:
            self._queue_wait_ms.record(float(queue_wait_ms))
        met = deadline_met
        if met is None and self.slo_target_ms is not None:
            met = float(total_ms) <= self.slo_target_ms
        if met is not None:
            self.count("slo_total")
            if met:
                self.count("slo_met")
                if tokens:
                    self.count("slo_tokens_met", int(tokens))

    def record_slo_miss(self):
        """A deadline-carrying request that never completed (shed at
        admission or evicted mid-decode): attainment's denominator must
        include it — goodput under load is exactly about the requests
        the server gave up on."""
        self.count("slo_total")

    def record_ttft(self, ms):
        """Time-to-first-token for one request: submit -> the first
        generated token landing (the decode server closes this at
        prefill, whose argmax IS token 1)."""
        self._ttft_ms.observe(float(ms))

    def record_inter_token(self, ms):
        """One inter-token latency sample per decode iteration per slot
        (speculative iterations record delta/accepted — the per-token
        stream rate the user sees, not the per-dispatch stall)."""
        self._inter_token_ms.observe(float(ms))

    def record_admission_error(self, ms):
        """Signed (predicted - actual) completion error for one request
        the admission estimator made a prediction for: positive =
        pessimistic (finished earlier than predicted), negative =
        optimistic (the direction that admits doomed requests)."""
        self._admission_error_ms.observe(float(ms))

    def record_service_rate(self, tokens_per_sec):
        """The admission estimator's current aggregate decode rate,
        published once per scheduling iteration — the live capacity
        number predictions divide by."""
        self._service_rate.set(float(tokens_per_sec))

    def record_breaker_state(self, state):
        """The spawn circuit breaker's live state (serving/fleet.py):
        0 closed, 0.5 half-open, 1 open — a gauge, because the breaker
        is a condition, not an event stream (its event twin is
        `breaker_open_total`)."""
        self._breaker_state.set(float(state))

    def record_queue_depth(self, depth):
        """Depth sample OUTSIDE batch formation (enqueue / shed time) —
        the staleness fix: an idle-then-bursty server reports admission
        pressure, not the depth of the last batch formed minutes ago."""
        self._queue_depth.record(int(depth))

    def record_batch(self, n_real, bucket, queue_depth):
        self.count("batches")
        self._batch_sizes.record(int(n_real))
        self._occupancy.record(n_real / float(bucket) if bucket else 0.0)
        self._queue_depth.record(int(queue_depth))

    def record_occupancy(self, active, slots):
        """Decode-scheduler slot occupancy for one token iteration."""
        self._occupancy.record(active / float(slots) if slots else 0.0)

    def record_live_streams(self, n):
        """Concurrently-decoding streams this iteration; the snapshot's
        `live_streams_max` is the measured concurrency — the number the
        paged-vs-fixed A/B compares at equal arena bytes."""
        self._live_streams.record(int(n))

    def record_pool(self, in_use, capacity):
        """Paged KV arena pressure, sampled once per decode iteration:
        blocks held by live requests vs pool capacity. The event
        counters around it (`prefix_rows_hit`/`prefix_rows_total`,
        `cow_copies`, `blocked_on_memory`, `shed_blocks`) are plain
        `count()` keys recorded by the decode server at their sites."""
        self._blocks_in_use.record(int(in_use))
        self._pool_blocks.set(int(capacity))

    def record_speculation(self, accepted, drafted, matched):
        """One slot's share of one speculative verify dispatch: `accepted`
        tokens emitted (matched prefix + bonus), `matched` of the
        `drafted` draft tokens confirmed by the verify argmax."""
        self.count("spec_tokens", int(accepted))
        self.count("spec_drafted", int(drafted))
        self.count("spec_matched", int(matched))
        self._spec_accepted.record(int(accepted))
        if drafted:
            self._spec_accept_rate.record(matched / float(drafted))

    # -- read-out ------------------------------------------------------
    def latency_histograms(self):
        """The cumulative-bucket histograms by snapshot key — the PUBLIC
        handle `serving.loadgen.run_load` uses for per-run bucket-count
        deltas (reaching for the private attributes would degrade
        silently on a rename). `admission_error_ms` rides with the SLO
        pair so a sweep point reports the estimator's per-run error
        distribution next to its TTFT."""
        return {"ttft_ms": self._ttft_ms,
                "inter_token_ms": self._inter_token_ms,
                "admission_error_ms": self._admission_error_ms}

    def count_value(self, key):
        from ..obs.registry import Counter
        m = self.registry.get(self._prefix + key)
        # non-counter names (a reservoir like "latency_ms", an unset
        # gauge) report 0, matching the old Counter-dict .get(key, 0)
        return m.value if isinstance(m, Counter) else 0

    def snapshot(self):
        from ..obs.registry import Counter
        out = {}
        for n in self.registry.names(self._prefix):
            m = self.registry.get(n)
            if isinstance(m, Counter):
                out[n[len(self._prefix):]] = m.value
        lat = sorted(self._lat_ms.values())
        qw = sorted(self._queue_wait_ms.values())
        occ = self._occupancy.values()
        sizes = self._batch_sizes.values()
        spec_acc = self._spec_accepted.values()
        spec_rate = self._spec_accept_rate.values()
        out["latency_ms_p50"] = _pct(lat, 50)
        out["latency_ms_p99"] = _pct(lat, 99)
        out["queue_wait_ms_p50"] = _pct(qw, 50)
        out["queue_wait_ms_p99"] = _pct(qw, 99)
        depth_last = self._queue_depth.last()
        depth_max = self._queue_depth.max()
        out["queue_depth_last"] = 0 if depth_last is None \
            else int(depth_last)
        out["queue_depth_max"] = 0 if depth_max is None else int(depth_max)
        out["batch_occupancy_mean"] = (sum(occ) / len(occ)) if occ \
            else None
        out["batch_size_mean"] = (sum(sizes) / len(sizes)) if sizes \
            else None
        # speculative-decode view: recent accepted-tokens-per-dispatch and
        # draft acceptance rate (reservoirs), plus the all-time dispatch
        # amortization the whole feature exists to improve
        out["spec_accepted_per_dispatch_mean"] = (
            sum(spec_acc) / len(spec_acc)) if spec_acc else None
        out["spec_acceptance_rate_mean"] = (
            sum(spec_rate) / len(spec_rate)) if spec_rate else None
        # TTFT / inter-token histograms (quantiles are interpolated
        # estimates bounded by the bucket grid; None while empty). One
        # atomic state read per histogram so p50/p99/mean/count describe
        # the same instant while the serve thread keeps observing.
        for key, h in self.latency_histograms().items():
            counts, s, total = h._state()
            out[key + "_p50"] = bucket_quantile(h.buckets, counts, 50)
            out[key + "_p99"] = bucket_quantile(h.buckets, counts, 99)
            out[key + "_mean"] = (s / total) if total else None
            out[key + "_count"] = total
        # dispatches_per_token = TARGET-model dispatches (decode/verify)
        # per emitted token — the tunnel-amortization headline for a
        # host-side draft; device_dispatches_per_token folds in the draft
        # model's own dispatches (ModelDraft pays ~K-1 per round;
        # NGramDraft pays zero) so a small-model draft cannot
        # misread as a round-trip win it does not deliver
        d, t = out.get("dispatches", 0), out.get("tokens_out", 0)
        out["dispatches_per_token"] = (d / t) if t else None
        out["device_dispatches_per_token"] = (
            (d + out.get("draft_dispatches", 0)) / t) if t else None
        # fused decode windows (serving/decode.py fused_serve=K): how
        # many scheduling iterations each device dispatch amortized —
        # ~1.0 unfused, ~K fused; always-present with the window count
        # so the amortization win is a scraped number on any server
        out.setdefault("fused_windows", 0)
        out.setdefault("decode_iterations", 0)
        out["iterations_per_dispatch"] = (
            out["decode_iterations"] / d) if d else None
        # paged KV-cache pool view: always-present keys (zeros/None on a
        # fixed-slot or idle server) so dashboards and the paged A/Bs
        # read one stable surface. prefix_hit_rate is ROW-weighted —
        # the fraction of admitted prompt rows that were already
        # physically resident.
        cap = self._pool_blocks.value
        out["pool_blocks"] = 0 if cap is None else int(cap)
        in_use_last = self._blocks_in_use.last()
        in_use_max = self._blocks_in_use.max()
        out["blocks_in_use_last"] = 0 if in_use_last is None \
            else int(in_use_last)
        out["blocks_in_use_max"] = 0 if in_use_max is None \
            else int(in_use_max)
        live_max = self._live_streams.max()
        out["live_streams_max"] = 0 if live_max is None else int(live_max)
        out.setdefault("prefix_rows_hit", 0)
        out.setdefault("prefix_rows_total", 0)
        out.setdefault("cow_copies", 0)
        out.setdefault("blocked_on_memory", 0)
        out.setdefault("shed_blocks", 0)
        # overload-control view (serving/admission.py): always-present
        # keys so dashboards and the overload A/Bs read one stable
        # surface on any server, controlled or not
        out.setdefault("shed_predicted", 0)
        out.setdefault("shed_brownout", 0)
        out.setdefault("deferred", 0)
        out.setdefault("chunk_dispatches", 0)
        # prefix-hit priority admission (serving/decode.py): admits
        # that genuinely overtook queued cold-prompt work
        out.setdefault("admitted_prefix_priority", 0)
        # durable KV state (serving/kvstate.py): preempt/resume/migrate
        # event counts, host bytes spilled, and restored-prefix hits —
        # always present (eagerly created above; the setdefaults keep
        # the surface stable even for a caller-shared registry)
        out.setdefault("preempted", 0)
        out.setdefault("resumed", 0)
        out.setdefault("migrated", 0)
        out.setdefault("migrated_out", 0)
        out.setdefault("spill_bytes", 0)
        out.setdefault("prefix_restore_hits", 0)
        # fleet-control events (serving/fleet.py): spawn/drain/death,
        # failover replays, canary rollbacks — always present; plus
        # the serving-wire transport counters (serving/wire.py)
        out.setdefault("replica_spawned", 0)
        out.setdefault("replica_drained", 0)
        out.setdefault("replica_dead", 0)
        out.setdefault("replica_degraded", 0)
        out.setdefault("failover_resubmitted", 0)
        out.setdefault("canary_rollbacks", 0)
        out.setdefault("wire_reconnects", 0)
        out.setdefault("wire_retries", 0)
        out.setdefault("migrate_refused", 0)
        # durable control plane (serving/fleetjournal.py): manager
        # generation, recovery re-adoptions, fenced stale-manager ops,
        # journal records — always present
        out.setdefault("manager_epoch", 0)
        out.setdefault("replicas_adopted", 0)
        out.setdefault("fenced_ops", 0)
        out.setdefault("journal_records", 0)
        # blast-radius containment (serving/fleet.py): quarantine/
        # breaker/retry-budget/degraded-mode events — always present,
        # plus the live breaker-state gauge
        out.setdefault("requests_quarantined", 0)
        out.setdefault("breaker_open_total", 0)
        out.setdefault("retry_budget_exhausted", 0)
        out.setdefault("degraded_mode_ticks", 0)
        out.setdefault("infant_deaths", 0)
        # prefix-affinity routing + fleet prefix tier (serving/fleet.py
        # affinity policy + serving/wire.py PREFIX ops): routing
        # verdicts and cross-replica block traffic — always present
        out.setdefault("routed_affinity", 0)
        out.setdefault("routed_spill", 0)
        out.setdefault("prefix_pull_hits", 0)
        out.setdefault("prefix_pull_refused", 0)
        out.setdefault("prefix_pull_bytes", 0)
        out["breaker_state"] = self._breaker_state.value
        out["service_rate_tokens_per_sec"] = self._service_rate.value
        out["prefix_hit_rate"] = (
            out["prefix_rows_hit"] / out["prefix_rows_total"]
            if out["prefix_rows_total"] else None)
        # SLO attainment: met / (met + missed-or-shed). Always present so
        # the traffic-harness round starts from pinned keys.
        out.setdefault("slo_total", 0)
        out.setdefault("slo_met", 0)
        out.setdefault("slo_tokens_met", 0)
        out["slo_attainment"] = (out["slo_met"] / out["slo_total"]
                                 if out["slo_total"] else None)
        return out
