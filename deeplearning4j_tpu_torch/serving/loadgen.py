"""Seeded load generation: arrival processes, size mixes, open/closed
loops.

The port's copy of deeplearning4j_tpu/serving/loadgen.py (stdlib only), held
against it by tests/test_torch_serving_stdlib.py; the text below is the
reference's.

`tools/serve_ab.py` replays fixed backlogs: every request is already
queued when the clock starts, so the servers have only ever been
measured at infinite offered load with zero queueing dynamics.
Production traffic is the opposite regime — requests ARRIVE, at some
rate, in some pattern, and the latency a user sees is mostly what the
arrival process does to the queue. This module generates that traffic:

  * Arrival processes (seeded, deterministic):
      - `PoissonProcess(rate)` — open-loop memoryless arrivals, the
        M/G/k default of load testing;
      - `OnOffProcess(rate_on, on_s, off_s)` — bursty: Poisson bursts
        separated by silence (the p99 killer — mean rate can be low
        while burst-instantaneous rate saturates the slots);
      - `ClosedLoop(concurrency)` — fixed-concurrency virtual clients,
        each submitting its next request when the previous completes.
        Included as the COORDINATED-OMISSION contrast, not the default:
        a closed loop slows its own offered load down exactly when the
        server degrades, hiding the latency it should be measuring.
  * Request-size mixes: `DecodeSizeMix` (weighted prompt/decode length
    components for `ContinuousDecodeServer`), `InferenceSizeMix`
    (feature payloads for `InferenceServer`).
  * `build_schedule(process, mix, n, seed)` -> `Schedule`: the
    DETERMINISTIC artifact. Same (process, mix, n, seed) => byte-
    identical arrival times and payloads — `digest()` is a sha256 over
    the full schedule repr, pinned by tests/test_loadgen.py — so a
    sweep point is reproducible and two arms of an A/B replay the
    identical offered stream. Seeding is string-based (process-stable),
    never `hash()` (randomized per process).
  * `run_load(server, schedule)` -> accounting dict. Open-loop
    schedules are honored by SUBMISSION TIME, never completion time: a
    slow server makes requests pile up in its queue (and shed), it does
    NOT slow the generator down. Avoiding that feedback — coordinated
    omission — is the entire point of open loop, and the no-coordination
    behavior is pinned by test against a stalling fake server.
  * `build_chaos_schedule(duration_s, n_events, seed)` ->
    `ChaosSchedule`: the FAULT-side twin of `build_schedule` — a
    deterministic, string-seeded timeline of fault actions over the
    existing injection sites (`serve.wire.*` severs, `fleet.replica`
    crash, `pause_heartbeats`) plus `manager_kill` (the durable-
    control-plane restart, guaranteed present by default so every
    seeded run exercises recovery). Same (duration, n, seed) =>
    byte-identical timeline (`digest()` pinned); the executor lives in
    `tools/load_sweep.py --chaos`.

Everything here is host-side scheduling (stdlib; numpy only lazily for
the micro-batch payload path). Driving a server adds ZERO device
dispatches beyond the requests themselves — pinned by
tests/test_loadgen.py with the PR 6 dispatch-counter A/B protocol.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import hashlib
import random
import time

from .server import ServerOverloadedError, ServingError

__all__ = ["PoissonProcess", "OnOffProcess", "ClosedLoop",
           "DecodeSizeMix", "SharedPrefixMix", "InferenceSizeMix",
           "Schedule", "ChaosSchedule", "CHAOS_ACTIONS",
           "build_schedule", "build_chaos_schedule", "run_load"]


class PoissonProcess:
    """Open-loop memoryless arrivals at `rate` requests/second."""

    kind = "poisson"
    open_loop = True

    def __init__(self, rate):
        self.rate = float(rate)
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")

    def times(self, n, rng):
        t, out = 0.0, []
        for _ in range(n):
            t += rng.expovariate(self.rate)
            out.append(t)
        return tuple(out)


class OnOffProcess:
    """Bursty open-loop arrivals: Poisson at `rate_on` during `on_s`-long
    bursts separated by `off_s` of silence. Implemented by drawing a
    plain Poisson stream in burst-local time and mapping it onto the
    wall clock, so burst-internal statistics match `PoissonProcess`
    exactly and the mean offered rate is rate_on * on_s/(on_s+off_s)."""

    kind = "onoff"
    open_loop = True

    def __init__(self, rate_on, on_s, off_s):
        self.rate_on = float(rate_on)
        self.on_s = float(on_s)
        self.off_s = float(off_s)
        if self.rate_on <= 0 or self.on_s <= 0 or self.off_s < 0:
            raise ValueError("need rate_on > 0, on_s > 0, off_s >= 0")

    def times(self, n, rng):
        cycle = self.on_s + self.off_s
        t_on, out = 0.0, []
        for _ in range(n):
            t_on += rng.expovariate(self.rate_on)
            k = int(t_on // self.on_s)
            out.append(k * cycle + (t_on - k * self.on_s))
        return tuple(out)


class ClosedLoop:
    """Fixed-concurrency closed loop: `concurrency` virtual clients,
    each submitting its next request the moment the previous completes.
    Arrival times are an OUTPUT of the system under test (which is why
    closed loops under-report queueing latency); the schedule's
    deterministic artifact is the request sequence itself."""

    kind = "closed"
    open_loop = False

    def __init__(self, concurrency):
        self.concurrency = int(concurrency)
        if self.concurrency < 1:
            raise ValueError("concurrency must be >= 1")

    def times(self, n, rng):
        return (0.0,) * n


class DecodeSizeMix:
    """Prompt/decode length mix for the decode server: a weighted list
    of (weight, (prompt_lo, prompt_hi), (new_lo, new_hi)) components
    (hi exclusive, randrange semantics) — e.g. 'mostly short chat turns
    plus a tail of long generations', the shape that separates
    continuous from gang batching. A component may carry a FOURTH
    element, a request-class name ("interactive"/"batch"/...): its
    samples submit under that brownout class, which is how a mixed-
    class workload (the preemption A/B's shape) is generated. Classless
    components emit payloads WITHOUT a klass key, so existing
    schedules' digests are unchanged."""

    def __init__(self, components=((1.0, (3, 16), (4, 44)),), vocab=96):
        self.components = tuple(
            (float(c[0]), (int(c[1][0]), int(c[1][1])),
             (int(c[2][0]), int(c[2][1])),
             str(c[3]) if len(c) > 3 else None)
            for c in components)
        self.vocab = int(vocab)
        if not self.components:
            raise ValueError("need at least one mix component")

    def sample(self, rng):
        pick = rng.random() * sum(w for w, _, _, _ in self.components)
        for w, (plo, phi), (nlo, nhi), klass in self.components:
            pick -= w
            if pick <= 0:
                break
        prompt = tuple(rng.randrange(1, self.vocab)
                       for _ in range(rng.randrange(plo, phi)))
        out = {"prompt": prompt, "max_new": rng.randrange(nlo, nhi)}
        if klass is not None:
            out["klass"] = klass
        return out


class SharedPrefixMix:
    """Shared-system-prompt sessions: every request is one of
    `n_prefixes` SYSTEM PROMPTS followed by a per-request suffix — the
    production prompt shape where prefix caching pays (vLLM's dominant
    mix) and the one a prefix-blind fleet router destroys (N replicas
    each see every prompt ~1/N of the time, so nobody's cache stays
    warm). The system prompts are drawn ONCE, in the constructor, on an
    INDEPENDENT string-seeded stream (``loadgen.prefixes:{seed}``) —
    `build_schedule`'s size stream then only picks WHICH prompt each
    request uses plus its suffix, so the same mix object replayed under
    different schedule seeds keeps the identical prompt population.
    Prefix lengths are BLOCK-ALIGNED (`prefix_blocks` x `block_size`
    tokens): a shared prefix that ends mid-block would leave its tail
    row unsharable in the paged pool AND unhashable by the fleet
    router's block-aligned affinity key."""

    def __init__(self, n_prefixes=4, prefix_blocks=(1, 3), block_size=8,
                 suffix=(1, 9), new=(4, 16), vocab=96, seed=0,
                 klass=None):
        self.n_prefixes = int(n_prefixes)
        self.block_size = int(block_size)
        self.suffix = (int(suffix[0]), int(suffix[1]))
        self.new = (int(new[0]), int(new[1]))
        self.vocab = int(vocab)
        self.klass = str(klass) if klass is not None else None
        if self.n_prefixes < 1:
            raise ValueError("need n_prefixes >= 1")
        if self.block_size < 1:
            raise ValueError("need block_size >= 1")
        blo, bhi = int(prefix_blocks[0]), int(prefix_blocks[1])
        if blo < 1 or bhi <= blo:
            raise ValueError("prefix_blocks must be a (lo, hi) "
                             "randrange pair with lo >= 1")
        rng_p = random.Random(f"loadgen.prefixes:{seed}")
        self.prefixes = tuple(
            tuple(rng_p.randrange(1, self.vocab)
                  for _ in range(rng_p.randrange(blo, bhi)
                                 * self.block_size))
            for _ in range(self.n_prefixes))

    def sample(self, rng):
        prefix = self.prefixes[rng.randrange(self.n_prefixes)]
        tail = tuple(rng.randrange(1, self.vocab)
                     for _ in range(rng.randrange(*self.suffix)))
        out = {"prompt": prefix + tail,
               "max_new": rng.randrange(*self.new)}
        if self.klass is not None:
            out["klass"] = self.klass
        return out


class InferenceSizeMix:
    """Fixed-shape feature payloads for the micro-batch server."""

    def __init__(self, n_features):
        self.n_features = int(n_features)

    def sample(self, rng):
        return {"x": tuple(rng.gauss(0.0, 1.0)
                           for _ in range(self.n_features))}


class Schedule:
    """The deterministic offered-load artifact: arrival offsets (seconds
    relative to run start) + per-request payloads. Two schedules built
    from the same (process, mix, n, seed) are byte-identical —
    `digest()` pins it."""

    __slots__ = ("kind", "arrivals", "items", "concurrency", "meta")

    def __init__(self, kind, arrivals, items, concurrency=None,
                 meta=None):
        self.kind = kind
        self.arrivals = tuple(arrivals)
        self.items = tuple(items)
        self.concurrency = concurrency
        self.meta = dict(meta or {})
        if len(self.arrivals) != len(self.items):
            raise ValueError("arrivals and items must align")

    @property
    def n(self):
        return len(self.items)

    def offered_rps(self):
        """Offered request rate implied by the schedule (None for a
        closed loop, whose rate is an OUTPUT of the system)."""
        if self.kind == "closed" or not self.arrivals \
                or self.arrivals[-1] <= 0:
            return None
        return self.n / self.arrivals[-1]

    def offered_tokens_per_sec(self):
        toks = sum(i.get("max_new", 1) for i in self.items)
        rps = self.offered_rps()
        return None if rps is None else rps * toks / self.n

    def digest(self):
        """sha256 over the schedule's full repr: the byte-identity pin
        (payload tuples + float arrival offsets repr exactly)."""
        payload = repr((self.kind, self.concurrency, self.arrivals,
                        self.items)).encode()
        return hashlib.sha256(payload).hexdigest()


def build_schedule(process, mix, n, seed=0):
    """Materialize `n` requests from an arrival process + size mix.
    Arrival times and payloads draw from independent string-seeded
    streams so changing the mix never perturbs the arrival pattern
    (and vice versa)."""
    rng_t = random.Random(f"loadgen.arrivals:{seed}")
    rng_s = random.Random(f"loadgen.sizes:{seed}")
    arrivals = process.times(int(n), rng_t)
    items = tuple(mix.sample(rng_s) for _ in range(int(n)))
    return Schedule(process.kind, arrivals, items,
                    concurrency=getattr(process, "concurrency", None),
                    meta={"seed": seed})


# the chaos-action alphabet, each mapped to the machinery that executes
# it (tools/load_sweep.py --chaos): the four wire fault-injection sites
# (sever = the named failure scenario, see serving/wire.py's site
# table), the fleet crash site, the hung-process hook, and the durable-
# control-plane restart
CHAOS_ACTIONS = {
    "sever_submit": "serve.wire.submit",
    "sever_stream": "serve.wire.stream",
    "sever_migrate": "serve.wire.migrate",
    "sever_heartbeat": "serve.wire.heartbeat",
    "replica_crash": "fleet.replica",
    "pause_heartbeats": None,       # ReplicaServer.pause_heartbeats
    "manager_kill": None,           # kill + FleetManager.recover()
    "poison": None,                 # poison-pill request: its decode
    #                                 kills the replica it lands on
    #                                 (FleetManager kill_hook) — drives
    #                                 the quarantine verdict
    "spawn_fail": None,             # replica factory failure window —
    #                                 drives the spawn circuit breaker
}


class ChaosSchedule:
    """The deterministic fault timeline: (offset-seconds, action)
    events, time-sorted. Two schedules built from the same
    (duration_s, n_events, seed, actions) are byte-identical —
    `digest()` pins it, exactly like `Schedule.digest()` pins the
    offered load. A chaos run is therefore REPLAYABLE: the same seed
    re-fires the same faults at the same offsets."""

    __slots__ = ("events", "duration_s", "meta")

    def __init__(self, events, duration_s, meta=None):
        events = [dict(e) for e in events]
        for e in events:        # validate BEFORE the sort key reads "t"
            if "t" not in e or "action" not in e:
                raise ValueError("each chaos event needs 't' and "
                                 "'action'")
            if e["action"] not in CHAOS_ACTIONS:
                raise ValueError(
                    f"unknown chaos action {e['action']!r} (known: "
                    f"{', '.join(sorted(CHAOS_ACTIONS))})")
        self.events = tuple(sorted(events, key=lambda e: e["t"]))
        self.duration_s = float(duration_s)
        self.meta = dict(meta or {})

    @property
    def n(self):
        return len(self.events)

    def actions(self):
        return tuple(e["action"] for e in self.events)

    def digest(self):
        payload = repr(tuple(tuple(sorted(e.items()))
                             for e in self.events)).encode()
        return hashlib.sha256(payload).hexdigest()


def build_chaos_schedule(duration_s, n_events, seed=0, actions=None,
                         require_manager_kill=True, require=None):
    """Materialize a seeded chaos timeline: `n_events` actions drawn
    uniformly from `actions` (default: the full `CHAOS_ACTIONS`
    alphabet), at offsets inside the middle 80% of `duration_s` — the
    chaos must land while load is actually flowing, not before the
    first arrival or after the last. String-seeded
    (``loadgen.chaos:{seed}``) like `build_schedule`, never `hash()`.
    With `require_manager_kill` (default), a schedule that drew no
    manager kill has its middle event rewritten to one — every seeded
    run exercises journal recovery, not just wire churn. `require`
    generalizes that: a tuple of actions that must each appear at
    least once, filled in DETERMINISTICALLY (middle slot first) when
    the draw missed them — the cascade arm requires poison +
    spawn_fail + manager_kill, and the rewrite is part of the builder
    so `digest()` still pins the whole timeline from (duration_s,
    n_events, seed, actions, require) alone."""
    rng = random.Random(f"loadgen.chaos:{seed}")
    duration_s = float(duration_s)
    n = int(n_events)
    if n < 1:
        raise ValueError("need n_events >= 1")
    pool = tuple(actions if actions is not None else CHAOS_ACTIONS)
    events = [{"t": round(duration_s * (0.1 + 0.8 * rng.random()), 6),
               "action": pool[rng.randrange(len(pool))]}
              for _ in range(n)]
    if require is None:
        require = ("manager_kill",) if require_manager_kill else ()
    required = tuple(require)
    if len(required) > n:
        raise ValueError(
            f"n_events={n} cannot fit the {len(required)} required "
            f"actions {sorted(required)}")
    have = collections.Counter(e["action"] for e in events)
    slots = [n // 2] + [i for i in range(n) if i != n // 2]
    rewritten = set()
    for action in required:
        if have[action]:
            continue
        for s in slots:
            cur = events[s]["action"]
            # a slot is rewritable unless it holds the ONLY copy of
            # another required action
            if s not in rewritten and \
                    (cur not in required or have[cur] > 1):
                have[cur] -= 1
                events[s]["action"] = action
                have[action] += 1
                rewritten.add(s)
                break
        else:
            raise ValueError(
                f"n_events={n} too small to fit required action "
                f"{action!r} alongside {sorted(required)}")
    return ChaosSchedule(events, duration_s, meta={"seed": seed})


def _default_submit(server, item):
    """(future, expected generated tokens) for the two built-in payload
    kinds: 'prompt' -> ContinuousDecodeServer, 'x' -> InferenceServer."""
    if "prompt" in item:
        # klass forwarded only when the mix stamped one: classless
        # payloads keep the exact legacy call (fake/minimal servers in
        # tests need not grow a klass parameter)
        kw = {"klass": item["klass"]} if "klass" in item else {}
        return (server.submit(list(item["prompt"]), item["max_new"],
                              **kw),
                item["max_new"])
    import numpy as np      # lazy: only the micro-batch path needs arrays
    return server.submit(np.asarray(item["x"], np.float32)), 1


def run_load(server, schedule, submit=None, metrics=None,
             result_timeout=300.0):
    """Drive `server` with `schedule`; returns the accounting dict.

    Open-loop schedules submit at the SCHEDULED arrival time and never
    wait on completions mid-run (`submit_lateness_ms_max` reports how
    faithfully the generator kept to the schedule — it should stay small
    even when the server is drowning). Closed-loop schedules keep
    `schedule.concurrency` requests outstanding. Shed requests
    (`ServerOverloadedError` at submit) are counted, not raised.

    `metrics` defaults to `server.metrics`; SLO/TTFT/shed read-outs are
    DELTAS against a baseline snapshot taken at entry, so a reused
    server's earlier traffic (compile warm-up included) stays off this
    run's books.
    """
    from ..obs.registry import bucket_quantile, fmt, percentile
    from .metrics import shed_view, slo_view

    submit = submit or _default_submit
    if metrics is None:
        metrics = getattr(server, "metrics", None)
    base = metrics.snapshot() if metrics is not None else None
    # TTFT / inter-token read-outs must cover THIS run only: histogram
    # bucket counts are cumulative, so per-run quantiles come from the
    # bucket-count DELTA against entry (a reservoir couldn't do this)
    hists = (metrics.latency_histograms()
             if hasattr(metrics, "latency_histograms") else {})
    base_counts = {k: h.counts() for k, h in hists.items()}

    recs = []               # (future, expected_tokens, t_submit_abs)
    done_at = {}            # future -> completion wall time (callback)
    shed = 0
    lateness = []           # open-loop only: submit_actual - scheduled
    t0 = time.monotonic()

    def _mark_done(f):
        done_at[f] = time.monotonic()

    if schedule.kind != "closed":
        for arr, item in zip(schedule.arrivals, schedule.items):
            # honor the schedule by SUBMISSION time: sleep to the
            # scheduled offset, submit, move on — never block on a
            # result (coordinated omission is the bug, not a feature)
            while True:
                now = time.monotonic()
                if now - t0 >= arr:
                    break
                time.sleep(min(arr - (now - t0), 0.05))
            try:
                fut, toks = submit(server, item)
            except ServerOverloadedError:
                shed += 1
                continue
            t_sub = time.monotonic()
            lateness.append((t_sub - t0) - arr)
            fut.add_done_callback(_mark_done)
            recs.append((fut, toks, t_sub))
    else:
        conc = schedule.concurrency or 1
        pending, idx = set(), 0
        while idx < schedule.n or pending:
            while idx < schedule.n and len(pending) < conc:
                try:
                    fut, toks = submit(server, schedule.items[idx])
                except ServerOverloadedError:
                    shed += 1
                    idx += 1
                    continue
                t_sub = time.monotonic()
                fut.add_done_callback(_mark_done)
                pending.add(fut)
                recs.append((fut, toks, t_sub))
                idx += 1
            if pending:
                done, _ = cf.wait(pending, timeout=result_timeout,
                                  return_when=cf.FIRST_COMPLETED)
                if not done:
                    raise TimeoutError(
                        f"closed loop: no completion in "
                        f"{result_timeout}s ({len(pending)} pending)")
                pending -= done

    completed = failed = tokens_out = 0
    lat_ms = []
    deadline = time.monotonic() + result_timeout
    for fut, toks, t_sub in recs:
        try:
            fut.result(max(0.0, deadline - time.monotonic()))
        except ServingError:
            failed += 1     # shed mid-flight / deadline / closed: counted
            continue
        except Exception:   # noqa: BLE001 — accounting must finish
            failed += 1
            continue
        completed += 1
        tokens_out += toks
        # completion time came from the done callback; fall back to now
        # for a result() that raced the callback registration
        lat_ms.append((done_at.get(fut, time.monotonic()) - t_sub) * 1e3)
    t_end = max(done_at.values(), default=time.monotonic())
    duration = max(t_end - t0, 1e-9)
    lat_ms.sort()

    out = {
        "schedule": {
            "kind": schedule.kind, "n": schedule.n,
            "digest": schedule.digest(),
            "concurrency": schedule.concurrency,
            "offered_rps": fmt(schedule.offered_rps(), 3),
            "offered_tokens_per_sec": fmt(
                schedule.offered_tokens_per_sec(), 1)},
        "submitted": len(recs) + shed,
        "admitted": len(recs),
        "shed_at_submit": shed,
        "completed": completed,
        "failed": failed,
        "tokens_out": tokens_out,
        "duration_s": fmt(duration, 4),
        "requests_per_sec": fmt(completed / duration, 2),
        "tokens_per_sec": fmt(tokens_out / duration, 1),
        "latency_ms": {"p50": fmt(percentile(lat_ms, 50)),
                       "p95": fmt(percentile(lat_ms, 95)),
                       "p99": fmt(percentile(lat_ms, 99)),
                       "mean": fmt(sum(lat_ms) / len(lat_ms))
                       if lat_ms else None},
        "submit_lateness_ms_max": fmt(
            max(lateness) * 1e3 if lateness else None),
    }
    if metrics is not None:
        snap = metrics.snapshot()
        produced = snap.get("tokens_out", 0) - (base or {}).get(
            "tokens_out", 0)
        thru = (tokens_out / duration) if produced \
            else (completed / duration)
        out["slo"] = slo_view(snap, thru, base)
        for k, h in hists.items():
            delta = [c - b for c, b in zip(h.counts(), base_counts[k])]
            out[k + "_p50"] = fmt(bucket_quantile(h.buckets, delta, 50))
            out[k + "_p99"] = fmt(bucket_quantile(h.buckets, delta, 99))
            out[k + "_count"] = sum(delta)
        # shed-reason BREAKDOWN (the one shed_view implementation):
        # `shed_at_submit` above counts what THIS generator saw; the
        # per-cause deltas say why — queue backpressure vs deadline
        # expiry vs KV-block shortage vs predicted-miss admission vs
        # brownout policy — which is the difference between "the server
        # dropped work" and "overload control worked as designed"
        out["sheds"] = shed_view(snap, base)
    return out
