"""Replica fleet manager: the observability plane's tested ACTUATOR.

The port's copy of deeplearning4j_tpu/serving/fleet.py, held against it by
tests/test_torch_fleet_manager.py and tests/test_torch_fleet_recovery.py.
The control plane is the reference's, line for line; the one place that
touches parameters, the canary's NaN/Inf screen (`_params_finite`), runs
`torch.isfinite` over the model's parameters where they live and reads one
verdict on the host. The text below is the reference's, less its history
notes.

The observability plane built the fleet's sensors — kind-correct
metrics federation (`obs.fleet.FleetView`), stitched traces, and
`AutoscaleSignal`, the
hysteresis-bounded scale detector. This module closes the loop: a
`FleetManager` owns N in-process `ContinuousDecodeServer` replicas
behind a router and ACTS on what the sensors say.

  * **Router** — the round-robin splitter promoted into the
    package (`RoundRobinSplitter` stays available as the deliberately
    dumb baseline/A-B arm) and grown into a real front door:
    least-backlog dispatch over ALIVE replicas, a per-replica health
    state machine (healthy -> degraded -> dead, driven by each
    replica's `ServingMetrics` shed/failure deltas and a serve-thread
    liveness probe), and `RetryPolicy`-bounded resubmission on
    failover. The manager's `submit()` future is the caller's ONE
    handle: it resolves with the token stream no matter which replica
    (or how many, across failovers) produced it. The control plane is
    host-side only — the no-fault fleet path adds ZERO device
    dispatches per token over N bare servers (dispatch-counter A/B,
    tests/test_fleet_manager.py).

  * **Prefix-affinity routing + the fleet prefix tier** — the
    `affinity` policy consistent-hashes each request's block-aligned
    leading prompt tokens over alive replicas (vnode ring, ~1/N keys
    remap per replica churned) so a shared-system-prompt family keeps
    hitting ONE replica's warm prefix cache at any fleet size, with a
    load-aware spill rule (`spill_factor`/`spill_slack`) that falls to
    the least-backlog survivor — counted `routed_affinity` /
    `routed_spill` — before stickiness becomes a hotspot. When a key
    routes somewhere the manager believes cold while a peer is warm,
    an async PREFIX_PULL ships the peer's resident chain
    (`PrefixCacheArtifact` over the existing wire frames, tag-checked
    at adoption) into the cold replica instead of recomputing it —
    off the dispatch path, budget-bounded at both ends, so the
    no-pull path adds ZERO device dispatches per token.

  * **Closed autoscale loop** — each `control_tick()` federates every
    replica's `kind_snapshot()` into one fleet snapshot, feeds it to
    the `AutoscaleSignal`, and ACTS: `scale_up` spawns a fresh replica
    (factory-built, warmed, fleet-unique instance id — ids are NEVER
    reused, so federation and traces can never alias a dead replica
    with its successor); `scale_down` gracefully drains one —
    `drain(migrate=True)` moves its live decode-phase requests to
    survivors as `RequestArtifact`s (resumed streams bit-identical,
    the durable-KV pin exercised across the router) and replays its
    queued/prefilling requests from their prompts. After every action
    the signal resets: the next move must be argued entirely from
    observations of the NEW fleet shape. The detector's scale_down
    occupancy input is the manager-computed UTILIZATION (delivered
    tokens/s over the tick window / fleet capacity): the per-replica
    occupancy reservoirs are iteration-weighted and no iterations run
    at idle, so a quiet fleet would otherwise never read as idle.

  * **Health-gated canary rollout** — `rollout(new_lm)` screens the
    new params with `rowwise_finite` FIRST (a NaN/Inf leaf rolls back
    before any replica — and therefore any request — ever touches the
    poisoned weights), then hot-swaps ONE canary replica and watches
    it over a probation window: failure/unhealthy-output deltas, SLO
    attainment, and shed deltas vs the survivors. A tripped gate swaps
    the canary back (`canary_rollbacks` counted) — version-tagged
    params mean the prefix index and admission already cooperate, and
    the dual-version drain keeps every in-flight request alive through
    both the swap and the rollback. A passing gate rolls forward
    replica by replica; future spawns inherit the new params.

  * **Crash survival** — `FaultInjector` sites: `fleet.submit` (fired
    per routed request — a raising rule is a router fault) and
    `fleet.replica` (fired once per alive replica per control tick;
    the SEVER action is replica death mid-stream — it lands on
    `ContinuousDecodeServer.kill()`, which fails every in-flight
    future loudly with `ReplicaDeadError`). The router marks the
    replica dead, takes a final counters-only snapshot (a TOMBSTONE,
    so federated counters stay monotone after the instance is gone),
    and resubmits the dead replica's in-flight requests to survivors
    via prompt replay: deterministic greedy decode makes the replayed
    stream bit-identical to an uninterrupted solo run, so a crash
    costs latency, never bits — and never a silently lost future
    (every admitted future resolves: completed via failover replay or
    failed loudly with a named error). The autoscale loop backfills
    capacity: `control_tick()` re-spawns up to `min_replicas` before
    consulting the signal.

  * **Blast-radius containment** (ARCHITECTURE.md has the full rules):
    three disciplines that keep one bad request, one bad config, or
    one overload wave from taking the whole fleet down. (1) POISON-
    PILL QUARANTINE: the manager records which replica deaths each
    in-flight request was aboard for; a request implicated in
    `_QUARANTINE_DEATHS` distinct deaths is the probable killer — its
    outer future fails with `PoisonPillError` (never replayed again),
    its prompt fingerprint enters a bounded quarantine set that sheds
    re-submissions at admission, and the event is journaled so
    `recover()` doesn't resurrect it. (2) SPAWN CIRCUIT BREAKER:
    a replica dying within `infant_mortality_s` of spawn is a strike;
    K consecutive strikes OPEN the breaker — backfill stops crash-
    looping and probes with ONE spawn per exponential-backoff window
    (half-open) until a probe survives infancy. While open the fleet
    runs DEGRADED: it serves on the replicas it has and sheds the
    lowest request classes via the `BrownoutPolicy` seam, so
    accounting (admitted == completed + failed) holds with less
    capacity. (3) FLEET-WIDE RETRY BUDGET: failover replays and wire
    resends share one `RetryBudget` token bucket (refilled as a
    fraction of completions); exhaustion converts the retry into a
    loud `RetryBudgetExhaustedError` instead of amplifying load — the
    metastable-failure guard.

The manager itself publishes the fleet-control event counters —
`replica_spawned` / `replica_drained` / `replica_dead` /
`failover_resubmitted` / `canary_rollbacks` — plus the containment
counters (`requests_quarantined` / `breaker_open_total` /
`retry_budget_exhausted` / `degraded_mode_ticks` / `infant_deaths`
and the `breaker_state` gauge) — through its own `ServingMetrics`
(always-present snapshot keys, on the Prometheus route like every
other endpoint) and overlays them onto `fleet_snapshot()` as
`fleet_*` keys next to the federation read-outs.
"""
from __future__ import annotations

import bisect
import collections
import concurrent.futures as cf
import hashlib
import itertools
import logging
import os
import threading
import time

from ..common.resilience import (RetryBudgetExhaustedError, RetryPolicy)
from ..obs.fleet import SHED_KEYS, AutoscaleSignal, FleetView
from .admission import SHED as BROWNOUT_SHED
from .fleetjournal import FleetJournal, fold_records, replay_journal
from .kvstate import KVStateError, KVStateVersionError
from .metrics import ServingMetrics
from .server import (DeadlineExceededError, PoisonPillError,
                     ReplicaDeadError, ServerClosedError,
                     ServerOverloadedError, UnhealthyOutputError,
                     _fail_future, _ParamsView, _resolve_future)

log = logging.getLogger(__name__)

__all__ = ["FleetManager", "RoundRobinSplitter", "HEALTHY", "DEGRADED",
           "DRAINING", "DEAD", "BREAKER_CLOSED", "BREAKER_OPEN",
           "BREAKER_HALF_OPEN"]

# replica health states (the router's per-replica state machine):
# HEALTHY and DEGRADED are routable (healthy preferred), DRAINING
# takes no new work while its requests move out, DEAD is a tombstone
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
DEAD = "dead"

# spawn circuit-breaker states: CLOSED spawns freely, OPEN refuses
# (degraded mode), HALF_OPEN has exactly one probe spawn in flight.
# The `breaker_state` gauge publishes them as 0 / 1 / 0.5.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"
_BREAKER_GAUGE = {BREAKER_CLOSED: 0.0, BREAKER_HALF_OPEN: 0.5,
                  BREAKER_OPEN: 1.0}

# distinct replica deaths that convict an in-flight request as the
# poison pill (one death has too many innocent co-victims; two
# distinct replicas dying under the same request is the signature)
_QUARANTINE_DEATHS = 2


def _fingerprint(prompt, params_version):
    """Quarantine identity of a request: sha256 over the prompt tokens
    + the params version they would decode under (the same prompt is a
    DIFFERENT request against different weights)."""
    payload = repr((tuple(int(t) for t in prompt),
                    int(params_version or 0))).encode()
    return hashlib.sha256(payload).hexdigest()


# consistent-hash ring (the affinity policy): each replica owns
# `_RING_VNODES` pseudo-random points on a 64-bit circle; a key routes
# to the first replica point clockwise of its own hash. Adding or
# removing ONE replica moves only the arcs adjacent to its points —
# ~1/N of the key space — so fleet churn never reshuffles (and thereby
# cold-starts) every replica's warm prefix cache at once. Module-level
# and stdlib-pure so the ring-stability property test drives them
# directly.
_RING_VNODES = 64


def _ring_hash(data):
    """Stable 64-bit point on the ring (sha256, never `hash()` — the
    per-process randomization would reshuffle placement every run)."""
    if not isinstance(data, bytes):
        data = repr(data).encode()
    return int.from_bytes(hashlib.sha256(data).digest()[:8], "big")


def _build_ring(names, vnodes=_RING_VNODES):
    """Sorted (point, name) list over `names`, `vnodes` points each."""
    ring = []
    for name in names:
        for v in range(vnodes):
            ring.append((_ring_hash(f"{name}:{v}".encode()), name))
    ring.sort()
    return ring


def _ring_lookup(ring, keyhash, exclude=()):
    """First owner clockwise of `keyhash` whose name is not excluded
    (None on an empty/fully-excluded ring)."""
    if not ring:
        return None
    i = bisect.bisect_left(ring, (keyhash, ""))
    for off in range(len(ring)):
        _, name = ring[(i + off) % len(ring)]
        if name not in exclude:
            return name
    return None


class RoundRobinSplitter:
    """The fleet's plain front door (the reference's tools/load_sweep.py):
    submit() rotates over N replicas. Deliberately dumb — observability
    sweeps measure the fleet plane, not placement policy, and the
    FleetManager's zero-added-dispatch A/B compares against exactly
    this (a shed at one replica is a fleet shed, both arms)."""

    def __init__(self, servers):
        self._servers = list(servers)
        self._i = 0

    def submit(self, prompt, max_new, **kw):
        srv = self._servers[self._i % len(self._servers)]
        self._i += 1
        return srv.submit(prompt, max_new, **kw)


def _params_finite(lm):
    """The canary NaN/Inf screen: every float leaf of (aux, blocks)
    all-finite. `torch.isfinite` runs where the parameters live (on the
    card for a card model) and the verdict reaches the host in ONE read:
    the weights are never copied to the host to be screened."""
    import torch

    from ..models.zoo.transformer import tree_leaves
    flags = [torch.isfinite(leaf.detach()).all()
             for leaf in tree_leaves(lm.aux, lm.blocks)
             if leaf.is_floating_point()]
    return not flags or bool(torch.stack(flags).all())


class _FleetRequest:
    """Manager-side record of one admitted request: the caller-facing
    OUTER future plus everything a failover replay needs."""

    __slots__ = ("prompt", "max_new", "deadline", "klass", "outer",
                 "attempts", "replica", "deaths", "fp", "akey")

    def __init__(self, prompt, max_new, deadline, klass, fp=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.deadline = deadline        # absolute monotonic, or None
        self.klass = klass
        self.outer = cf.Future()
        self.attempts = 0               # failover resubmissions so far
        self.replica = None             # current replica name
        self.deaths = set()             # replica deaths it was aboard for
        self.fp = fp                    # quarantine fingerprint
        self.akey = None                # block-aligned affinity key


class _Replica:
    __slots__ = ("name", "server", "state", "seq", "inflight",
                 "probe_sheds", "probe_failed", "born", "keys_seen")

    def __init__(self, name, server, seq, born=None):
        self.name = name
        self.server = server
        self.state = HEALTHY
        self.seq = seq                  # spawn order (tie-breaks)
        self.inflight = 0               # manager-tracked live requests
        self.probe_sheds = 0            # health probe baselines
        self.probe_failed = 0
        self.keys_seen = collections.OrderedDict()  # affinity keys
        #   routed here (bounded) — the manager's believed-warm set
        #   that decides when a prefix pull is worth scheduling
        self.born = born                # spawn monotonic (None: adopted
        #                                 — an adoptee's age is unknown,
        #                                 so it can never strike the
        #                                 spawn breaker as an infant)


class FleetManager:
    """N replicas, one front door, three closed loops (module
    docstring).

    `factory(name)` builds ONE replica (a `ContinuousDecodeServer`,
    running or not — the manager starts it) under the fleet-unique
    instance `name` the manager mints; it is called for the initial
    `n_replicas` at `start()` and again on every scale_up/backfill.
    `warmup(server)` (optional) runs after each spawn — compile the
    prompt buckets off the serving clock there.

    `signal` is the `AutoscaleSignal` `control_tick()` consults (None:
    no autoscaling — the manager is a router + failover only, which is
    exactly what the observe-only sweeps want). `policy` is
    "least_backlog" (default), "round_robin" (the A/B arm), or
    "affinity": consistent-hash the request's block-aligned leading
    prompt tokens (`affinity_blocks` x `affinity_block` of them — the
    shared-system-prompt identity) over alive replicas so one prompt
    family always lands on one replica's warm prefix cache, with a
    load-aware SPILL — when the affine replica's backlog exceeds
    `spill_factor` x the fleet minimum + `spill_slack`, the request
    falls to the least-backlog survivor instead (`routed_spill`
    counted; the sticky choice must never become a hotspot SLO leak).
    With `prefix_pull` (default), routing a key to a replica the
    manager believes cold while a peer is warm schedules an async
    PREFIX_PULL of the peer's resident chain (off the dispatch path,
    bounded fleet-wide by `prefix_pull_budget_bytes`) — the spilled/
    remapped replica adopts the blocks instead of recomputing them.
    """

    # request-level VERDICTS settle the outer future as-is; everything
    # else is infrastructure and fails over. RequestMigratedError /
    # RequestDrainedError are deliberately NOT verdicts here: on an
    # inner future they only ever mean the request's state moved (the
    # manager's own drain, or an out-of-band operator migrate racing
    # it) — replaying on a survivor still yields the correct stream,
    # while propagating would fail the caller with a handoff-protocol
    # internal on e.g. a drain that completed just after its timeout.
    _PROPAGATE = (DeadlineExceededError, ServerOverloadedError,
                  UnhealthyOutputError, RetryBudgetExhaustedError,
                  ValueError)

    def __init__(self, factory, n_replicas=2, *, signal=None,
                 policy="least_backlog", min_replicas=None,
                 max_replicas=None, retry_policy=None,
                 heartbeat_timeout=None, fault_injector=None,
                 metrics=None, name="fleet", warmup=None,
                 degrade_shed_rate=25, name_prefix="i",
                 journal=None, retry_budget=None, brownout=None,
                 kill_hook=None, infant_mortality_s=5.0,
                 breaker_strikes=3, breaker_backoff_s=0.5,
                 breaker_max_backoff_s=30.0, quarantine_capacity=256,
                 journal_compact_bytes=None, affinity_block=8,
                 affinity_blocks=1, spill_factor=2.0, spill_slack=4,
                 prefix_pull=True, prefix_pull_budget_bytes=64 << 20):
        if policy not in ("least_backlog", "round_robin", "affinity"):
            raise ValueError(f"unknown routing policy {policy!r}")
        if int(n_replicas) < 1:
            raise ValueError("need n_replicas >= 1")
        if int(breaker_strikes) < 1:
            raise ValueError("need breaker_strikes >= 1")
        self._factory = factory
        self._n_initial = int(n_replicas)
        self.signal = signal
        self._policy = policy
        self.min_replicas = (int(min_replicas) if min_replicas is not None
                             else self._n_initial)
        self.max_replicas = (int(max_replicas) if max_replicas is not None
                             else self._n_initial + 4)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}")
        # failover budget + pacing: the policy bounds resubmissions per
        # request; classification (what IS a failover vs a request
        # verdict) is the manager's explicit table, not `retryable`.
        # Both are PUBLIC wire config too: remote replicas
        # (serving/wire.py RemoteReplica) inherit the retry policy for
        # reconnect-with-resend and `heartbeat_timeout` for the
        # ack-silence reap that feeds the healthy→degraded→dead state
        # machine (`_spawn` pushes them through `configure_wire`).
        self._retry = retry_policy if retry_policy is not None else \
            RetryPolicy(max_retries=3, base_delay=0.0, jitter=0.0)
        # the fleet-wide retry budget rides ON the retry policy (the
        # shared hook): the same object `configure_wire` hands every
        # remote replica, so wire resends and failover replays spend
        # from ONE bucket
        if retry_budget is not None:
            self._retry.budget = retry_budget
        self.heartbeat_timeout = (None if heartbeat_timeout is None
                                  else float(heartbeat_timeout))
        self._injector = fault_injector
        self.metrics = metrics or ServingMetrics(name=name)
        self.name = name
        self._warmup = warmup
        self.degrade_shed_rate = float(degrade_shed_rate)
        self._lock = threading.RLock()
        self._replicas = collections.OrderedDict()   # name -> _Replica
        self._tombstones = collections.OrderedDict()  # name -> counters
        self._live = {}             # inner future -> _FleetRequest
        self._name_ids = itertools.count()
        self._name_prefix = str(name_prefix)
        self._seq = itertools.count()
        self._rr = 0                # round-robin rotation
        # prefix-affinity routing (module docstring): the consistent-
        # hash ring over alive replicas, the block geometry of the
        # affinity key, the load-aware spill rule, and the fleet
        # prefix tier's pull budget/in-flight dedup
        self.affinity_block = int(affinity_block)
        self.affinity_blocks = int(affinity_blocks)
        if self.affinity_block < 1 or self.affinity_blocks < 1:
            raise ValueError("need affinity_block >= 1 and "
                             "affinity_blocks >= 1")
        self.spill_factor = float(spill_factor)
        self.spill_slack = int(spill_slack)
        if self.spill_factor < 1.0 or self.spill_slack < 0:
            raise ValueError("need spill_factor >= 1.0 and "
                             "spill_slack >= 0")
        self.prefix_pull = bool(prefix_pull)
        self._pull_budget_left = int(prefix_pull_budget_bytes)
        self._pulls_inflight = set()    # (dst name, key) being pulled
        self._ring = []                 # sorted (point, name)
        self._ring_names = ()           # roster the ring was built for
        self._keys_seen_cap = 512       # per-replica believed-warm cap
        self._running = False
        self._rolling = False       # a rollout is mid-probation:
        #                             control_tick holds scale actions
        self._params = None         # (aux, blocks) spawns must carry
        #                             (set by a rolled-forward rollout)
        self._ctl_thread = None
        self._ctl_stop = threading.Event()
        self._ticks = 0
        self._last_tick = None      # (monotonic, fleet tokens_out) —
        #                             the utilization window
        # blast-radius containment state (module docstring):
        # quarantine — bounded ordered set of poison fingerprints
        self._quarantine = collections.OrderedDict()
        self._quarantine_cap = int(quarantine_capacity)
        # spawn circuit breaker — strike counter + state machine
        self.infant_mortality_s = float(infant_mortality_s)
        self.breaker_strikes = int(breaker_strikes)     # K
        self._breaker = BREAKER_CLOSED
        self._strikes = 0
        self._last_strike = 0.0     # monotonic of the latest strike:
        #                             a spawn born after it that
        #                             survives infancy breaks the
        #                             CONSECUTIVE-strike chain
        self._breaker_backoff0 = float(breaker_backoff_s)
        self._breaker_backoff = float(breaker_backoff_s)
        self._breaker_max_backoff = float(breaker_max_backoff_s)
        self._breaker_until = 0.0   # monotonic: next half-open probe
        self._probe_name = None     # the one in-flight probe replica
        # degraded-mode brownout (None: degraded mode serves what it
        # can but sheds nothing — the legacy behavior)
        self._brownout = brownout
        # chaos seam: kill_hook(prompt, replica_name) -> truthy crashes
        # the replica the request just landed on (a poison decode)
        self._kill_hook = kill_hook
        self._journal_compact_bytes = (
            None if journal_compact_bytes is None
            else int(journal_compact_bytes))
        # durable control plane (serving/fleetjournal.py): `journal`
        # (a path) makes every state transition a fsync'd WAL record.
        # Each manager GENERATION bumps the monotone epoch past
        # whatever the journal already holds — a successor recovering
        # from the same file outranks (and fences out) its
        # predecessor; minted names resume PAST the journaled ones so
        # instance ids stay fleet-unique across generations.
        self._journal = None
        self._params_version = 0
        self.epoch = 0
        if journal is not None:
            prior = fold_records(replay_journal(journal),
                                 name_prefix=self._name_prefix)
            self.epoch = prior["epoch"] + 1
            self._params_version = prior["params_version"] or 0
            if prior["max_id"] >= 0:
                self._name_ids = itertools.count(prior["max_id"] + 1)
            # containment state survives the manager: quarantined
            # fingerprints keep shedding (recover() must not resurrect
            # the killer) and an OPEN breaker stays open (the successor
            # must not resume the spawn crash-loop its predecessor
            # escaped — it probes after a fresh backoff instead)
            for fp in prior.get("quarantine") or ():
                self._quarantine[fp] = True
            while len(self._quarantine) > self._quarantine_cap:
                self._quarantine.popitem(last=False)
            br = prior.get("breaker")
            if br and br.get("state") in (BREAKER_OPEN,
                                          BREAKER_HALF_OPEN):
                self._breaker = BREAKER_OPEN
                self._strikes = int(br.get("strikes") or
                                    self.breaker_strikes)
                self._breaker_backoff = min(
                    self._breaker_max_backoff,
                    float(br.get("backoff_s") or self._breaker_backoff))
                self._breaker_until = (time.monotonic()
                                       + self._breaker_backoff)
                self.metrics.record_breaker_state(
                    _BREAKER_GAUGE[BREAKER_OPEN])
            self._journal = FleetJournal(journal, counters=self.metrics)
            self._journal.append("epoch", epoch=self.epoch)
            # counter == this manager's generation (bumped by delta so
            # a reused metrics sink stays monotone)
            cur = self.metrics.count_value("manager_epoch")
            if self.epoch > cur:
                self.metrics.count("manager_epoch", self.epoch - cur)

    def _journal_append(self, kind, **fields):
        """Best-effort durable record of one state transition: journal
        failures must never take a crash/drain path down with them
        (several run on done-callback threads) — they log loudly and
        the fleet keeps serving."""
        j = self._journal
        if j is None:
            return
        try:
            j.append(kind, epoch=self.epoch, **fields)
        except Exception:   # noqa: BLE001 — the WAL is not the fleet
            log.exception("fleet journal append failed (%s)", kind)

    # -- lifecycle -----------------------------------------------------
    def start(self, control_interval_s=None):
        """Spawn the initial replicas (idempotent) and, with
        `control_interval_s`, a daemon control thread running
        `control_tick()` on that cadence. Tests and the sweep drive
        ticks manually instead. Each guard is independent: a manager
        that is already running (e.g. built by `recover()`, which
        reconciles its own roster) still gets its control thread here,
        but never a second one."""
        if not self._running:
            self._running = True
            while self.n_alive() < self._n_initial:
                self._spawn()
        if control_interval_s is not None and self._ctl_thread is None:
            self._ctl_stop.clear()

            def _loop():
                while not self._ctl_stop.wait(float(control_interval_s)):
                    try:
                        self.control_tick()
                    except Exception:   # noqa: BLE001 — keep ticking
                        log.exception("control tick failed")

            self._ctl_thread = threading.Thread(
                target=_loop, name="fleet-control", daemon=True)
            self._ctl_thread.start()
        return self

    def stop(self, drain=True, timeout=60.0):
        """Stop the control loop and every replica. drain=True lets
        each replica serve what it already admitted; drain=False fails
        queued work (`ServerClosedError`) — either way every manager
        future resolves (the replicas' own stop contracts + the
        failover path's not-running check)."""
        self._running = False
        self._ctl_stop.set()
        t = self._ctl_thread
        if t is not None:
            t.join(timeout)
            self._ctl_thread = None
        stopped = set()
        while True:
            with self._lock:
                recs = [r for r in self._replicas.values()
                        if r.name not in stopped]
            if not recs:
                break       # second sweep: a spawn that was mid-flight
            #                 when _running dropped still gets stopped
            for rec in recs:
                stopped.add(rec.name)
                try:
                    rec.server.stop(drain=drain, timeout=timeout)
                except Exception:   # noqa: BLE001 — teardown finishes
                    log.exception("replica %s stop failed", rec.name)
                # a cleanly stopped replica leaves the durable roster:
                # a successor recovering this journal must not re-dial
                # (or backfill-count) what this generation shut down
                self._journal_append("replica_drained", name=rec.name,
                                     reason="manager stop")
        j, self._journal = self._journal, None
        if j is not None:
            try:
                j.append("manager_stop", epoch=self.epoch)
                j.close()
            except Exception:   # noqa: BLE001 — teardown finishes
                log.exception("fleet journal close failed")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @classmethod
    def recover(cls, factory, journal_path, *, redial=None,
                params_lm=None, identity_dir=None, backfill=True,
                control_interval_s=None, **kwargs):
        """Build a SUCCESSOR manager from a predecessor's journal: the
        durable-control-plane recovery path (module docstring; the
        reconcile rules live in ARCHITECTURE.md).

        Replays `journal_path` (a mid-file corruption refuses loudly
        with `JournalCorruptError`; a torn final record is a crash
        artifact and drops silently), folds it to the intended roster,
        then reconciles against reality:

          * every listed replica is re-dialed (`redial(name, ident)` —
            default: a fresh `RemoteReplica` to the journaled
            host:port) and its HELLO identity VERIFIED against the
            journal (instance name, pid, process start-time): a
            recycled port owned by an unrelated process is refused
            loudly (`adopt_identity_mismatch` counted, local-only
            teardown — never a KILL frame at a stranger) instead of
            adopted;
          * verified replicas are RE-ADOPTED (`replicas_adopted`
            counted): router, health probe, federation and in-flight
            accounting resume, and the new generation's epoch is
            announced so the predecessor is fenced out;
          * with `identity_dir`, a listed replica whose identity file
            is GONE exited cleanly (`run_replica_server` removes it on
            graceful exit) and is skipped without a dial;
          * a replica mid-drain (`drain_begin` with no completion) is
            never re-adopted — its predecessor was emptying it; it is
            put down best-effort and backfilled;
          * a half-finished canary (`canary_begin` with no verdict)
            rolls back DETERMINISTICALLY: the canary alone holds
            unvetted params, so it is crashed (`canary_rollbacks`
            counted) and the backfill rebuilds it on known-good
            factory params;
          * dead/unreachable listed replicas — and, with `backfill`
            (default), any capacity shortfall — are backfilled to
            `min_replicas` through the normal spawn path.

        `params_lm` (optional) restores the rolled-forward parameter
        set for FUTURE spawns when the journal records a fleet-wide
        roll-forward; `control_interval_s` (optional) starts the
        periodic control thread exactly as `start()` would — and a
        later `mgr.start(control_interval_s=...)` on the recovered
        manager does the same (`kwargs` pass through to the
        constructor). Returns the running successor — its epoch is the
        journal's highest + 1, its minted names resume past the
        journal's."""
        records = replay_journal(journal_path)
        intent = fold_records(records,
                              name_prefix=kwargs.get("name_prefix", "i"))
        mgr = cls(factory, journal=journal_path, **kwargs)
        mgr._running = True
        if redial is None:
            def redial(name, ident):
                from .wire import RemoteReplica
                if not ident.get("port"):
                    raise ConnectionError(
                        f"no wire identity journaled for {name!r}")
                return RemoteReplica(ident.get("host") or "127.0.0.1",
                                     ident["port"])
        roster = sorted(intent["roster"].items(),
                        key=lambda kv: (kv[1].get("seq") or 0, kv[0]))
        for name, ident in roster:
            if ident.get("draining"):
                # the predecessor was emptying it: routing new work
                # there would resurrect a replica mid-goodbye — put it
                # down best-effort and let the backfill replace it
                try:
                    srv = redial(name, ident)
                    srv.kill()
                except Exception:   # noqa: BLE001 — already gone
                    pass
                mgr._journal_append("replica_dead", name=name,
                                    reason="mid-drain at recovery")
                continue
            if identity_dir is not None and not os.path.exists(
                    os.path.join(str(identity_dir), f"{name}.json")):
                # graceful exits remove their identity file: nothing
                # crashed, nothing to re-adopt, nothing to put down
                mgr._journal_append("replica_drained", name=name,
                                    reason="clean exit before recovery")
                continue
            try:
                srv = redial(name, ident)
            except Exception as e:  # noqa: BLE001 — dead is dead
                mgr._journal_append(
                    "replica_dead", name=name,
                    reason=f"unreachable at recovery: {e}")
                continue
            inst = getattr(srv, "instance", None)
            pid = getattr(srv, "pid", None)
            st = getattr(srv, "start_time", None)
            mismatch = (
                (inst is not None and inst != name)
                or (ident.get("pid") is not None and pid is not None
                    and pid != ident["pid"])
                or (ident.get("start_time") is not None
                    and st is not None
                    and st != ident["start_time"]))
            if mismatch:
                # a recycled port: whoever answered is NOT the replica
                # the journal listed. Refuse loudly, tear down the
                # local wire half ONLY — a KILL/STOP frame would drive
                # an unrelated process
                mgr.metrics.count("adopt_identity_mismatch")
                log.error(
                    "re-adoption of %s refused: identity mismatch "
                    "(instance %r pid %r start %r vs journaled "
                    "%r/%r/%r)", name, inst, pid, st, name,
                    ident.get("pid"), ident.get("start_time"))
                if hasattr(srv, "_shutdown_local"):
                    srv._shutdown_local(ServerClosedError(
                        "identity mismatch at re-adoption"), dead=False)
                mgr._journal_append("replica_dead", name=name,
                                    reason="identity mismatch")
                continue
            if hasattr(srv, "configure_wire"):
                # announcing the successor's epoch HERE is what fences
                # the predecessor out of this replica
                srv.configure_wire(
                    heartbeat_timeout=mgr.heartbeat_timeout,
                    retry_policy=mgr._retry, counters=mgr.metrics,
                    epoch=mgr.epoch or None)
            with mgr._lock:
                rec = _Replica(name, srv, next(mgr._seq))
                mgr._replicas[name] = rec
            mgr.metrics.count("replicas_adopted")
            mgr._journal_append(
                "adopt", name=name, seq=rec.seq,
                host=ident.get("host"), port=ident.get("port"),
                pid=pid if pid is not None else ident.get("pid"),
                start_time=st if st is not None
                else ident.get("start_time"))
            log.info("replica %s re-adopted (epoch %d)", name,
                     mgr.epoch)
        can = intent["canary"]
        if can is not None:
            # mid-probation death: the canary alone holds params no
            # gate ever vetted — deterministic rollback by crash (the
            # backfill below rebuilds on known-good factory params)
            mgr.metrics.count("canary_rollbacks")
            mgr._journal_append("canary_rolled_back",
                                name=can.get("name"),
                                reason="manager died mid-probation")
            with mgr._lock:
                adopted_canary = can.get("name") in mgr._replicas
            if adopted_canary:
                mgr._crash(can["name"],
                           reason="canary rollback at recovery",
                           convict=False)
        if intent["params_version"] and params_lm is not None:
            mgr._params = (params_lm.aux, params_lm.blocks)
        if backfill:
            # BOUNDED: spawns that succeed but die before the next
            # n_alive() read (an infant-death factory) must not loop
            # this path forever — cap at min_replicas + K attempts,
            # respect the (possibly inherited-open) breaker, and fall
            # through to degraded mode with a warning
            for _ in range(mgr.min_replicas + mgr.breaker_strikes):
                if mgr.n_alive() >= mgr.min_replicas:
                    break
                if not mgr._spawn_allowed():
                    break
                mgr._spawn_guarded()
            if mgr.n_alive() < mgr.min_replicas:
                log.warning(
                    "recovery backfill stopped at %d/%d alive "
                    "replicas (breaker %s): degraded mode",
                    mgr.n_alive(), mgr.min_replicas, mgr._breaker)
        if control_interval_s is not None:
            mgr.start(control_interval_s=control_interval_s)
        return mgr

    # -- introspection -------------------------------------------------
    def n_alive(self):
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.state in (HEALTHY, DEGRADED))

    @property
    def replicas(self):
        """Alive replica names, spawn order."""
        with self._lock:
            return [r.name for r in self._replicas.values()
                    if r.state in (HEALTHY, DEGRADED)]

    def states(self):
        """name -> health state, every replica ever (tombstones DEAD)."""
        with self._lock:
            out = {r.name: r.state for r in self._replicas.values()}
            for name in self._tombstones:
                out.setdefault(name, DEAD)
            return out

    def replica(self, name):
        """The live server object (ops/test hook)."""
        with self._lock:
            return self._replicas[name].server

    # -- client API ----------------------------------------------------
    def submit(self, prompt, max_new_tokens, deadline_ms=None,
               klass="default"):
        """Enqueue one decode request on the best alive replica;
        returns the MANAGER's future — it survives replica death,
        drains, and rollouts (the inner replica future is an
        implementation detail). Synchronous sheds at the chosen replica
        propagate (a shed at one replica is a fleet shed — the caller
        owns retry policy for overload, the manager only owns
        failover)."""
        if not self._running:
            raise ServerClosedError("fleet manager is not running")
        if self._injector is not None:
            self._injector.fire("fleet.submit")
        fp = _fingerprint(prompt, self._params_version)
        with self._lock:
            quarantined = fp in self._quarantine
        if quarantined:
            # a re-submission of a convicted poison pill: shed at the
            # door — it must never reach (and kill) another replica
            self.metrics.count("requests_quarantined")
            raise PoisonPillError(
                f"prompt fingerprint {fp[:12]} is quarantined "
                f"(implicated in >= {_QUARANTINE_DEATHS} replica "
                f"deaths)")
        if self._breaker != BREAKER_CLOSED and \
                self._brownout is not None:
            # degraded mode: the breaker says capacity cannot be
            # rebuilt right now, so the brownout seam sheds the lowest
            # classes first — pressure is the missing-capacity
            # fraction, standing in for the queue fraction the
            # per-server policy uses
            pressure = max(0.0, 1.0 - self.n_alive()
                           / max(1, self.min_replicas))
            if self._brownout.decide(klass, pressure) == BROWNOUT_SHED:
                self.metrics.count("shed_brownout")
                raise ServerOverloadedError(
                    f"degraded mode (spawn breaker {self._breaker}): "
                    f"class {klass!r} shed by fleet brownout")
        now = time.monotonic()
        deadline = (now + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        req = _FleetRequest(prompt, max_new_tokens, deadline, klass,
                            fp=fp)
        self.metrics.count("received")
        self._dispatch(req)         # sheds raise out of submit here
        return req.outer

    def generate(self, prompt, max_new_tokens, deadline_ms=None,
                 timeout=None):
        """Blocking convenience wrapper over submit()."""
        return self.submit(prompt, max_new_tokens,
                           deadline_ms=deadline_ms).result(timeout)

    # -- routing -------------------------------------------------------
    def _affinity_key(self, prompt):
        """The request's routing identity: its leading
        `affinity_blocks` x `affinity_block` tokens, floored to a
        block boundary (the paged pool shares whole blocks, so only
        whole blocks are placement-worthy). A prompt shorter than one
        block is its own key — short prompts still route stably."""
        bs = self.affinity_block
        n = min(len(prompt), self.affinity_blocks * bs)
        if n >= bs:
            n -= n % bs
        return tuple(int(t) for t in prompt[:n])

    def _pick(self, tried=(), key=None):
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.state in (HEALTHY, DEGRADED)
                     and r.name not in tried and r.server.alive]
            if not cands:
                return None
            if self._policy == "round_robin":
                rec = cands[self._rr % len(cands)]
                self._rr += 1
                return rec
            least = min(cands, key=lambda r: (r.state != HEALTHY,
                                              r.inflight, r.seq))
            if self._policy == "affinity" and key is not None:
                home = self._pick_affine(cands, tried, key)
                if home is None or home is least:
                    # the affine replica IS the least-backlog one (or
                    # the ring routed around every candidate): sticky
                    # and cheap at once
                    self.metrics.count("routed_affinity")
                    return home if home is not None else least
                floor = min(r.inflight for r in cands)
                if home.inflight > self.spill_factor * floor \
                        + self.spill_slack:
                    # load-aware spill: stickiness is a goodput
                    # preference, never a hotspot — fall to the
                    # least-backlog survivor and count it
                    self.metrics.count("routed_spill")
                    return least
                self.metrics.count("routed_affinity")
                return home
            # least backlog; healthy beats degraded; spawn order ties
            return least

    def _pick_affine(self, cands, tried, key):
        """Ring owner of `key` among routable candidates (callers hold
        `self._lock`). The ring is (re)built only when the ALIVE
        roster changes — its stability across unrelated churn is the
        point (~1/N keys remap per replica added/removed)."""
        names = tuple(r.name for r in self._replicas.values()
                      if r.state in (HEALTHY, DEGRADED)
                      and r.server.alive)
        if names != self._ring_names:
            self._ring = _build_ring(names)
            self._ring_names = names
        routable = {r.name for r in cands}
        owner = _ring_lookup(
            self._ring, _ring_hash(key),
            exclude=frozenset(tried) | (set(names) - routable))
        if owner is None:
            return None
        return self._replicas.get(owner)

    def _dispatch(self, req):
        """Route `req` to a replica. Raises on request-level sheds and
        on a fleet with no routable replica; replica death between
        choice and submit retries the next survivor."""
        tried = set()
        last = None
        if self._policy == "affinity" and req.akey is None:
            req.akey = self._affinity_key(req.prompt)
        while True:
            rec = self._pick(tried, key=req.akey)
            if rec is None:
                raise last if last is not None else ReplicaDeadError(
                    "no alive replicas to route to")
            dl_ms = None
            if req.deadline is not None:
                left = (req.deadline - time.monotonic()) * 1e3
                if left <= 0:
                    raise DeadlineExceededError(
                        "deadline expired before the fleet could "
                        "place the request")
                dl_ms = left
            try:
                inner = rec.server.submit(req.prompt, req.max_new,
                                          deadline_ms=dl_ms,
                                          klass=req.klass)
            except (ServerClosedError, ReplicaDeadError) as e:
                # died between choice and submit: fail it loudly, move on
                self._crash(rec.name, reason=str(e))
                tried.add(rec.name)
                last = e
                continue
            self._register(rec, req, inner)
            if self._policy == "affinity" and req.akey:
                self._maybe_pull(rec, req.akey)
            if self._kill_hook is not None:
                # the poison chaos seam: a truthy hook verdict models
                # a decode that deterministically kills its replica —
                # the crash sweep below fails this request over (or
                # quarantines it on its second kill)
                try:
                    poisoned = bool(self._kill_hook(req.prompt,
                                                    rec.name))
                except Exception:   # noqa: BLE001 — chaos stays chaos
                    log.exception("kill hook raised; ignoring")
                    poisoned = False
                if poisoned:
                    self._crash(rec.name,
                                reason="poison decode killed replica")
            return

    def _register(self, rec, req, inner):
        with self._lock:
            req.replica = rec.name
            self._live[inner] = req
            rec.inflight += 1
        inner.add_done_callback(self._on_inner_done)

    # -- fleet prefix tier ---------------------------------------------
    def _maybe_pull(self, rec, key):
        """Schedule an async prefix pull for `key` into `rec` when the
        manager believes `rec` is cold on it and a peer is warm —
        spilled/remapped traffic adopts the peer's blocks instead of
        recomputing them. OFF the dispatch hot path: this method only
        consults host-side sets and (at most) starts a daemon thread —
        the no-pull affinity path stays at ZERO added device
        dispatches per token (the fleet A/B pin)."""
        with self._lock:
            if key in rec.keys_seen:
                rec.keys_seen.move_to_end(key)  # LRU touch
                return
            src = None
            if self.prefix_pull and self._pull_budget_left > 0 \
                    and (rec.name, key) not in self._pulls_inflight:
                src = self._pull_source(rec, key)
            # believed warm from here on: the request just routed here
            # will prefill (or adopt) the chain itself
            rec.keys_seen[key] = True
            while len(rec.keys_seen) > self._keys_seen_cap:
                rec.keys_seen.popitem(last=False)
            if src is None:
                return
            self._pulls_inflight.add((rec.name, key))
            budget = self._pull_budget_left
        t = threading.Thread(target=self._do_pull,
                             args=(src, rec.name, key, budget),
                             daemon=True, name=f"prefix-pull-{rec.name}")
        t.start()

    def _pull_source(self, rec, key):
        """Locked helper: the first alive peer the manager believes
        warm on `key` that speaks the pull protocol, or None."""
        for peer in self._replicas.values():
            if peer is not rec and key in peer.keys_seen \
                    and peer.state in (HEALTHY, DEGRADED) \
                    and peer.server.alive \
                    and getattr(peer.server, "prefix_export",
                                None) is not None:
                return peer.name
        return None

    def prefetch(self, prompt):
        """Synchronously re-warm `prompt`'s affinity key on its
        current ring owner by pulling a warm peer's resident blocks —
        the scale-up companion: after the ring remaps keys onto a
        freshly spawned replica, prefetch moves the cached prefix
        there AHEAD of traffic. (The dispatch-time pull exists too,
        but it races the triggering request's own prefill and concedes
        when local compute wins — correct either way; prefetch is for
        warming before the traffic arrives.) Spends the same fleet
        pull budget and counts through the same `prefix_pull_*`
        counters. Returns blocks adopted (0 when the owner is already
        believed warm, no warm peer exists, the budget is spent, or
        the pull was refused — refusals count at the adopting
        replica)."""
        key = self._affinity_key(tuple(int(t) for t in prompt))
        if not key:
            return 0
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.state in (HEALTHY, DEGRADED)
                     and r.server.alive]
            if not cands:
                return 0
            dst = self._pick_affine(cands, (), key)
            if dst is None or key in dst.keys_seen:
                return 0
            if not self.prefix_pull or self._pull_budget_left <= 0 \
                    or (dst.name, key) in self._pulls_inflight:
                return 0
            src = self._pull_source(dst, key)
            if src is None:
                return 0
            dst.keys_seen[key] = True
            while len(dst.keys_seen) > self._keys_seen_cap:
                dst.keys_seen.popitem(last=False)
            self._pulls_inflight.add((dst.name, key))
            budget = self._pull_budget_left
        return self._do_pull(src, dst.name, key, budget)

    def _do_pull(self, src_name, dst_name, key, budget):
        """One pull, source -> destination, on its own daemon thread
        (both ends service it at their serve loops' iteration
        boundaries under their own bytes budgets). Failures are
        logged, never raised: the tier is an optimization — the worst
        outcome of a failed pull is the cold compute that would have
        happened anyway. Version refusals are counted by the ADOPTING
        replica (`prefix_pull_refused`), where the tag check runs.
        Returns blocks adopted (0 on any miss/refusal/failure)."""
        try:
            with self._lock:
                src = self._replicas.get(src_name)
                dst = self._replicas.get(dst_name)
            if src is None or dst is None or not src.server.alive \
                    or not dst.server.alive:
                return 0
            art = src.server.prefix_export(key, max_bytes=budget)
            if art is None:
                return 0
            adopt = getattr(dst.server, "prefix_adopt", None)
            if adopt is None:
                return 0
            n = adopt(art)
            with self._lock:
                self._pull_budget_left = max(
                    0, self._pull_budget_left - art.nbytes)
            return int(n or 0)
        except KVStateVersionError:
            return 0    # refusal counted at the adopting replica;
            #             the request decodes cold — correct, just slower
        except Exception:   # noqa: BLE001 — the tier must never raise
            log.debug("prefix pull %s -> %s failed", src_name,
                      dst_name, exc_info=True)
            return 0
        finally:
            with self._lock:
                self._pulls_inflight.discard((dst_name, key))

    def _on_inner_done(self, fut):
        with self._lock:
            req = self._live.pop(fut, None)
            if req is not None:
                rec = self._replicas.get(req.replica)
                if rec is not None:
                    rec.inflight = max(0, rec.inflight - 1)
        if req is None:
            return      # handed off (drain) or already accounted
        if fut.cancelled():
            req.outer.cancel()
            return
        # ONE classification table (_settle_handoff) for this live
        # path and the drain/crash handoff paths: result or a
        # request-level PROPAGATE verdict settles the outer future;
        # anything else is infrastructure — failover
        if not self._settle_handoff(fut, req):
            self._failover(req, fut.exception())

    def _failover(self, req, exc, blame=True):
        """Resubmit a request whose replica failed underneath it:
        prompt replay on a survivor (deterministic greedy decode ==
        the uninterrupted stream), bounded by the retry policy; out of
        budget / out of survivors / stopped manager fails the outer
        future LOUDLY with the original error. Before replaying, two
        containment gates: a request aboard its second distinct
        SPONTANEOUS replica death is the probable KILLER — quarantined,
        never replayed (`blame=False` excludes operator-initiated
        kills: the operator chose that victim, the request did not) —
        and a replay the fleet-wide retry budget refuses fails loudly
        instead of amplifying load."""
        if blame and isinstance(exc, ReplicaDeadError) \
                and req.replica is not None:
            req.deaths.add(req.replica)
            if len(req.deaths) >= _QUARANTINE_DEATHS:
                self._quarantine_req(req, exc)
                return
        req.attempts += 1
        if not self._running or req.attempts > self._retry.max_retries:
            if _fail_future(req.outer, exc):
                self.metrics.count("failed")
            return
        if not self._retry.grant_retry():
            self.metrics.count("retry_budget_exhausted")
            if _fail_future(req.outer, RetryBudgetExhaustedError(
                    f"fleet retry budget exhausted; not replaying "
                    f"after {type(exc).__name__}: {exc}")):
                self.metrics.count("failed")
            return
        d = self._retry.delay(req.attempts - 1)
        if d:
            # NEVER sleep here: this runs inside the inner future's
            # done-callback — on the dying replica's serve/kill
            # thread, where stacked backoffs would serially delay
            # every other victim's failure delivery (and kill()'s
            # join). A daemon timer pays the backoff off-thread.
            t = threading.Timer(
                d, self._resubmit,
                kwargs={"count_failover": True, "cause": exc},
                args=(req,))
            t.daemon = True
            t.start()
            return
        self._resubmit(req, count_failover=True, cause=exc)

    def _settle_handoff(self, fut, req):
        """THE verdict table, shared by the live done-callback and the
        drain/crash handoff paths: a resolved inner future's result —
        or its request-level PROPAGATE verdict (a deadline/overload/
        screen verdict must never be silently retried into success) —
        settles the outer future here. Returns True when settled
        (False: unresolved or an infrastructure error — the caller
        fails over / resubmits)."""
        if not fut.done() or fut.cancelled():
            return False
        exc = fut.exception()
        if exc is None:
            if _resolve_future(req.outer, fut.result()):
                self.metrics.count("completed")
                budget = self._retry.budget
                if budget is not None:
                    # successes are what pay for retries (SRE retry-
                    # budget discipline): refill a fraction per
                    # completion
                    budget.on_success()
            return True
        if isinstance(exc, self._PROPAGATE):
            if _fail_future(req.outer, exc):
                self.metrics.count("failed")
            return True
        return False

    def _quarantine_req(self, req, exc):
        """Convict one in-flight request as the poison pill: journal
        the fingerprint (a recovered manager keeps shedding it), add
        it to the bounded quarantine set, and fail the outer future
        with the typed verdict — this request is NEVER replayed."""
        fp = req.fp or _fingerprint(req.prompt, self._params_version)
        with self._lock:
            self._quarantine[fp] = True
            while len(self._quarantine) > self._quarantine_cap:
                self._quarantine.popitem(last=False)
        self.metrics.count("requests_quarantined")
        self._journal_append("quarantine", fingerprint=fp,
                             deaths=sorted(req.deaths))
        log.warning("request quarantined after %d replica deaths "
                    "(%s): fingerprint %s", len(req.deaths),
                    ", ".join(sorted(req.deaths)), fp[:12])
        if _fail_future(req.outer, PoisonPillError(
                f"request aboard {len(req.deaths)} replica deaths "
                f"({', '.join(sorted(req.deaths))}); fingerprint "
                f"{fp[:12]} quarantined")):
            self.metrics.count("failed")

    def _resubmit(self, req, count_failover=False, cause=None):
        if req.deadline is not None and \
                time.monotonic() > req.deadline:
            if _fail_future(req.outer, DeadlineExceededError(
                    "deadline expired during failover")):
                self.metrics.count("failed")
            return
        try:
            self._dispatch(req)
        except BaseException as e:  # noqa: BLE001 — outer carries it
            if _fail_future(req.outer, e):
                self.metrics.count("failed")
            return
        if count_failover:
            self.metrics.count("failover_resubmitted")
            log.warning("request replayed on %s after %s: %s",
                        req.replica, type(cause).__name__, cause)

    # -- replica lifecycle ---------------------------------------------
    def _mint_name(self):
        """Fleet-unique instance id: NEVER reused, even after the
        replica dies — a freshly spawned replica must not alias a dead
        one's metrics series, trace process group, or request-id
        namespace (the federation-under-churn pin)."""
        return f"{self._name_prefix}{next(self._name_ids)}"

    def _spawn(self):
        if not self._running:
            # a control tick racing stop() must not start a replica
            # nobody will ever stop (stop()'s final sweep catches the
            # narrower in-flight-spawn window)
            raise ServerClosedError("fleet manager is not running")
        name = self._mint_name()
        srv = self._factory(name)
        if not srv._running:
            srv.start()
        if hasattr(srv, "configure_wire"):
            # a REMOTE replica (serving/wire.py): bind the manager's
            # wire config — its metrics as the wire-counter sink
            # (wire_reconnects/wire_retries land on the fleet
            # control-plane snapshot), its retry policy, its
            # heartbeat-timeout reap threshold, and (when journaling)
            # this generation's epoch for stale-manager fencing
            srv.configure_wire(heartbeat_timeout=self.heartbeat_timeout,
                               retry_policy=self._retry,
                               counters=self.metrics,
                               epoch=self.epoch or None)
        if self._params is not None:
            try:
                same = srv.current_params()[0] is self._params[0]
            except NotImplementedError:
                same = False    # remote: no params pull — always ship
            if not same:
                # the factory builds the ORIGINAL params; a rolled-
                # forward fleet hands every new replica the current ones
                srv.swap(_ParamsView(*self._params))
        if self._warmup is not None:
            self._warmup(srv)
        with self._lock:
            orphaned = not self._running
            if not orphaned:
                rec = _Replica(name, srv, next(self._seq),
                               born=time.monotonic())
                self._replicas[name] = rec
                if self._breaker == BREAKER_HALF_OPEN \
                        and self._probe_name is None:
                    # this spawn IS the half-open probe: the breaker
                    # closes only if it survives infant_mortality_s
                    self._probe_name = name
        if orphaned:
            # stop() raced the slow factory/warmup above and its sweep
            # never saw this name: tear the orphan down HERE (outside
            # the lock — stop joins the serve thread) instead of
            # leaking a started serve thread nobody owns
            srv.stop(drain=False, timeout=10.0)
            raise ServerClosedError("fleet manager stopped during spawn")
        self.metrics.count("replica_spawned")
        # wire identity rides the spawn record (remote replicas carry
        # host/port/pid/start_time off their HELLO; in-process ones
        # journal None — recovery re-adopts only what it can re-dial)
        self._journal_append(
            "spawn", name=name, seq=rec.seq,
            host=getattr(srv, "_host", None),
            port=getattr(srv, "_port", None),
            pid=getattr(srv, "pid", None),
            start_time=getattr(srv, "start_time", None))
        log.info("replica %s spawned (%d alive)", name, self.n_alive())
        return name

    # -- spawn circuit breaker -----------------------------------------
    @property
    def breaker_state(self):
        """closed / open / half_open (the `breaker_state` gauge is the
        numeric twin: 0 / 1 / 0.5)."""
        with self._lock:
            return self._breaker

    def _breaker_strike(self, name=None):
        """One spawn-path strike: a factory/warmup raise or an infant
        death. K consecutive strikes OPEN the breaker; a failed
        half-open probe re-opens it with DOUBLED backoff."""
        now = time.monotonic()
        opened = False
        with self._lock:
            self._strikes += 1
            self._last_strike = now
            if self._breaker == BREAKER_HALF_OPEN and \
                    (name is None or name == self._probe_name
                     or self._probe_name is None):
                self._breaker = BREAKER_OPEN
                self._probe_name = None
                self._breaker_backoff = min(
                    self._breaker_max_backoff,
                    self._breaker_backoff * 2.0)
                self._breaker_until = now + self._breaker_backoff
                opened = True
            elif self._breaker == BREAKER_CLOSED and \
                    self._strikes >= self.breaker_strikes:
                self._breaker = BREAKER_OPEN
                self._breaker_until = now + self._breaker_backoff
                opened = True
            backoff = self._breaker_backoff
            strikes = self._strikes
        if opened:
            self.metrics.count("breaker_open_total")
            self.metrics.record_breaker_state(
                _BREAKER_GAUGE[BREAKER_OPEN])
            self._journal_append("breaker", state=BREAKER_OPEN,
                                 strikes=strikes, backoff_s=backoff)
            log.warning("spawn circuit breaker OPEN after %d strikes "
                        "(next probe in %.2fs); fleet degraded",
                        strikes, backoff)

    def _spawn_allowed(self):
        """The breaker gate every backfill/autoscale spawn passes:
        True while CLOSED; while OPEN, True exactly once per elapsed
        backoff window (that spawn becomes the half-open probe); False
        while a probe is pending or the backoff hasn't elapsed."""
        probing = False
        with self._lock:
            if self._breaker == BREAKER_CLOSED:
                return True
            if self._breaker == BREAKER_OPEN and \
                    time.monotonic() >= self._breaker_until:
                self._breaker = BREAKER_HALF_OPEN
                probing = True
        if probing:
            self.metrics.record_breaker_state(
                _BREAKER_GAUGE[BREAKER_HALF_OPEN])
            log.info("spawn breaker half-open: probing with one spawn")
            return True
        return False

    def _spawn_guarded(self):
        """Backfill/probe spawn with strike accounting: a raising
        factory (the spawn_fail chaos action) is a breaker STRIKE, not
        an unhandled control-loop error. Returns the name, or None on
        a strike. A stopping manager's refusal propagates — that is
        lifecycle, not a spawn-path failure."""
        try:
            return self._spawn()
        except ServerClosedError:
            raise
        except Exception:   # noqa: BLE001 — the strike IS the handling
            log.exception("spawn failed (breaker strike)")
            self._breaker_strike()
            return None

    def _breaker_probe_check(self):
        """Per-tick breaker bookkeeping: close the breaker when the
        half-open probe replica survives `infant_mortality_s`, and
        while CLOSED, reset the strike counter when any spawn born
        AFTER the last strike survives infancy (strikes are
        CONSECUTIVE spawn failures, not lifetime ones)."""
        closed = False
        now = time.monotonic()
        with self._lock:
            if self._breaker == BREAKER_HALF_OPEN and self._probe_name:
                rec = self._replicas.get(self._probe_name)
                if rec is not None \
                        and rec.state in (HEALTHY, DEGRADED) \
                        and rec.server.alive \
                        and rec.born is not None \
                        and now - rec.born >= self.infant_mortality_s:
                    self._breaker = BREAKER_CLOSED
                    self._strikes = 0
                    self._probe_name = None
                    self._breaker_backoff = self._breaker_backoff0
                    closed = True
            elif self._breaker == BREAKER_CLOSED and self._strikes:
                for rec in self._replicas.values():
                    if rec.born is not None \
                            and rec.born > self._last_strike \
                            and rec.state in (HEALTHY, DEGRADED) \
                            and now - rec.born \
                            >= self.infant_mortality_s:
                        self._strikes = 0
                        break
        if closed:
            self.metrics.record_breaker_state(
                _BREAKER_GAUGE[BREAKER_CLOSED])
            self._journal_append("breaker", state=BREAKER_CLOSED,
                                 strikes=0,
                                 backoff_s=self._breaker_backoff0)
            log.info("spawn circuit breaker CLOSED: probe survived "
                     "infancy")

    def _tombstone_counters(self, rec):
        """Counters-only snapshot of a departing replica: federated
        counters stay MONOTONE after the instance stops existing,
        while its stale gauges/summaries (capacity, occupancy) drop
        out of the live read-outs the detector consumes. FETCH-ONLY —
        and always called OUTSIDE `self._lock`: a REMOTE replica's
        `kind_snapshot()` is a wire round-trip (serving/wire.py
        `_fetch_snapshot`, seconds on a wedged wire), and holding the
        manager lock through it would stall every router/probe/
        federation path on one dead replica's socket (the graftlint
        lock-discipline finding this split fixed)."""
        try:
            snap = rec.server.metrics.kind_snapshot()
        except Exception:           # noqa: BLE001 — dead is dead
            snap = {}
        return {k: v for k, v in snap.items()
                if v.get("kind") == "counter"}

    def _install_tombstone(self, rec, counters):
        """Write half of the tombstone (the `_tombstones` map is only
        ever touched under the lock — a reader iterating it must
        never race a bare-dict write from a crash path)."""
        with self._lock:
            self._tombstones[rec.name] = counters

    def _crash(self, name, reason="injected fault", convict=True):
        """Replica death: fail it loudly, tombstone its counters, and
        resubmit its in-flight requests to survivors via prompt
        replay. Idempotent. `convict=False` marks an ADMINISTRATIVE
        death (operator kill, canary rollback): requests aboard it do
        not accrue a poison-pill strike — only spontaneous deaths are
        evidence a request's own decode is the killer."""
        with self._lock:
            rec = self._replicas.get(name)
        if rec is None:
            return
        # counters fetched BEFORE the removal and OUTSIDE the lock:
        # the replica stays visible in `_replicas` while the (possibly
        # wire-crossing) snapshot runs, so a concurrent fleet_view()
        # still federates it live — never in neither map, which would
        # read as every counter dipping by its whole history (a fake
        # counter reset to the detector)
        counters = self._tombstone_counters(rec)
        with self._lock:
            if self._replicas.get(name) is not rec:
                return              # raced another crash/drain
            del self._replicas[name]
            # tombstone installed in the SAME critical section as the
            # removal: no reader window between the two maps
            self._tombstones[name] = counters
            doomed = []
            for fut, req in list(self._live.items()):
                if req.replica == name:
                    del self._live[fut]
                    doomed.append((fut, req))
        rec.state = DEAD
        self.metrics.count("replica_dead")
        self._journal_append("replica_dead", name=name, reason=reason)
        if convict and rec.born is not None and \
                time.monotonic() - rec.born < self.infant_mortality_s:
            # died within infancy of its own spawn: a spawn-path
            # failure (bad factory/params/config), not a serving one —
            # strike the breaker. Administrative kills don't strike:
            # an operator putting down a young replica says nothing
            # about the factory
            self.metrics.count("infant_deaths")
            self._breaker_strike(name)
        rec.server.kill()           # fails remaining futures loudly
        # refresh with the final post-kill values (counters only grow
        # — and a remote's snapshot falls back to its last good cache
        # — so the refresh keeps monotonicity)
        self._install_tombstone(rec, self._tombstone_counters(rec))
        log.warning("replica %s dead (%s); %d in-flight requests "
                    "failing over", name, reason, len(doomed))
        for fut, req in doomed:
            if self._settle_handoff(fut, req):
                # finished (or reached a PROPAGATE verdict) just
                # before the crash landed: deliver THAT outcome
                continue
            # ONE failover implementation (budget, accounting, pacing)
            # for both arrival paths — here and the done-callback
            self._failover(req,
                           ReplicaDeadError(f"replica {name} died"),
                           blame=convict)

    def kill_replica(self, name):
        """Operator/chaos verb: crash `name` now (the same path the
        fleet.replica sever action takes). An operator kill is
        administrative — requests aboard it fail over without accruing
        a poison-pill strike."""
        self._crash(name, reason="killed by operator", convict=False)

    def scale_up(self):
        """Spawn one replica (the scale_up actuation; also the
        min_replicas backfill). Returns the new name."""
        return self._spawn()

    def scale_down(self, name=None, timeout=60.0):
        """Gracefully remove one replica: drain(migrate) its live
        decode-phase requests onto survivors (bit-identical resumed
        streams), replay its queued/prefilling requests, stop it.
        Default victim: fewest in-flight requests, newest spawn on
        ties (symmetric with scale_up). Refuses to go below ONE alive
        replica — the autoscale caller enforces min_replicas; this
        verb only keeps the fleet routable."""
        with self._lock:
            alive = [r for r in self._replicas.values()
                     if r.state in (HEALTHY, DEGRADED)]
            if len(alive) <= 1:
                raise ValueError("refusing to drain the last alive "
                                 "replica")
            if name is None:
                rec = min(alive, key=lambda r: (r.inflight, -r.seq))
            else:
                rec = self._replicas[name]
                if rec.state not in (HEALTHY, DEGRADED):
                    raise ValueError(f"replica {name} is {rec.state}")
            rec.state = DRAINING
            handoff = {}
            for fut, req in list(self._live.items()):
                if req.replica == rec.name:
                    del self._live[fut]
                    handoff[fut] = req
            rec.inflight = 0
        # intent BEFORE action (WAL discipline): a successor must know
        # this replica was being emptied — a drain_begin without its
        # replica_drained marks the replica non-re-adoptable
        self._journal_append("drain_begin", name=rec.name)
        try:
            migrated, replayed = rec.server.drain(timeout=timeout)
        except BaseException as e:  # noqa: BLE001 — degrade to crash
            log.exception("drain of %s failed; treating as crash",
                          rec.name)
            # fetch outside the lock, install atomically with the
            # removal (the _crash rule — see _tombstone_counters); a
            # concurrent _crash that already removed + killed this
            # replica OWNS the tombstone: overwriting its final
            # post-kill counters with this path's (possibly stale)
            # fetch would read as a counter dip to the detector
            counters = self._tombstone_counters(rec)
            with self._lock:
                raced = self._replicas.get(rec.name) is not rec
                if not raced:
                    del self._replicas[rec.name]
                    self._tombstones[rec.name] = counters
            rec.state = DEAD
            if not raced:
                self.metrics.count("replica_dead")
                self._journal_append("replica_dead", name=rec.name,
                                     reason="drain failed")
                rec.server.kill()
                self._install_tombstone(    # refresh: final values
                    rec, self._tombstone_counters(rec))
            for fut, req in handoff.items():
                # same settle-first rule as every handoff path: a
                # result or PROPAGATE verdict that landed before the
                # drain wedged must not be replayed
                if not self._settle_handoff(fut, req):
                    self._resubmit(req, count_failover=True, cause=e)
            return rec.name
        for fut, art in migrated:
            req = handoff.pop(fut, None)
            if req is not None:
                self._repoint_migrated(req, art)
        for fut, spec in replayed:
            req = handoff.pop(fut, None)
            if req is not None:
                self._resubmit(req)
        for fut, req in handoff.items():
            # completed — or already holding a PROPAGATE verdict —
            # before the drain swept it: deliver that outcome; only
            # infrastructure leftovers replay
            if not self._settle_handoff(fut, req):
                self._resubmit(req)
        # the drained replica is stopped: its snapshot is a local (or
        # stale-cached) read, but the fetch still runs outside the
        # lock — the _crash rule, uniformly; and like the crash-
        # degrade path above, a _crash that raced the drain already
        # owns the removal AND the (newer, post-kill) tombstone
        counters = self._tombstone_counters(rec)
        with self._lock:
            if self._replicas.get(rec.name) is rec:
                del self._replicas[rec.name]
                self._tombstones[rec.name] = counters
        rec.state = DEAD
        self.metrics.count("replica_drained")
        self._journal_append("replica_drained", name=rec.name)
        log.info("replica %s drained (%d migrated, %d replayed; %d "
                 "alive)", rec.name, len(migrated), len(replayed),
                 self.n_alive())
        return rec.name

    def _repoint_migrated(self, req, art):
        """Land a drained request's artifact on a survivor
        (`migrate_in` — the resumed stream is bit-identical); a
        version/layout refusal or an overloaded survivor degrades to
        prompt replay (correct bits either way — replay just pays the
        prompt compute again)."""
        dl_ms = None
        if req.deadline is not None:
            left = (req.deadline - time.monotonic()) * 1e3
            if left <= 0:
                if _fail_future(req.outer, DeadlineExceededError(
                        "deadline expired during drain migration")):
                    self.metrics.count("failed")
                return
            dl_ms = left
        tried = set()
        while True:
            rec = self._pick(tried)
            if rec is None or not rec.server.paged:
                self._resubmit(req)     # no migratable destination
                return
            try:
                inner = rec.server.migrate_in(art, deadline_ms=dl_ms)
            except (KVStateError, ValueError):
                # tag/layout mismatch (mid-rollout fleet) — the
                # destination REFUSED the migration: degrade to prompt
                # replay (correct bits either way), counted so a fleet
                # silently paying replay compute is visible
                self.metrics.count("migrate_refused")
                self._resubmit(req)
                return
            except ServerOverloadedError:
                self.metrics.count("migrate_refused")
                tried.add(rec.name)
                continue
            except (ServerClosedError, ReplicaDeadError) as e:
                self._crash(rec.name, reason=str(e))
                tried.add(rec.name)
                continue
            self._register(rec, req, inner)
            return

    # -- health + the closed autoscale loop ----------------------------
    def _probe_health(self):
        """Per-replica state machine: DEAD when the serve thread is
        gone (crash path — in-flight work fails over); DEGRADED while
        the replica's own shed rate (per tick, all causes) or failure
        counter is moving; back to HEALTHY on a quiet tick. Degraded
        replicas still serve (least-backlog prefers healthy ones) —
        the state is the canary gate's and the imbalance report's
        signal, not a kill switch."""
        with self._lock:
            recs = [r for r in self._replicas.values()
                    if r.state in (HEALTHY, DEGRADED)]
        for rec in recs:
            if not rec.server.alive:
                self._crash(rec.name, reason="serve thread died")
                continue
            m = rec.server.metrics
            sheds = sum(m.count_value(k) for k in SHED_KEYS)
            failed = m.count_value("failed")
            d_shed = sheds - rec.probe_sheds
            d_fail = failed - rec.probe_failed
            rec.probe_sheds, rec.probe_failed = sheds, failed
            if d_fail > 0 or d_shed >= self.degrade_shed_rate:
                if rec.state == HEALTHY:
                    rec.state = DEGRADED
                    self.metrics.count("replica_degraded")
            elif rec.state == DEGRADED:
                rec.state = HEALTHY

    def fleet_view(self):
        """FleetView over every ALIVE replica's kind_snapshot plus the
        counters-only tombstones of dead/drained ones (federated
        counters stay monotone across churn; stale gauges don't haunt
        the detector)."""
        fv = FleetView(signal=self.signal)
        with self._lock:
            recs = [r for r in self._replicas.values()
                    if r.state in (HEALTHY, DEGRADED, DRAINING)]
            tombs = list(self._tombstones.items())
        for rec in recs:
            fv.add(rec.name, rec.server.metrics)
        for name, snap in tombs:
            fv.add(name, snap)
        return fv

    def fleet_snapshot(self):
        """The federated snapshot with the manager's own control-plane
        counters overlaid (`fleet_replica_spawned`, ... — the manager
        is the one counting its own verbs)."""
        snap = self.fleet_view().snapshot()
        # fenced_ops stays FEDERATED: the replica hosting the fence is
        # the one counting refusals — a successor manager overlaying
        # its own (necessarily zero) count would erase the very events
        # the fence pin reads
        for key in ("replica_spawned", "replica_drained", "replica_dead",
                    "failover_resubmitted", "canary_rollbacks",
                    "wire_reconnects", "wire_retries",
                    "migrate_refused", "manager_epoch",
                    "replicas_adopted", "journal_records",
                    "requests_quarantined", "breaker_open_total",
                    "retry_budget_exhausted", "degraded_mode_ticks",
                    "infant_deaths", "routed_affinity", "routed_spill"):
            snap["fleet_" + key] = self.metrics.count_value(key)
        # prefix_pull_* stay FEDERATED (like fenced_ops): the ADOPTING
        # replica counts hits/bytes/refusals — the manager only
        # schedules pulls, it never adopts
        # the breaker gauge overlays LIVE manager state (a gauge, not a
        # counter — federation can't sum it; the manager owns it)
        snap["fleet_breaker_state"] = _BREAKER_GAUGE[self._breaker]
        snap["fleet_alive"] = self.n_alive()
        return snap

    def _utilization(self, snap, now):
        """Delivered tokens/s over the tick window divided by the
        fleet capacity estimate — the scale_down occupancy input. The
        per-replica occupancy reservoirs are ITERATION-weighted and no
        iterations run at idle, so their mean never decays on a quiet
        fleet; utilization does."""
        toks = snap.get("fleet_tokens_out") or 0
        rate = snap.get("fleet_service_rate_tokens_per_sec")
        last, self._last_tick = self._last_tick, (now, toks)
        if last is None or not rate:
            return snap.get("fleet_occupancy_mean")
        dt = now - last[0]
        if dt <= 0:
            return snap.get("fleet_occupancy_mean")
        return min(1.0, max(0.0, (toks - last[1]) / dt / rate))

    def control_tick(self):
        """ONE observation/actuation window of the closed loop: fire
        the crash-injection site per replica, probe health, backfill
        to min_replicas, federate a snapshot, consult the signal, and
        ACT on its decision (scale_up spawns; scale_down drains with
        live-request migration). After an action the signal resets —
        the next move is argued from the new fleet's own observations.
        Returns the tick record the sweep logs."""
        self._ticks += 1
        if self._injector is not None:
            with self._lock:
                names = [r.name for r in self._replicas.values()
                         if r.state in (HEALTHY, DEGRADED)]
            for n in names:
                self._injector.fire(
                    "fleet.replica",
                    on_sever=lambda name=n: self._crash(name))
        self._probe_health()
        self._breaker_probe_check()
        backfilled = 0
        while self._running and self.n_alive() < self.min_replicas:
            if not self._spawn_allowed():
                # breaker open (or probe pending): DEGRADED mode — no
                # tick-rate spawn crash-loop; serve on what's alive
                break
            if self._spawn_guarded() is not None:
                backfilled += 1
        if self._breaker != BREAKER_CLOSED:
            self.metrics.count("degraded_mode_ticks")
        if self._journal is not None and \
                self._journal_compact_bytes is not None:
            try:
                if self._journal.size() > self._journal_compact_bytes:
                    self._journal.compact(name_prefix=self._name_prefix)
            except Exception:   # noqa: BLE001 — the WAL is not the fleet
                log.exception("journal compaction failed")
        now = time.monotonic()
        snap = self.fleet_snapshot()
        util = self._utilization(snap, now)
        decision = None
        acted = None
        if self.signal is not None:
            decision = self.signal.observe(snap, occupancy=util)
            if self._rolling:
                pass        # a rollout owns the fleet shape right now
            elif decision == AutoscaleSignal.SCALE_UP \
                    and self._running \
                    and self.n_alive() < self.max_replicas \
                    and self._spawn_allowed():
                if self._spawn_guarded() is not None:
                    acted = "scale_up"
                    self.signal.reset()
            elif decision == AutoscaleSignal.SCALE_DOWN \
                    and self._running \
                    and self.n_alive() > self.min_replicas:
                self.scale_down()
                acted = "scale_down"
                self.signal.reset()
            if acted is not None:
                # the roster change itself is already journaled by
                # _spawn/scale_down; this records WHY (the autoscale
                # decision history a post-mortem replays)
                self._journal_append("autoscale", action=acted,
                                     tick=self._ticks)
        return {"tick": self._ticks, "decision": decision,
                "acted": acted, "backfilled": backfilled,
                "breaker": self._breaker,
                "n_replicas": self.n_alive(),
                "replicas": self.replicas,
                "states": self.states(), "utilization": util,
                "fleet_shed_predicted": snap.get("fleet_shed_predicted"),
                "fleet_tokens_out": snap.get("fleet_tokens_out")}

    # -- health-gated canary rollout -----------------------------------
    def rollout(self, new_lm, watch_ticks=2, traffic=None,
                tick_s=0.25, min_attainment=0.5, max_failures=0,
                shed_ratio=2.0, shed_allowance=4):
        """Hot-swap `new_lm`'s params across the fleet behind a health
        gate (module docstring). The NaN/Inf screen runs BEFORE any
        replica takes the params — a poisoned checkpoint rolls back
        with zero requests ever served under it. Then ONE canary
        replica swaps and serves live traffic for `watch_ticks`
        probation windows (`traffic()` is called per window when
        given — drive load there; otherwise the window is `tick_s` of
        wall clock); the gate trips on new failures/unhealthy outputs,
        SLO attainment under `min_attainment`, or the canary shedding
        more than `shed_ratio` x the survivors' mean (+
        `shed_allowance`). Tripped -> the canary swaps BACK (in-flight
        requests drain dual-version, zero dropped) and
        `canary_rollbacks` counts. Passed -> every other replica swaps
        (replica by replica, each its own dual-version drain) and
        future spawns inherit the new params. Returns the verdict
        record."""
        if not self._running:
            raise ServerClosedError("fleet manager is not running")
        if not _params_finite(new_lm):
            self.metrics.count("canary_rollbacks")
            log.warning("rollout refused: new params failed the "
                        "rowwise_finite screen")
            return {"status": "rolled_back", "reason": "nan_screen",
                    "canary": None}
        with self._lock:
            alive = [r for r in self._replicas.values()
                     if r.state == HEALTHY] or \
                    [r for r in self._replicas.values()
                     if r.state in (HEALTHY, DEGRADED)]
            if not alive:
                raise ReplicaDeadError("no alive replica to canary")
            canary = min(alive, key=lambda r: r.seq)
        old = canary.server.current_params()
        base = self._gate_counters(canary)
        base_peers = self._peer_sheds(exclude=canary.name)
        self._rolling = True
        # intent before action: a canary_begin with no matching
        # canary_rolled_* means the manager died mid-probation — the
        # recovery path rolls the orphaned canary back
        # deterministically (it alone holds unvetted params)
        self._journal_append("canary_begin", name=canary.name,
                             version=self._params_version + 1)
        try:
            canary.server.swap(new_lm)
            for _ in range(int(watch_ticks)):
                if traffic is not None:
                    traffic()
                else:
                    time.sleep(float(tick_s))
            cur = self._gate_counters(canary)
            delta = {k: cur[k] - base[k] for k in cur}
            peers = self._peer_sheds(exclude=canary.name)
            # deltas keyed BY NAME over the survivors present in both
            # samples: replica churn during probation (a background
            # control tick crashing/backfilling a peer) must never
            # pair one replica's before with another's after —
            # positional pairing would produce garbage (even negative)
            # baselines and flip the gate either way
            peer_delta = [peers[n] - base_peers[n]
                          for n in peers if n in base_peers] or [0]
            peer_mean = sum(peer_delta) / len(peer_delta)
            reason = None
            if delta["failed"] > int(max_failures):
                reason = f"failures: {delta['failed']}"
            elif delta["unhealthy_outputs"] > 0:
                reason = (f"unhealthy outputs: "
                          f"{delta['unhealthy_outputs']}")
            elif delta["slo_total"] > 0 and \
                    delta["slo_met"] / delta["slo_total"] \
                    < float(min_attainment):
                reason = (f"SLO attainment "
                          f"{delta['slo_met'] / delta['slo_total']:.2f}"
                          f" < {min_attainment}")
            elif delta["sheds"] > shed_allowance \
                    + shed_ratio * peer_mean:
                reason = (f"shed rate {delta['sheds']} vs survivors' "
                          f"mean {peer_mean:.1f}")
            if reason is not None:
                canary.server.swap(_ParamsView(*old))
                self.metrics.count("canary_rollbacks")
                self._journal_append("canary_rolled_back",
                                     name=canary.name, reason=reason)
                log.warning("canary %s rolled back: %s", canary.name,
                            reason)
                return {"status": "rolled_back", "reason": reason,
                        "canary": canary.name, "delta": delta}
            # gate passed: roll forward, replica by replica
            with self._lock:
                rest = [r for r in self._replicas.values()
                        if r.state in (HEALTHY, DEGRADED)
                        and r.name != canary.name]
            for rec in rest:
                rec.server.swap(new_lm)
            self._params = (new_lm.aux, new_lm.blocks)
            self._params_version += 1
            self._journal_append("canary_rolled_forward",
                                 name=canary.name,
                                 version=self._params_version)
            self._journal_append("params",
                                 version=self._params_version)
            log.info("rollout complete: canary %s + %d replicas on "
                     "new params", canary.name, len(rest))
            return {"status": "rolled_forward", "canary": canary.name,
                    "replicas": [canary.name] + [r.name for r in rest],
                    "delta": delta}
        finally:
            self._rolling = False

    def _gate_counters(self, rec):
        m = rec.server.metrics
        return {"failed": m.count_value("failed"),
                "unhealthy_outputs": m.count_value("unhealthy_outputs"),
                "slo_total": m.count_value("slo_total"),
                "slo_met": m.count_value("slo_met"),
                "sheds": sum(m.count_value(k) for k in SHED_KEYS)}

    def _peer_sheds(self, exclude):
        """name -> total sheds for every alive survivor (keyed so the
        rollout gate diffs per replica across its probation window)."""
        with self._lock:
            recs = [r for r in self._replicas.values()
                    if r.state in (HEALTHY, DEGRADED)
                    and r.name != exclude]
        return {r.name: sum(r.server.metrics.count_value(k)
                            for k in SHED_KEYS) for r in recs}
