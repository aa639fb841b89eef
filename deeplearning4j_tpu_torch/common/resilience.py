"""Fault-tolerance primitives: retry policies and deterministic fault
injection.

The port's copy of deeplearning4j_tpu/common/resilience.py (stdlib only), held against it
by tests/test_torch_*.py; the text below is the reference's.

The reference stack leans on Aeron (lossy-network-tolerant UDP transport)
and Spark (task re-execution) for resilience; the TCP reimplementation here
(`parallel/ps_transport.py`, `parallel/training_master.py`) needs those
semantics made explicit. This module is the one place they are defined:

  * `RetryPolicy` — bounded exponential backoff with deterministic jitter,
    an optional wall-clock deadline over all attempts, and retryable-
    exception classification. Shared by the PS client's reconnect path and
    available to any caller that talks across a process/network boundary.
  * `NonRetryableError` — marker mix-in: an exception carrying it is never
    retried, regardless of the policy's `retryable` tuple (e.g. a push the
    server REFUSED is a terminal condition, while a dropped connection is
    not, even though both subclass ConnectionError).
  * `RetryBudget` — fleet-wide token-bucket retry budget (Google-SRE
    style: retries refill as a fraction of successes), shared between
    every retrying path via `RetryPolicy(budget=...)`; exhaustion turns
    a retry into a loud `RetryBudgetExhaustedError` instead of load
    amplification.
  * `FaultInjector` — deterministic, seeded fault schedules keyed by call
    site. Production code exposes named sites (`client.push.sent`,
    `master.round`, `data.batch`, ...) and the injector decides per call
    whether to delay, sever a connection, corrupt a payload (NaN/Inf/
    value-poison — the data-path fault the training-health watchdog
    handles), and/or raise — so every failure mode the retry/heartbeat/
    resume/watchdog machinery handles has a repeatable test driving it
    through the REAL code path, not a mock.

Everything here is stdlib-only (no jax/numpy): the PS worker side is
numpy-only by design and must stay importable without jax. Retries and
injected faults additionally publish to the process-wide
`obs.registry.default_registry()` (also stdlib-only) — `resilience.
retries[.<metric>]` / `resilience.faults_injected[.<site>]` — so the
`/metrics` Prometheus route on ui/server.py shows transport health next
to serving and training counters.
"""
from __future__ import annotations

import logging
import random
import threading
import time

from ..obs.registry import default_registry

log = logging.getLogger(__name__)


class NonRetryableError(Exception):
    """Marker mix-in: never retried by any RetryPolicy, even when the
    concrete type also matches the policy's `retryable` classes."""


class RetryBudgetExhaustedError(NonRetryableError, RuntimeError):
    """The shared fleet-wide retry budget denied this retry: the
    failure is delivered LOUDLY instead of amplified into another
    replay/resend. Carries the NonRetryableError marker so no nested
    RetryPolicy ever retries the refusal itself."""


class FaultInjected(ConnectionError):
    """Default exception raised at an injected fault site."""


class RetryBudget:
    """Fleet-wide token-bucket retry budget (the Google-SRE "retry
    budget": retries are paid for by SUCCESSES, so past the saturation
    knee the recovery machinery cannot amplify offered load — the
    metastable-failure regime).

    One instance is SHARED by every path that retries on the fleet's
    behalf: the manager's failover replays (serving/fleet.py) and the
    wire transport's reconnect/resend loops (serving/wire.py, via
    `RetryPolicy.budget`). `take()` spends one token per retry and
    returns False when the bucket is dry — the caller converts the
    denial into a loud typed failure (`RetryBudgetExhaustedError`),
    never a silent drop. `on_success()` refills `refill_fraction`
    tokens per successful completion, capped at `capacity`, so a
    healthy fleet always has budget and a melting one starves its own
    retry storm. A fleet that never retries never touches the bucket —
    the no-fault A/B is byte-identical with or without a budget."""

    def __init__(self, capacity=64, refill_fraction=0.1, initial=None):
        self.capacity = float(capacity)
        self.refill_fraction = float(refill_fraction)
        if self.capacity < 0 or self.refill_fraction < 0:
            raise ValueError("need capacity >= 0 and "
                             "refill_fraction >= 0")
        self._tokens = (self.capacity if initial is None
                        else min(float(initial), self.capacity))
        self._lock = threading.Lock()
        self.denied = 0         # lifetime denial count (observability)

    @property
    def tokens(self):
        with self._lock:
            return self._tokens

    def take(self, n=1):
        """Spend `n` tokens for a retry; False = budget exhausted (the
        caller must fail loudly, not wait)."""
        with self._lock:
            if self._tokens >= n:
                self._tokens -= n
                return True
            self.denied += 1
            return False

    def on_success(self, n=1):
        """Refill from `n` successful completions."""
        with self._lock:
            self._tokens = min(self.capacity,
                               self._tokens + self.refill_fraction * n)


class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    delay(attempt) = min(max_delay, base_delay * multiplier**attempt),
    scaled by a seeded uniform jitter in [1-jitter, 1+jitter] — the seed
    makes backoff sequences reproducible in tests while still decorrelating
    real workers (give each worker a different seed).

    `deadline` bounds the TOTAL wall clock across all attempts: the final
    backoff sleep is CAPPED by the remaining deadline (never sleeping past
    it), buying one last attempt at the deadline edge; once the deadline
    is spent the last error re-raises. `sleep`/`clock` are injectable for
    tests (fake time).
    """

    def __init__(self, max_retries=5, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.25, deadline=None,
                 retryable=(ConnectionError, TimeoutError, OSError),
                 seed=0, sleep=None, clock=None, metric=None,
                 budget=None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        # `metric`: optional name suffix for the registry counter, so a
        # PS client's reconnect retries and a serving dispatch's retries
        # are distinguishable on the /metrics route
        self.metric = metric
        # `budget`: optional shared RetryBudget — the fleet-wide retry
        # gate every holder of this policy consults via grant_retry()
        # before spending an attempt. None (default) = unbudgeted, the
        # exact legacy behavior.
        self.budget = budget
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = None if deadline is None else float(deadline)
        self.retryable = tuple(retryable)
        self._rng = random.Random(seed)
        self._sleep = sleep if sleep is not None else time.sleep
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()

    def is_retryable(self, exc):
        if isinstance(exc, NonRetryableError):
            return False
        return isinstance(exc, self.retryable)

    def grant_retry(self, n=1):
        """Consult the shared retry budget (True when unbudgeted). One
        call per retry ATTEMPT, made at the spend site — the policy
        itself stays stateless across holders."""
        return self.budget is None or self.budget.take(n)

    def delay(self, attempt):
        """Backoff before retry number `attempt` (0-based). Consumes one
        jitter draw from the seeded rng (thread-safe)."""
        d = min(self.max_delay, self.base_delay * self.multiplier ** attempt)
        if self.jitter:
            with self._lock:
                u = self._rng.uniform(-1.0, 1.0)
            d = max(0.0, d * (1.0 + self.jitter * u))
        return d

    def call(self, fn, on_retry=None):
        """Run `fn()` with retries. `on_retry(attempt, exc, delay)` fires
        before each backoff sleep (logging/metrics hook). Non-retryable
        exceptions, exhausted attempts, and deadline overruns re-raise the
        last error unchanged."""
        start = self._clock()
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self.is_retryable(e) or attempt >= self.max_retries:
                    raise
                if not self.grant_retry():
                    raise RetryBudgetExhaustedError(
                        f"retry budget exhausted after "
                        f"{type(e).__name__}: {e}") from e
                d = self.delay(attempt)
                if self.deadline is not None:
                    remaining = self.deadline - (self._clock() - start)
                    if remaining <= 0:
                        raise
                    # cap the final backoff by the remaining wall clock:
                    # never sleep past the deadline, but do spend the
                    # remainder on one last attempt instead of forfeiting
                    # it by raising early
                    d = min(d, remaining)
                reg = default_registry()
                reg.counter("resilience.retries").inc()
                if self.metric:
                    reg.counter(
                        f"resilience.retries.{self.metric}").inc()
                if on_retry is not None:
                    on_retry(attempt, e, d)
                self._sleep(d)
                attempt += 1


class _Rule:
    __slots__ = ("on_calls", "prob", "remaining", "exc", "delay", "sever",
                 "corrupt")


def _poison(payload, value):
    """Duck-typed payload corruption: fill a COPY of an array-like payload
    with `value` (float('nan'), float('inf'), or any finite float —
    finite poison models the loss-spike class, non-finite the NaN/Inf
    class). The original is never mutated — sites rebind the returned
    payload, matching the pipeline's rebind-only contract. Covers numpy
    (.copy + in-place .fill), immutable array types like jax.Array
    (arithmetic broadcast keeps shape/dtype), and bare scalars."""
    copy = getattr(payload, "copy", None)
    fill = getattr(payload, "fill", None)
    if callable(copy) and callable(fill):
        out = payload.copy()
        out.fill(value)
        return out
    if hasattr(payload, "shape") and hasattr(payload, "__mul__"):
        # immutable arrays (jax.Array): broadcast the poison, same shape
        return payload * 0 + value
    return value


class FaultInjector:
    """Deterministic fault schedules keyed by instrumented call site.

    A site is a string name a production code path fires on every pass
    (`injector.fire("client.push.sent", on_sever=...)`); each site keeps a
    call counter. Rules planned against the site decide, per call, whether
    to inject — by explicit call index (`on_call`/`on_calls`, exactly
    reproducible) or by seeded probability (`prob`, reproducible for a
    given seed + call sequence). A firing rule can sleep (`delay`), invoke
    the site's sever callback (`sever=True` — e.g. the PS client closes its
    socket, simulating a network cut), corrupt the payload the site passed
    (`corrupt`: "nan" / "inf" / a float — `fire` returns a poisoned COPY
    the site rebinds, the data-path analog of a network fault), and raise
    (`exc`: class or instance; None = fault without raising, for pure
    delay/sever/corrupt).

    `times` caps how often a rule fires (default: once per planned call
    index, or once for prob/always rules).
    """

    def __init__(self, seed=0):
        self._rng = random.Random(seed)
        self._rules = {}
        self._calls = {}
        self._fired = []
        self._lock = threading.Lock()
        self._sleep = time.sleep

    def plan(self, site, on_call=None, on_calls=None, prob=None, times=None,
             exc=FaultInjected, delay=0.0, sever=False, corrupt=None):
        """Schedule a fault at `site`; returns self for chaining.

        `corrupt`: poison the site's payload — "nan", "inf", or any float
        fill value. A corrupt-only plan defaults `exc` to None (the
        poisoned payload flowing onward IS the fault; raising as well
        would mask the data path under test). Pass `exc` explicitly to
        combine."""
        if on_call is not None and on_calls is not None:
            raise ValueError("pass on_call or on_calls, not both")
        if on_call is not None:
            on_calls = [on_call]
        rule = _Rule()
        rule.on_calls = (None if on_calls is None
                         else {int(c) for c in on_calls})
        rule.prob = None if prob is None else float(prob)
        if times is None:
            times = len(rule.on_calls) if rule.on_calls is not None else 1
        rule.remaining = int(times)
        if corrupt is None:
            rule.corrupt = None
        else:
            named = {"nan": float("nan"), "inf": float("inf")}
            rule.corrupt = (named[corrupt] if isinstance(corrupt, str)
                            else float(corrupt))
            if exc is FaultInjected:
                exc = None
        rule.exc = exc
        rule.delay = float(delay)
        rule.sever = bool(sever)
        with self._lock:
            self._rules.setdefault(site, []).append(rule)
        return self

    def fire(self, site, on_sever=None, payload=None):
        """Instrumentation point: bump the site's call counter and apply
        the first matching rule (delay -> sever -> corrupt -> raise).
        Returns `payload` — poisoned (a corrupted COPY; the site must
        rebind it) when a corrupt rule fired, untouched otherwise."""
        with self._lock:
            n = self._calls.get(site, 0)
            self._calls[site] = n + 1
            hit = None
            for rule in self._rules.get(site, ()):
                if rule.remaining <= 0:
                    continue
                if rule.on_calls is not None:
                    match = n in rule.on_calls
                elif rule.prob is not None:
                    match = self._rng.random() < rule.prob
                else:
                    match = True
                if match:
                    rule.remaining -= 1
                    hit = rule
                    self._fired.append((site, n))
                    break
        if hit is None:
            return payload
        reg = default_registry()
        reg.counter("resilience.faults_injected").inc()
        reg.counter(f"resilience.faults_injected.{site}").inc()
        log.warning("fault injected at %s (call #%d): delay=%.3fs sever=%s"
                    " corrupt=%s", site, n, hit.delay, hit.sever,
                    hit.corrupt)
        if hit.delay:
            self._sleep(hit.delay)
        if hit.sever and on_sever is not None:
            on_sever()
        if hit.corrupt is not None and payload is not None:
            payload = _poison(payload, hit.corrupt)
        exc = hit.exc
        if exc is None:
            return payload
        if isinstance(exc, BaseException):
            raise exc
        raise exc(f"injected fault at {site} (call #{n})")

    def calls(self, site):
        """How many times `site` has fired its instrumentation point."""
        with self._lock:
            return self._calls.get(site, 0)

    def fired(self, site=None):
        """(site, call_index) events for faults actually injected."""
        with self._lock:
            return [e for e in self._fired if site is None or e[0] == site]
