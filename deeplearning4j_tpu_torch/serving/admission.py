"""Overload control: deadline-aware admission + brownout policy.

The port's copy of deeplearning4j_tpu/serving/admission.py (stdlib only), held
against it by tests/test_torch_serving_stdlib.py; the text below is the
reference's.

PR 7's load_sweep measured what uncontrolled overload does to the decode
server: past the saturation knee, goodput-under-SLO COLLAPSES (2,515 ->
635 tok/s on the pinned CPU curve) because every admitted request eats
queue time until its deadline is unmakeable, then either dies mid-decode
(wasting the tokens it already got) or completes uselessly late —
queue_wait was 72% of all request time. The fix is classical overload
control: decide at ENQUEUE, against a live estimate of service capacity,
whether a request can possibly make its deadline — and if it cannot,
shed it IMMEDIATELY, before it costs anyone anything.

Three host-side pieces (stdlib-only, like kvpool: admission decisions
can never add a device dispatch, and everything unit-tests without a
device):

* **ServiceRateEstimator** — over the decode loop's recent scheduling
  iterations: a rolling MEDIAN of SECONDS PER ITERATION (wall time,
  chunk-prefill passes folded in) and an EWMA of TOKENS PER ACTIVE
  SLOT per token-bearing iteration (exactly 1.0 in plain decode; >1
  under speculation). Iteration time is the right primitive because it
  is OCCUPANCY-INDEPENDENT — the slot program computes every slot
  unconditionally, so one busy slot and a full house cost the same
  wall time — which means an estimate learned from solo warm-up
  traffic already predicts the full-house regime correctly (a naive
  aggregate tokens/sec EWMA learned solo under-reports capacity ~slots
  x and wrongly sheds the first real traffic: measured, and the bug
  this design replaces). The median, not a mean/EWMA, because the
  sample stream has structural outliers — a first-dispatch COMPILE is
  100-1000x a steady iteration, and one such sample in an EWMA biases
  predictions pessimistic for dozens of iterations (measured: wrong
  sheds at half the knee rate right after warm-up). The estimator
  stays unready until `min_samples` token-bearing iterations have
  landed: a cold estimator must never shed.

* **AdmissionController** — predicted completion for a new request =
  time to drain the work ahead at full-occupancy capacity
  (`backlog_units / (slots * tokens_per_slot / s_iter)`) plus the
  request's own service time (`own_units * s_iter / tokens_per_slot`).
  Work is counted in ITERATION-EQUIVALENT UNITS: generated tokens plus
  each request's prefill dispatches (one unit per prompt chunk in
  chunked mode, one for a one-shot prefill) — a slot consumes one
  scheduling iteration per unit, so the own-time term is structurally
  exact in plain mode and prefill-heavy backlogs no longer read as
  optimistically short (measured: ignoring prefill units produced
  mid-decode eviction thrash exactly in the marginal zone past the
  knee). A request is shed (`shed_predicted`) only when the prediction
  exceeds `conservatism` x its remaining deadline budget.
  `conservatism` >= 1 is the SHED-LATE knob: the estimator's errors
  must cost throughput (admitting a doomed request) before they may
  cost correctness (shedding a feasible one). On an idle server the
  backlog term vanishes and the own-time term approximates the solo
  total, so a request solo execution could finish in time — deadline
  at or above its solo latency — predicts within its budget by
  construction. tests/test_overload.py pins that invariant as a
  property test, and the decode server publishes every prediction's
  signed error (predicted - actual, ms) into the `admission_error_ms`
  histogram so a drifting estimator is visible on the Prometheus route
  before it is visible in shed counts.

* **BrownoutPolicy** — accept / DEFER / shed per request CLASS, driven
  by queue depth and recent SLO attainment. Brownout is the load-shape
  half admission prediction does not cover: prediction protects
  deadlines one request at a time; brownout protects the INTERACTIVE
  class as a matter of policy when the machine saturates (batch-class
  work parks in a deferred line that drains only when the primary
  queue is empty). Saturation behavior becomes an explicit object unit
  tests can enumerate, not an emergent accident of queue order.

`ContinuousDecodeServer(admission=..., brownout=...)` wires these in;
`tools/load_sweep.py --overload-ab` replays the PR 7 ladder with both
arms and pins goodput monotone past the knee.
"""
from __future__ import annotations

import collections
import threading

__all__ = ["ServiceRateEstimator", "AdmissionController",
           "BrownoutPolicy", "ACCEPT", "DEFER", "SHED", "PREEMPT"]

ACCEPT = "accept"
DEFER = "defer"
SHED = "shed"
PREEMPT = "preempt"


class ServiceRateEstimator:
    """Iteration-time + per-slot token-rate EWMAs (module docstring:
    iteration wall time is the occupancy-independent primitive — the
    slot program computes every slot unconditionally).

    `observe(tokens, dt, active)` is called once per scheduling
    iteration by the serve thread: `dt` feeds the iteration-time EWMA
    unconditionally (pure chunk-prefill passes lengthen iterations and
    must dilute capacity), `tokens / active` feeds the per-slot rate
    EWMA on token-bearing iterations (1.0 in plain decode, >1 under
    speculation). Predictions read both lock-free from client threads
    (float attribute reads are atomic under the GIL) and return None
    until `min_samples` token-bearing iterations have landed AND
    `slots` is known — the cold-start guard.

    `slots` is the scheduling width predictions scale capacity by; the
    decode server fills it in at construction when the caller left it
    None.

    VARIANCE-AWARE MARGIN (`margin`): under speculation the per-slot
    rate is 1..K tokens per iteration and swings with the workload's
    self-similarity — a few lucky high-acceptance iterations inflate
    the EWMA, the inflated rate admits marginal requests, acceptance
    reverts, and they die mid-decode (admit-then-evict thrash, the
    high-variance twin of the optimism the bias loop corrects —
    except the bias loop only learns AFTER evictions, while variance
    is visible BEFORE). Predictions therefore use a CONSERVATIVE rate:
    mean minus `margin` standard deviations (EWMA variance over the
    same samples), floored at 1.0 token/slot/iteration — the floor is
    structural, not a tuning: every decoding slot advances at least
    its bonus token per token-bearing iteration, so 1.0 is always
    achievable and the never-sheds-feasible-solo invariant survives
    any margin (a request whose deadline covers its worst-case
    1-token-per-iteration solo run predicts within budget by
    construction — pinned by property test in tests/test_overload.py).
    Plain decode has zero variance (every sample is exactly 1.0), so
    the margin is structurally free there. The `tokens_per_second`
    gauge keeps reporting the MEAN — it is the capacity/autoscaling
    read-out, not an admission decision."""

    def __init__(self, slots=None, alpha=0.2, min_samples=8, window=64,
                 margin=1.0):
        self.alpha = float(alpha)
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"need 0 < alpha <= 1, got {alpha}")
        self.margin = float(margin)
        if self.margin < 0.0:
            raise ValueError(f"need margin >= 0, got {margin}")
        self.slots = None if slots is None else int(slots)
        self.min_samples = int(min_samples)
        self.samples = 0
        self._iters = collections.deque(maxlen=int(window))
        self._s_iter = None     # rolling MEDIAN of the window above
        self._tok_slot = None   # EWMA tokens per ACTIVE slot per iter
        self._tok_var = 0.0     # EWMA variance of the same samples
        # delivered-rate window: (tokens, dt) per iteration — the
        # MEASURED aggregate rate, chunk passes/churn/host contention
        # and all. Under confirmed overload this is the true capacity
        # (occupancy is full, so the occupancy bias that disqualifies
        # it for warm-up is gone) and the model above, which ignores
        # zero-token passes, overestimates — `predict_seconds(
        # saturated=True)` caps drain capacity by it.
        self._win = collections.deque(maxlen=int(window))
        self._lock = threading.Lock()

    def observe(self, tokens, dt, active=0):
        """One scheduling iteration: `tokens` emitted across `active`
        decoding slots in `dt` seconds of wall time."""
        with self._lock:
            dt = max(float(dt), 0.0)
            self._iters.append(dt)
            srt = sorted(self._iters)
            n = len(srt)
            self._s_iter = (srt[n // 2] if n % 2 else
                            0.5 * (srt[n // 2 - 1] + srt[n // 2]))
            self._win.append((max(int(tokens), 0), dt))
            if tokens <= 0:
                return
            if active > 0:
                per_slot = tokens / float(active)
                if self._tok_slot is None:
                    self._tok_slot = per_slot
                else:
                    # EWMA mean + EWMA variance (deviation measured
                    # against the PRE-update mean — the standard
                    # exponentially-weighted pair)
                    dev = per_slot - self._tok_slot
                    self._tok_var = ((1.0 - self.alpha)
                                     * (self._tok_var
                                        + self.alpha * dev * dev))
                    self._tok_slot += self.alpha * dev
            self.samples += 1

    @property
    def delivered_tokens_per_second(self):
        """Measured aggregate rate over the iteration window (None
        while empty): every overhead included, occupancy NOT
        normalized — trustworthy only when the machine is known busy."""
        tok = dt = 0.0
        for t, d in list(self._win):
            tok += t
            dt += d
        return (tok / dt) if dt > 0 else None

    @property
    def ready(self):
        return (self.samples >= self.min_samples
                and self.slots is not None and bool(self._s_iter))

    @property
    def seconds_per_iteration(self):
        return self._s_iter if self.ready else None

    @property
    def tokens_per_second(self):
        """Full-occupancy capacity estimate (slots x per-slot rate /
        iteration time) — the `service_rate_tokens_per_sec` gauge.
        Reports the MEAN rate (the capacity/autoscaling read-out);
        admission predictions use the variance-margined rate below."""
        if not self.ready:
            return None
        return self.slots * (self._tok_slot or 1.0) / self._s_iter

    @property
    def tokens_per_slot_conservative(self):
        """The per-slot rate predictions divide by: EWMA mean minus
        `margin` EWMA standard deviations, floored at the structural
        1.0 token/slot/iteration worst case (every decoding slot lands
        at least its bonus token) and never above the mean. Plain
        decode: variance 0, so exactly the mean. None while no
        token-bearing sample has landed."""
        if self._tok_slot is None:
            return None
        pess = self._tok_slot - self.margin * (self._tok_var ** 0.5)
        return min(self._tok_slot, max(1.0, pess))

    def predict_seconds(self, backlog_tokens, own_tokens,
                        saturated=False):
        """Predicted seconds for a request with `own_tokens` to produce
        behind `backlog_tokens` of work ahead: drain the backlog at
        capacity, then (really: while) decode its own tokens one
        iteration each. None while cold. `saturated=True` (the server's
        confirmed-overload signal) caps drain capacity by the DELIVERED
        rate — under full occupancy that rate is ground truth, and the
        structural model, which never sees zero-token passes or host
        contention, reads high exactly when optimism turns into
        eviction thrash. The per-slot rate is the VARIANCE-MARGINED one
        (class docstring): high-variance acceptance widens predictions
        before it can thrash, and the 1.0 floor keeps the
        never-sheds-feasible-solo invariant for free."""
        if not self.ready:
            return None
        tps = self.tokens_per_slot_conservative or 1.0
        cap = self.slots * tps / self._s_iter
        if saturated:
            d = self.delivered_tokens_per_second
            if d:
                cap = min(cap, d)
        drain = float(backlog_tokens) / cap
        own = float(own_tokens) * self._s_iter / tps
        return drain + own


class AdmissionController:
    """Shed-at-enqueue decision: predicted completion vs deadline.

    `conservatism` scales the deadline budget the prediction is allowed
    to consume before shedding: 1.0 sheds exactly at the predicted
    miss, larger values shed later (the estimator must be MORE sure) —
    the knob the module docstring explains. The estimator is owned here
    so one controller can be shared/inspected; the decode server feeds
    it from the serve thread."""

    def __init__(self, conservatism=1.2, alpha=0.2, min_samples=8,
                 slots=None, bias_window=64, margin=1.0):
        self.conservatism = float(conservatism)
        if self.conservatism < 1.0:
            raise ValueError(f"conservatism must be >= 1.0 (shed late, "
                             f"never early), got {conservatism}")
        self.estimator = ServiceRateEstimator(slots=slots, alpha=alpha,
                                              min_samples=min_samples,
                                              margin=margin)
        # closed-loop bias correction: recent signed prediction errors
        # (predicted - actual; the decode server feeds completions and
        # eviction-time optimism BOUNDS). Only systematic OPTIMISM is
        # corrected — a negative median widens future predictions by
        # its magnitude, because optimism is the direction that admits
        # doomed requests (mid-decode eviction thrash, measured in the
        # marginal zone past the knee). Pessimistic drift is left to
        # the conservatism knob: correcting it would shrink
        # predictions, and a wrong shrink violates shed-late.
        self._errs = collections.deque(maxlen=int(bias_window))

    def observe_error(self, err_s):
        """One signed prediction-error sample in seconds (negative =
        optimistic). Fed by the decode server at request completion
        and, as a certain lower bound, at eviction/expiry."""
        self._errs.append(float(err_s))

    def bias_seconds(self):
        """Current optimism correction (>= 0): minus the median recent
        signed error when that median is negative, else 0."""
        errs = sorted(self._errs)
        n = len(errs)
        if n < 8:
            return 0.0
        med = errs[n // 2] if n % 2 else \
            0.5 * (errs[n // 2 - 1] + errs[n // 2])
        return max(0.0, -med)

    def predict_seconds(self, backlog_tokens, own_tokens,
                        saturated=False):
        """Predicted seconds until a request with `own_tokens` of its
        own budget, behind `backlog_tokens` of work ahead, completes —
        widened by the measured optimism bias; None while the estimator
        is cold."""
        p = self.estimator.predict_seconds(backlog_tokens, own_tokens,
                                           saturated=saturated)
        return None if p is None else p + self.bias_seconds()

    def should_shed(self, backlog_tokens, own_tokens, budget_s,
                    strict=False):
        """True when the prediction exceeds the allowed budget. A cold
        estimator never sheds; a request with no deadline is never shed
        (the caller passes budget_s=None).

        `strict` is the HYSTERESIS half of the conservatism contract:
        in the clear, predictions may consume `conservatism` x the
        budget before shedding (errors must cost throughput before
        correctness); once the server has CONFIRMED overload — actual
        evictions/queue expiries, not predictions (the decode server
        sets strict for a short window after each one) — the allowance
        drops to exactly 1.0 x budget, because every admitted
        predicted-miss in the [budget, conservatism x budget] band is
        now known to become eviction thrash, the precise waste this
        controller exists to prevent."""
        if budget_s is None:
            return False
        p = self.predict_seconds(backlog_tokens, own_tokens,
                                 saturated=strict)
        c = 1.0 if strict else self.conservatism
        return p is not None and p > c * max(float(budget_s), 0.0)


class BrownoutPolicy:
    """accept / defer / shed per request class at admission time.

    `classes` maps a class name to `(defer_at, shed_at)` queue-depth
    FRACTIONS (of the bounded submit queue): at or past defer_at the
    class parks in the deferred line (served only when the primary
    queue is empty — it yields to interactive work until pressure
    drops); at or past shed_at it is shed outright (`shed_brownout`).
    Classes not listed use `default`; the shipped default (1.01, 1.01)
    never defers or sheds, so an unconfigured class — and the decode
    server's implicit "default" class — behaves exactly as before the
    policy existed.

    `min_attainment`: when the server's RECENT SLO attainment (a
    rolling window the decode server maintains) drops below this, every
    class with defer_at <= 1 — i.e. any class that can defer at all
    (the never-defer default is 1.01) — defers regardless of queue
    depth: the attainment brownout. Depth measures pressure at the
    door, while attainment measures whether the machine is already
    failing the users inside."""

    def __init__(self, classes=None, default=(1.01, 1.01),
                 min_attainment=None):
        self.classes = {str(k): (float(d), float(s))
                        for k, (d, s) in (classes or {}).items()}
        self.default = (float(default[0]), float(default[1]))
        for name, (d, s) in list(self.classes.items()) + \
                [("default", self.default)]:
            if s < d:
                raise ValueError(f"class {name!r}: shed_at {s} < "
                                 f"defer_at {d} (defer must engage "
                                 f"first)")
        self.min_attainment = (None if min_attainment is None
                               else float(min_attainment))

    def may_preempt(self, victim_klass, claimant_klass):
        """The PREEMPT verb (durable KV state, serving/kvstate.py):
        True when a live `victim_klass` slot should yield its KV blocks
        to a `claimant_klass` request blocked on memory. The ranking is
        the one this policy already encodes: a class whose `defer_at`
        is STRICTLY below another's is the class that steps aside under
        queue pressure, so under MEMORY pressure it steps aside too —
        its work is spilled to host (resumable bit-identically), not
        thrown away, which is what bounds interactive TTFT at full
        block occupancy where queue-depth admission structurally
        cannot. Equal-rank classes never preempt each other (no
        same-class churn), and the shipped never-defer default (1.01)
        can never be a victim of another default-class request."""
        vd = self.classes.get(str(victim_klass), self.default)[0]
        cd = self.classes.get(str(claimant_klass), self.default)[0]
        return vd < cd

    def decide(self, klass, queue_frac, attainment=None):
        """One admission decision: ACCEPT, DEFER, or SHED."""
        defer_at, shed_at = self.classes.get(str(klass), self.default)
        if queue_frac >= shed_at:
            return SHED
        if queue_frac >= defer_at:
            return DEFER
        if (self.min_attainment is not None and attainment is not None
                and attainment < self.min_attainment and defer_at <= 1.0):
            return DEFER
        return ACCEPT
