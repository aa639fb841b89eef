"""InferenceServer — adaptive micro-batching over one network container.
Port of deeplearning4j_tpu/serving/server.py: the error classes, the
request loop and `InferenceServer`, with the reference's request path:

  submit(x) -> bounded queue -> batcher thread coalesces up to
  `max_batch` requests or `max_wait_ms`, whichever first -> the batch is
  right-padded to the nearest PADDING BUCKET -> one dispatch of the
  network's inference step -> per-request rows are sliced out and the
  futures resolved.

On the card the step is the container's eager forward
(`net.make_inference_fn()`, cuDNN and cuBLAS) under `torch.no_grad()` and
`card_numerics`; the batcher thread enters both itself (no_grad is
thread-local). It launches on the device's default stream, which it
shares with the caller's thread: a caller that trains while the server
serves has its work serialised with the server's on that stream.

Design pins (tests/test_torch_inference_server.py):

  * Determinism. Row results of the forward are independent of the other
    rows at a fixed batch shape, so a request's result is bit-identical
    whether it ran alone or co-batched, within its bucket. The bucket
    floor is 2, as the reference's (its XLA:CPU gemm takes another path
    at M=1). On torch's CPU a row's bits are also the same in every
    bucket from 2 up. On the card cuDNN searches a plan per shape and per
    thread (`cudnn.benchmark`), so a row may round differently in another
    bucket, or in `output()` of the same batch on the caller's thread:
    those agree within bf16's rounding (PERF.md section 2).
  * A bounded program set. One entry per (bucket, example structure): a
    mixed-size stream creates at most len(buckets) per input structure.
    On the card the first dispatch of a bucket on the batcher thread runs
    cuDNN's algorithm search for its shapes (PyTorch keeps cuDNN's plans
    per thread), about a second on an H100 for ResNet-50, as the
    reference compiles a bucket's program at its first use: send warm-up
    traffic before measuring.
  * Hot swap. The parameters, cast once to the compute type, and the
    layers' state live in ONE reference the batcher reads once per
    dispatch; `swap()` checks the new tree's keys, shapes, dtypes and
    device and replaces the reference atomically. In-flight batches drain
    on the old parameters; queued and future requests get the new ones.

Deadlines and queue backpressure shed load explicitly
(`DeadlineExceededError` / `ServerOverloadedError` futures, never silent
drops); transient dispatch failures go through
`common.resilience.RetryPolicy`; `FaultInjector` sites (`serve.request`,
`serve.batch`, `serve.swap`) drive the fault tests through the real code
path; `screen_outputs=True` fails just the NaN/Inf rows
(`common.health.rowwise_finite`).
"""
from __future__ import annotations

import concurrent.futures as cf
import itertools
import logging
import queue
import threading
import time

import numpy as np
import torch

from .. import obs
from ..common.device import to_public

log = logging.getLogger(__name__)


class ServingError(RuntimeError):
    """Base class for request-level serving failures."""


class ServerOverloadedError(ServingError):
    """Queue-full backpressure: the request was shed at admission."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before dispatch."""


class UnhealthyOutputError(ServingError):
    """Output screening found NaN/Inf in this request's rows."""


class ServerClosedError(ServingError):
    """The server was stopped before the request could run."""


class RequestMigratedError(ServingError):
    """This request's KV state was exported to another server
    (`ContinuousDecodeServer.migrate_out`): its LOCAL future will never
    produce tokens — the importing server's future carries the resumed
    stream. Raised on the local future so a caller polling the wrong
    server fails loudly instead of hanging."""


class RequestDrainedError(ServingError):
    """This request was handed back as a REPLAY SPEC by
    `ContinuousDecodeServer.drain()` — it was queued or still
    prefilling at drain time, and a half-written prefill panel is never
    an artifact (the durable-KV victim rule, enforced at the drain
    seam). Its local future will never produce tokens; the drain caller
    (`serving.fleet.FleetManager`) resubmits the returned spec on a
    survivor, where deterministic greedy decode reproduces the exact
    stream."""


class PoisonPillError(ServingError):
    """This request was QUARANTINED by the fleet's blast-radius
    containment (serving/fleet.py): it was aboard for two or more
    distinct replica deaths, which marks it the probable killer — its
    outer future fails with this error instead of being replayed onto
    yet another survivor, and its prompt fingerprint sheds future
    re-submissions at admission. Innocent co-victims of the same
    replica deaths still fail over normally."""


class ReplicaDeadError(ServingError):
    """The replica serving (or chosen for) this request died: its serve
    loop was killed mid-stream (`ContinuousDecodeServer.kill` — the
    fleet crash-injection verb) or its thread is gone. The
    `FleetManager` resubmits in-flight requests to survivors via prompt
    replay; a direct caller sees this loudly instead of hanging on a
    future nobody will resolve."""


def _fail_future(fut, exc):
    """set_exception unless the caller already resolved/cancelled it.
    The done() pre-check alone races a concurrent cancel() — and several
    call sites run OUTSIDE a serve loop's try, where an InvalidStateError
    would kill the serve thread permanently. Returns True when the
    exception was delivered (callers count metrics only then)."""
    try:
        if not fut.done():
            fut.set_exception(exc)
            return True
    except cf.InvalidStateError:
        pass
    return False


def _resolve_future(fut, result):
    """set_result, tolerating a concurrently cancel()ed future."""
    try:
        if not fut.done():
            fut.set_result(result)
            return True
    except cf.InvalidStateError:
        pass
    return False


class _ParamsView:
    """Duck-typed (aux, blocks) holder every `swap()` accepts — the
    fleet manager's rollback snapshot / spawn carrier and the serving
    wire's SWAP deserialization target share this ONE definition."""

    __slots__ = ("aux", "blocks")

    def __init__(self, aux, blocks):
        self.aux, self.blocks = aux, blocks


class _Request:
    __slots__ = ("x", "future", "deadline", "t_submit", "req_id")

    def __init__(self, x, deadline):
        self.x = x
        self.future = cf.Future()
        self.deadline = deadline
        self.t_submit = time.monotonic()
        self.req_id = None      # assigned at submit (the trace/request id)


def _default_buckets(max_batch):
    """Powers of two from 2 up to and including max_batch. The floor is 2
    even for max_batch=1 (a queue-only config), as the reference's: a
    product of M=1 rows takes the gemv path, whose accumulation order
    differs from gemm's."""
    out = []
    b = 2
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max(int(max_batch), 2))
    return tuple(sorted(set(out)))


class _RequestLoop:
    """Shared lifecycle for the serving loops (InferenceServer and
    ContinuousDecodeServer): bounded request queue, batcher-thread
    start/stop with drain-vs-fail-fast semantics, and the subtle
    threading guards — the submit/stop race re-check (a request enqueued
    after the loop's final drain must be failed, never silently lost),
    the join-timeout path (a loop still draining keeps `_thread` set so
    `start()` refuses a second thread), and the queued-work failure
    drain. ONE implementation so a fix here cannot drift between the two
    servers. Subclasses set `_thread_name` / `_default_stop_timeout`,
    implement `_loop_once()` (one scheduling iteration), and may
    override `_busy()` (work in progress that must finish before a
    draining stop may exit)."""

    _thread_name = "serving-loop"
    _default_stop_timeout = 30.0

    def _init_loop(self, max_queue):
        self._q = queue.Queue(maxsize=int(max_queue))
        self._running = False
        self._drain_on_stop = True
        self._thread = None
        self._req_ids = itertools.count()
        if not hasattr(self, "_tracer"):    # subclasses normally set it
            self._tracer = obs.TRACER
        if not hasattr(self, "_flight"):
            self._flight = None

    # -- hooks ---------------------------------------------------------
    def _busy(self):
        return False

    def _loop_once(self):
        raise NotImplementedError

    # -- lifecycle -----------------------------------------------------
    def start(self):
        if self._running:
            return self
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("previous serve loop has not exited yet")
        self._running = True
        self._thread = threading.Thread(target=self._serve_loop,
                                        name=self._thread_name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Stop the loop. drain=True serves everything already queued
        first; drain=False fails queued requests with ServerClosedError."""
        if not self._running:
            return
        timeout = (self._default_stop_timeout if timeout is None
                   else float(timeout))
        self._drain_on_stop = bool(drain)
        self._running = False
        t = self._thread
        t.join(timeout)
        if t.is_alive():
            # leave _thread set: start() must refuse until the loop exits
            # (and _drain_on_stop keeps the value the loop is acting on)
            log.warning("serve loop still draining after %.1fs", timeout)
            return
        self._thread = None
        self._drain_on_stop = True
        self._fail_queued(ServerClosedError("server stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- queue machinery -----------------------------------------------
    def _pending_depth(self):
        """The depth sampled at enqueue time. Subclasses with parked
        side lines (the decode server's priority line) add them here so
        every enqueue records ONE consistent number — overriding the
        sample itself would double-record."""
        return self._q.qsize()

    def _enqueue(self, req):
        """Admit `req` (has .future) or shed loudly; returns the future."""
        if req.req_id is None:
            req.req_id = next(self._req_ids)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.metrics.count("shed_queue_full")
            # queue-depth staleness fix: a shed IS a depth observation (a
            # full queue), even when no batch forms for a while
            self.metrics.record_queue_depth(self._q.maxsize)
            raise ServerOverloadedError(
                f"queue full ({self._q.maxsize} pending)") from None
        # depth sampled at ENQUEUE, not only at batch formation: an
        # idle-then-bursty server must report admission pressure
        self.metrics.record_queue_depth(self._pending_depth())
        tr = self._tracer
        if tr.enabled:
            tr.instant("serve.enqueue", cat="serve",
                       track=f"req-{req.req_id}", trace_id=req.req_id)
        if not self._running:
            # raced stop(): the loop's final drain may already have run,
            # leaving this request in a dead queue — fail it HERE so no
            # caller ever blocks on a future nobody will resolve
            # (_fail_future: a concurrent cancel() must not turn the
            # loud shed into an InvalidStateError)
            _fail_future(req.future,
                         ServerClosedError("server stopped during "
                                           "submit"))
            raise ServerClosedError("server stopped during submit")
        return req.future

    def _fail_queued(self, exc):
        """Fail everything still queued (late submits that raced stop())."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if _fail_future(r.future, exc):
                self.metrics.count("failed")

    def _serve_loop(self):
        while True:
            if not self._running and not self._busy() and (
                    not self._drain_on_stop or self._q.empty()):
                break
            self._loop_once()
        self._fail_queued(ServerClosedError("server stopped"))


def _snapshot(net):
    """(params cast to the network's compute type, layer state): private
    copies, so training the network later cannot change what a server
    serves, and the cast happens once per install, not per dispatch."""
    net._ensure_init()
    cdt = net.compute_dtype
    with torch.no_grad():
        params = {key: {k: p.detach().to(cdt, copy=True)
                        for k, p in per.items()}
                  for key, per in net._params.items()}
        state = {key: {n: b.detach().clone() for n, b in per.items()}
                 for key, per in net._model_state.items()}
    return params, state


def _leaves(tree):
    """(path, tensor) of a {key: {name: tensor}} tree, in a fixed order."""
    return [((key, name), t) for key, per in tree.items()
            for name, t in per.items()]


class InferenceServer(_RequestLoop):
    """Micro-batching inference endpoint over one network container.

    `net` is a MultiLayerNetwork or ComputationGraph (anything with
    `make_inference_fn()`, `_params`, `_model_state`, `compute_dtype` and
    `device`). Requests are SINGLE examples (no batch axis; dict of arrays
    for multi-input graphs) as numpy; results are the per-example output
    rows as numpy (a list for a graph).
    """

    _thread_name = "inference-server"
    _default_stop_timeout = 30.0

    def __init__(self, net, max_batch=8, max_wait_ms=2.0, buckets=None,
                 max_queue=64, default_deadline_ms=None, retry_policy=None,
                 fault_injector=None, screen_outputs=False, metrics=None,
                 stats_reporter=None, report_every=16, tracer=None,
                 flight_recorder=None):
        from .metrics import ServingMetrics
        self._tracer = tracer if tracer is not None else obs.TRACER
        self._flight = flight_recorder
        net._ensure_init()
        self._net_type = type(net)
        self.device = net.device
        self._infer = net.make_inference_fn()
        self._params_ref = _snapshot(net)
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.buckets = (tuple(sorted(int(b) for b in buckets)) if buckets
                        else _default_buckets(self.max_batch))
        if self.buckets[-1] < self.max_batch:
            raise ValueError(f"largest bucket {self.buckets[-1]} < "
                             f"max_batch {self.max_batch}")
        self.default_deadline = (None if default_deadline_ms is None
                                 else float(default_deadline_ms) / 1e3)
        self._retry = retry_policy
        self._injector = fault_injector
        self._screen = bool(screen_outputs)
        self.metrics = metrics or ServingMetrics()
        self._reporter = stats_reporter
        self._report_every = max(1, int(report_every))
        self._programs = {}
        self._swap_lock = threading.Lock()
        self._since_report = 0
        self._init_loop(max_queue)

    # -- client API ----------------------------------------------------
    def submit(self, x, deadline_ms=None):
        """Enqueue one example; returns a concurrent.futures.Future whose
        result is this example's output rows. Raises ServerOverloadedError
        immediately when the queue is full (explicit backpressure)."""
        if not self._running:
            raise ServerClosedError("server is not running")
        if self._injector is not None:
            x = self._injector.fire("serve.request", payload=x)
        self.metrics.count("received")
        dl = (time.monotonic() + deadline_ms / 1e3 if deadline_ms is not None
              else (time.monotonic() + self.default_deadline
                    if self.default_deadline is not None else None))
        return self._enqueue(_Request(x, dl))

    def predict(self, x, deadline_ms=None, timeout=None):
        """Blocking single-request convenience wrapper over submit()."""
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    # -- hot swap ------------------------------------------------------
    def swap(self, new_net):
        """Install a new model's parameters and state without dropping
        in-flight requests: the in-flight dispatch holds its own reference
        and drains; every batch formed after this call reads the new one.
        The new tree must match the serving tree's keys and each tensor's
        shape, dtype and device (a mismatch raises; it never swaps in a
        different architecture)."""
        with self._swap_lock:
            if self._injector is not None:
                self._injector.fire("serve.swap")
            if type(new_net) is not self._net_type:
                raise ValueError(f"swap rejected: a {type(new_net).__name__}"
                                 f" cannot replace the serving "
                                 f"{self._net_type.__name__}")
            new = _snapshot(new_net)
            for old_t, new_t in zip(self._params_ref, new):
                old_l, new_l = _leaves(old_t), _leaves(new_t)
                if [p for p, _ in old_l] != [p for p, _ in new_l]:
                    raise ValueError(
                        "swap rejected: param tree structure differs "
                        f"({[p for p, _ in new_l]} vs serving "
                        f"{[p for p, _ in old_l]})")
                for (path, o), (_, n) in zip(old_l, new_l):
                    if (o.shape, o.dtype, o.device) != (n.shape, n.dtype,
                                                        n.device):
                        raise ValueError(
                            f"swap rejected: leaf mismatch at {path}: "
                            f"{tuple(n.shape)}/{n.dtype}/{n.device} vs "
                            f"serving {tuple(o.shape)}/{o.dtype}/{o.device}")
            self._params_ref = new
            self.metrics.count("swaps")
        log.info("hot swap installed (%d swaps total)",
                 self.metrics.snapshot().get("swaps", 0))

    def swap_from_path(self, path):
        """Hot swap from a model zip (`util.model_serializer`), restored on
        the serving device; its architecture must match."""
        from ..util import model_serializer
        self.swap(model_serializer.restore_model(path, load_updater=False,
                                                 device=self.device))

    def swap_from_checkpoint(self, directory, net_factory, step=None):
        """Hot swap from a `ShardedCheckpointManager` directory: a fresh
        network from `net_factory()` (built on the serving device; `swap`
        refuses another), restored from `step` (default: the latest), then
        swapped in."""
        from ..util.sharded_checkpoint import ShardedCheckpointManager
        mgr = ShardedCheckpointManager(directory)
        net = net_factory()
        net._ensure_init()
        mgr.restore(net, step if step is not None else mgr.latest_step())
        self.swap(net)

    # -- batcher internals ---------------------------------------------
    @property
    def compiled_programs(self):
        """Snapshot of the per-(bucket, example structure) program keys
        (the bounded-program pin counts these)."""
        return dict(self._programs)

    def _bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _leaves(self, x):
        # sorted key order for dicts: two requests differing only in
        # insertion order are the same program
        return ([x[k] for k in sorted(x)] if isinstance(x, dict) else [x])

    def _struct_key(self, x):
        """Structure signature of one example: the batching and program
        unit (dict key set + per-leaf shape/dtype, key-order-insensitive)."""
        if isinstance(x, dict):
            names = tuple(sorted(x))
        else:
            names = None
        return (names, tuple((tuple(np.shape(l)), str(np.asarray(l).dtype))
                             for l in self._leaves(x)))

    def _program(self, bucket, example):
        """The dispatch for one (bucket, structure) key. The port's step is
        eager, so a program is the inference step itself; cuDNN's
        algorithm search for the bucket's shapes runs on its first call."""
        key = (bucket, self._struct_key(example))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._infer
            log.info("serving program bucket=%d (%d cached)",
                     bucket, len(self._programs))
        return prog

    def _stack_pad(self, reqs, bucket):
        """[n_real examples] -> bucket-padded batch (zero rows pad; row
        independence makes pad content irrelevant to real rows)."""
        def stack(*rows):
            a = np.stack([np.asarray(r) for r in rows])
            if a.shape[0] < bucket:
                pad = np.zeros((bucket - a.shape[0],) + a.shape[1:],
                               a.dtype)
                a = np.concatenate([a, pad])
            return a
        first = reqs[0].x
        if isinstance(first, dict):
            return {k: stack(*[r.x[k] for r in reqs]) for k in first}
        return stack(*[r.x for r in reqs])

    def _collect(self):
        """Coalesce one micro-batch: block for the first request, then
        fill until max_batch or max_wait, capped by the earliest deadline."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        t_close = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            now = time.monotonic()
            close = t_close
            for r in batch:
                if r.deadline is not None:
                    close = min(close, r.deadline)
            if now >= close:
                break
            try:
                batch.append(self._q.get(timeout=close - now))
            except queue.Empty:
                break
        return batch

    def _loop_once(self):
        batch = self._collect()
        if not batch:
            return
        try:
            self._run_batch(batch)
        except BaseException as e:  # noqa: BLE001 — fail futures
            n_failed = 0
            for r in batch:
                if _fail_future(r.future, e):
                    n_failed += 1
            if n_failed:
                self.metrics.count("failed", n_failed)

    def _run_batch(self, batch):
        now = time.monotonic()
        live = []
        for r in batch:
            if r.future.done():       # failed by a raced submit/stop
                continue
            if r.deadline is not None and now > r.deadline:
                _fail_future(r.future, DeadlineExceededError(
                    f"deadline missed by {(now - r.deadline) * 1e3:.1f}ms "
                    "before dispatch"))
                self.metrics.count("shed_deadline")
                self.metrics.record_slo_miss()
            else:
                live.append(r)
        if not live:
            return
        # requests with different input structures cannot share a
        # dispatch: partition by the program key's structure
        groups = {}
        for r in live:
            groups.setdefault(self._struct_key(r.x), []).append(r)
        for group in groups.values():
            self._dispatch_group(group, now)
        self._since_report += len(groups)
        if self._reporter is not None and \
                self._since_report >= self._report_every:
            self._since_report = 0
            self._reporter.report(self.metrics.snapshot())

    def _dispatch_group(self, live, now):
        tr = self._tracer
        bucket = self._bucket_for(len(live))
        self.metrics.record_batch(len(live), bucket, self._q.qsize())
        if tr.enabled:
            now_ns = time.monotonic_ns()
            for r in live:
                t0 = int(r.t_submit * 1e9)
                tr.emit("serve.queue_wait", t0, now_ns - t0, cat="serve",
                        track=f"req-{r.req_id}", trace_id=r.req_id)
        with tr.span("serve.batch", cat="serve", track="server",
                     bucket=bucket, n_real=len(live)):
            prog = self._program(bucket, live[0].x)
            params, state = self._params_ref     # ONE read: swap-atomic
            x = self._stack_pad(live, bucket)

            def dispatch():
                if self._injector is not None:
                    self._injector.fire("serve.batch")
                return prog(params, state, x)

            # one host call: the launches; the host waits in to_public
            with tr.span("serve.dispatch", cat="serve", track="server",
                         bucket=bucket):
                if self._retry is not None:
                    out = self._retry.call(
                        dispatch,
                        on_retry=lambda a, e, d: self.metrics.count(
                            "retries"))
                else:
                    out = dispatch()
            single = not isinstance(out, (list, tuple))
            rows = [to_public(l) for l in (out if not single else [out])]
            ok = None
            if self._screen:
                from ..common.health import rowwise_finite
                ok = rowwise_finite(rows)
            t_done = time.monotonic()
            for i, r in enumerate(live):
                if r.future.done():
                    continue
                if ok is not None and not ok[i]:
                    if _fail_future(r.future, UnhealthyOutputError(
                            "non-finite values in request output")):
                        self.metrics.count("unhealthy_outputs")
                    continue
                res = [a[i] for a in rows]
                if not _resolve_future(r.future, res[0] if single else res):
                    continue
                total_ms = (t_done - r.t_submit) * 1e3
                self.metrics.record_request(
                    total_ms, (now - r.t_submit) * 1e3,
                    deadline_met=(None if r.deadline is None
                                  else t_done <= r.deadline))
                if tr.enabled:
                    t0 = int(r.t_submit * 1e9)
                    tr.emit("serve.request", t0,
                            int((t_done - r.t_submit) * 1e9), cat="serve",
                            track=f"req-{r.req_id}", trace_id=r.req_id)
                if self._flight is not None:
                    self._flight.observe(total_ms)
