"""The port's stdlib halves of observability and serving, against the JAX
package's: `obs.registry`, `obs.trace`, `obs.decompose`,
`common.resilience`, `serving.metrics.ServingMetrics` and
`common.health.rowwise_finite`; and the port's `card_numerics` under
concurrent callers.

Every module here is a copy of the reference's, so the tolerance is
equality: the same recorded values give the same Prometheus text,
snapshots, trace events, decompositions, retry delays and fault
schedules. `rowwise_finite` gives the same rows on numpy inputs, and
also takes tensors (bf16 included).

`card_numerics` saves the process-wide cuDNN/cuBLAS flags on the first
entry and restores them on the last exit, and keeps TF32 off while any
float32/float64 scope is open. The test drives two threads through
interleaved scopes with `torch.device("cuda")` objects: building the
device object needs no card, and the flags can be set on a CPU build.
"""
import ast
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import obs as tobs
from deeplearning4j_tpu_torch.common import health as thealth
from deeplearning4j_tpu_torch.common import resilience as tres
from deeplearning4j_tpu_torch.common.device import card_numerics
from deeplearning4j_tpu_torch.obs import registry as treg
from deeplearning4j_tpu_torch.obs import trace as ttrace
from deeplearning4j_tpu_torch.serving import metrics as tmetrics

PORT = Path(__file__).resolve().parents[1] / "deeplearning4j_tpu_torch"


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    from deeplearning4j_tpu.common import health, resilience
    from deeplearning4j_tpu import obs
    from deeplearning4j_tpu.obs import registry, trace
    from deeplearning4j_tpu.serving import metrics
    import test_obs
    return types.SimpleNamespace(registry=registry, trace=trace,
                                 obs=obs, resilience=resilience,
                                 metrics=metrics, health=health,
                                 pinned=test_obs.TestMetricsPins.PINNED_KEYS)


def _drive_registry(reg):
    reg.counter("serve.requests").inc(3)
    reg.counter("serve.requests").inc()
    reg.gauge("data.async_iterator.queue_depth").set(2)
    res = reg.reservoir("lat.ms", window=8)
    for v in (5.0, 1.0, 9.5, 3.25, 7.0, 11.0, 2.0, 8.0, 4.0, 6.5):
        res.record(v)
    h = reg.histogram("ttft.ms", buckets=(1, 5, 10, 50))
    for v in (0.5, 2.0, 4.0, 7.5, 12.0, 60.0, 3.0):
        h.observe(v)
    return reg


def test_registry_exposition_equals_reference(J):
    ours = _drive_registry(treg.MetricsRegistry())
    ref = _drive_registry(J.registry.MetricsRegistry())
    for kw in ({}, {"namespace": "dl4j"}, {"namespace": "dl4j",
                                          "instance": "i0"}):
        assert ours.prometheus_text(**kw) == ref.prometheus_text(**kw)
    assert ours.snapshot() == ref.snapshot()
    assert ours.kind_snapshot() == ref.kind_snapshot()
    for q in (0.5, 0.9, 0.99):
        assert (ours.get("ttft.ms").quantile(q)
                == ref.get("ttft.ms").quantile(q))
    assert treg.fmt(1 / 3, 4) == J.registry.fmt(1 / 3, 4)
    with pytest.raises(TypeError):
        ours.gauge("serve.requests")      # a counter's name: kind conflict


def _drive_tracer(tracer):
    tracer.emit("serve.queue_wait", 1_000_000, 250_000, cat="serve",
                track="req-0", trace_id=0)
    tracer.emit("serve.batch", 1_250_000, 500_000, cat="serve",
                track="server", args={"bucket": 2, "n_real": 1})
    tracer.emit("serve.dispatch", 1_300_000, 400_000, cat="serve",
                track="server", args={"bucket": 2})
    tracer.emit("serve.request", 1_000_000, 800_000, cat="serve",
                track="req-0", trace_id=0)
    tracer.emit("train.dispatch", 3_000_000, 1_000_000, cat="train")
    return tracer


def _events(chrome):
    # the clock_sync metadata carries this process's wall clock
    return [e for e in chrome["traceEvents"] if e["name"] != "clock_sync"]


def test_trace_events_and_decomposition_equal_reference(J):
    ours = _drive_tracer(ttrace.Tracer(enabled=True, instance="srv"))
    ref = _drive_tracer(J.trace.Tracer(enabled=True, instance="srv"))
    assert ([tuple(s) for s in ours.spans()]
            == [tuple(s) for s in ref.spans()])
    assert (_events(ours.chrome_trace(pid=3))
            == _events(ref.chrome_trace(pid=3)))
    assert (tobs.decompose(ours.chrome_trace())
            == J.obs.decompose(ref.chrome_trace()))
    assert (tobs.decompose_requests(ours.spans())
            == J.obs.decompose_requests(ref.spans()))
    # disabled: nothing recorded, and the span is the shared no-op
    off = ttrace.Tracer()
    with off.span("x"):
        pass
    assert off.spans() == [] and not tobs.TRACER.enabled


def test_flight_recorder_arms_as_reference(J):
    got = []
    for mod in (ttrace, J.trace):
        tracer = mod.Tracer()
        fr = mod.FlightRecorder(tracer, threshold_ms=50.0, capture_spans=2,
                                min_samples=4)
        for v in (1.0, 2.0, 1.5, 2.5, 80.0):
            fr.observe(v)
        got.append((tracer.enabled, fr.rolling_p99()))
    assert got[0] == got[1]


def _drive_metrics(m):
    for i in range(20):
        m.record_request(float(i), queue_wait_ms=i / 4,
                         deadline_met=(i % 3 != 0) if i % 2 else None)
    m.record_batch(3, 4, 2)
    m.record_batch(8, 8, 5)
    m.record_queue_depth(7)
    m.count("shed_queue_full")
    m.count("swaps")
    m.record_slo_miss()
    m.record_ttft(12.5)
    m.record_inter_token(3.0)
    return m


def test_serving_metrics_keys_and_snapshot_equal_reference(J):
    ours = _drive_metrics(tmetrics.ServingMetrics(window=8, name="srv",
                                                  slo_target_ms=10.0))
    ref = _drive_metrics(J.metrics.ServingMetrics(window=8, name="srv",
                                                  slo_target_ms=10.0))
    snap = ours.snapshot()
    assert snap == ref.snapshot()
    assert set(J.pinned) <= set(snap)
    assert ours.kind_snapshot() == ref.kind_snapshot()
    assert (tmetrics.slo_view(snap, throughput=100.0)
            == J.metrics.slo_view(ref.snapshot(), throughput=100.0))
    assert tmetrics.shed_view(snap) == J.metrics.shed_view(ref.snapshot())


def test_metrics_snapshot_shape():
    """The reference's own pin (tests/test_serving.py), on the port."""
    m = tmetrics.ServingMetrics(window=8)
    for i in range(20):
        m.record_request(float(i))
    m.record_batch(3, 4, 2)
    snap = m.snapshot()
    assert snap["completed"] == 20
    # bounded reservoir: percentiles over the LAST 8 samples
    assert snap["latency_ms_p50"] >= 12.0
    assert snap["queue_depth_max"] == 2
    assert snap["batch_occupancy_mean"] == 0.75


def test_retry_policy_and_fault_injector_equal_reference(J):
    got = []
    for mod in (tres, J.resilience):
        rp = mod.RetryPolicy(max_retries=4, base_delay=0.01, seed=5,
                             sleep=lambda s: None)
        delays = [rp.delay(a) for a in range(6)]
        inj = (mod.FaultInjector(seed=3)
               .plan("serve.batch", on_calls=(1, 3), exc=mod.FaultInjected)
               .plan("serve.request", prob=0.5, times=4, corrupt="nan"))
        fired = []
        for i in range(8):
            try:
                inj.fire("serve.batch")
                fired.append("ok")
            except mod.FaultInjected:
                fired.append("fault")
            p = inj.fire("serve.request", payload=np.ones(3, np.float32))
            fired.append(bool(np.isnan(p).any()))
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("transient")
            return "done"

        result = rp.call(flaky)
        budget = mod.RetryBudget(capacity=2, refill_fraction=0.5)
        taken = [budget.take() for _ in range(3)]
        budget.on_success(2)
        got.append((delays, fired, inj.calls("serve.batch"),
                    inj.fired("serve.request"), result, len(calls), taken,
                    budget.tokens))
    assert got[0] == got[1]


def test_rowwise_finite_equals_reference(J):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 3, 4)).astype(np.float32)
    a[1, 2, 0] = np.nan
    b = rng.standard_normal((6, 5))
    b[4, 1] = np.inf
    ids = np.arange(6, dtype=np.int32)
    for tree in ([a], [a, b], [b, ids], {"y": a, "z": [b]}):
        np.testing.assert_array_equal(thealth.rowwise_finite(tree),
                                      J.health.rowwise_finite(tree))
    # tensors, bf16 included (widened to f32, exactly)
    t = torch.from_numpy(a).to(torch.bfloat16)
    np.testing.assert_array_equal(thealth.rowwise_finite([t, b]),
                                  J.health.rowwise_finite([a, b]))


def test_port_stdlib_modules_import_only_stdlib():
    """obs/, common/resilience.py and serving/metrics.py stay stdlib-only,
    as the reference's (publishing a metric can never touch a device)."""
    allowed_pkgs = {"bisect", "collections", "re", "threading", "datetime",
                    "json", "time", "logging", "random", "itertools",
                    "__future__"}
    files = sorted((PORT / "obs").glob("*.py")) + [
        PORT / "common" / "resilience.py", PORT / "serving" / "metrics.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module.split(".")[0]]
            else:
                continue
            assert set(names) <= allowed_pkgs, (f.name, names)


# ---------------------------------------------------------------------------
# card_numerics under concurrent callers
# ---------------------------------------------------------------------------

def _flags():
    return (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def caller_flags():
    saved = _flags()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield _flags()
    (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _interleave(order, scopes):
    """Run each thread's card_numerics scope on its own thread, entering and
    leaving in `order` (a list of (thread, "in" | "out")); returns the
    flags seen after each step."""
    cuda = torch.device("cuda")
    go = {k: threading.Event() for k in order}
    done = {k: threading.Event() for k in order}
    seen = []

    def run(name):
        go[(name, "in")].wait(10)
        with card_numerics(cuda, scopes[name]):
            done[(name, "in")].set()
            go[(name, "out")].wait(10)
        done[(name, "out")].set()

    threads = [threading.Thread(target=run, args=(n,)) for n in scopes]
    for t in threads:
        t.start()
    for k in order:
        go[k].set()
        assert done[k].wait(10)
        seen.append(_flags())
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    return seen


OFF = (True, False, False)       # benchmark on, TF32 off
BF16 = (True, True, True)        # benchmark on, the caller's TF32


def test_card_numerics_two_threads_keep_tf32_off_under_f32(caller_flags):
    """A bf16 scope enters, an f32 scope enters, the bf16 one leaves while
    the f32 one is open: TF32 must stay off. (PR 7's version restored the
    flags the bf16 scope saw on entry, TF32 on, under the f32 call.)"""
    seen = _interleave([("b", "in"), ("a", "in"), ("b", "out"),
                        ("a", "out")],
                       {"a": torch.float32, "b": torch.bfloat16})
    assert seen == [BF16, OFF, OFF, caller_flags]
    assert _flags() == caller_flags


def test_card_numerics_two_threads_restore_the_caller(caller_flags):
    """An f32 scope enters, a bf16 scope enters, the f32 one leaves first:
    the caller's flags come back when the last scope leaves. (PR 7's
    version restored the stale tuple the bf16 scope saw, TF32 off.)"""
    seen = _interleave([("a", "in"), ("b", "in"), ("a", "out"),
                        ("b", "out")],
                       {"a": torch.float32, "b": torch.bfloat16})
    assert seen == [OFF, OFF, BF16, caller_flags]
    assert _flags() == caller_flags


def test_card_numerics_many_threads_restore_the_caller(caller_flags):
    """Eight threads enter and leave f32 and bf16 scopes in random order,
    with the interpreter switching threads every microsecond: TF32 is
    never on inside an f32 scope, and the caller's flags come back."""
    cuda = torch.device("cuda")
    bad = []
    barrier = threading.Barrier(8)

    def worker(i):
        rng = np.random.default_rng(i)
        barrier.wait(10)
        for _ in range(300):
            dt = torch.float32 if rng.random() < 0.5 else torch.bfloat16
            with card_numerics(cuda, dt):
                if dt == torch.float32 and (torch.backends.cudnn.allow_tf32
                                            or torch.backends.cuda.matmul
                                            .allow_tf32):
                    bad.append(i)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert not bad
    assert _flags() == caller_flags


@pytest.mark.parametrize("ask", ["cudnn", "torch"])
def test_card_numerics_keeps_the_search_off_for_deterministic_callers(
        caller_flags, ask):
    """A caller who asked for deterministic algorithms gets cuDNN's
    heuristics, which resolve alike in every process, not its timed search;
    TF32 is still off under f32, and the caller's flags come back."""
    det = torch.backends.cudnn.deterministic
    algorithms = torch.are_deterministic_algorithms_enabled()
    if ask == "cudnn":
        torch.backends.cudnn.deterministic = True
    else:
        torch.use_deterministic_algorithms(True)
    try:
        with card_numerics(torch.device("cuda"), torch.float32):
            assert _flags() == (False, False, False)
        with card_numerics(torch.device("cuda"), torch.bfloat16):
            assert _flags() == caller_flags
        assert _flags() == caller_flags
    finally:
        torch.backends.cudnn.deterministic = det
        torch.use_deterministic_algorithms(algorithms)
    with card_numerics(torch.device("cuda"), torch.float32):
        assert _flags() == OFF


def test_card_numerics_is_a_no_op_off_the_card(caller_flags):
    with card_numerics(torch.device("cpu"), torch.float32):
        assert _flags() == caller_flags
