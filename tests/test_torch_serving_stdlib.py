"""The port's copies of the reference's stdlib serving modules
(serving/kvpool.py, admission.py, kvstate.py, loadgen.py) against the
originals: the same inputs give the same decisions and the same bytes.

  * `BlockPool`: seeded admit/commit/cow/release churn (shared prefixes,
    two tags) gives the same allocation sequence in both packages, and the
    invariants hold after every operation.
  * `ServiceRateEstimator`, `AdmissionController` and `BrownoutPolicy`
    decide the same on a scripted timeline.
  * `loadgen`: `Schedule.digest()` and `ChaosSchedule.digest()` are
    byte-identical for the same seed, for every process and mix.
  * `kvstate`: each package reads the other's artifact bytes and files.
  * `run_load` drives the port's ContinuousDecodeServer.
"""
import numpy as np
import pytest

from deeplearning4j_tpu_torch.serving import admission as PA
from deeplearning4j_tpu_torch.serving import kvpool as PK
from deeplearning4j_tpu_torch.serving import kvstate as PS
from deeplearning4j_tpu_torch.serving import loadgen as PL


@pytest.fixture(scope="module")
def J():
    """The reference's four modules (they import no JAX themselves, but
    their package does)."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.serving import admission, kvpool, kvstate, loadgen
    return {"admission": admission, "kvpool": kvpool, "kvstate": kvstate,
            "loadgen": loadgen}


def _churn(mod, seed, n_ops=250):
    """Seeded churn through one package's BlockPool; the trace of every
    allocation decision and of the pool's counts."""
    rng = np.random.default_rng(seed)
    pool = mod.BlockPool(24, 4, prefix_cache=seed % 3 != 2)
    prefixes = [tuple(rng.integers(1, 9, 8).tolist()) for _ in range(2)]
    live, trace = [], []
    for _ in range(n_ops):
        op = rng.random()
        if live and (op < 0.45 or len(live) >= 8):
            alloc = live.pop(int(rng.integers(0, len(live))))
            if alloc.cow is not None and rng.random() < 0.5:
                trace.append(("cow", pool.cow(alloc)))
            pool.release(alloc)
            trace.append(("release", pool.blocks_in_use, pool.blocks_free))
        else:
            base = list(prefixes[int(rng.integers(0, 2))])
            prompt = base[:int(rng.integers(1, 9))] + \
                rng.integers(1, 9, int(rng.integers(0, 4))).tolist()
            rows = len(prompt) + int(rng.integers(0, 12))
            tag = int(rng.integers(0, 2))
            alloc = pool.admit(prompt, rows, will_append=rows > len(prompt),
                               tag=tag)
            if alloc is None:
                trace.append(("blocked",))
            else:
                pool.commit(alloc)
                live.append(alloc)
                trace.append(("admit", list(alloc.ids), alloc.shared_rows,
                              alloc.n_shared, alloc.cow,
                              pool.writable_rows(alloc),
                              pool.match_prefix(prompt, tag=tag)[1]))
        pool.check()
    for alloc in live:
        pool.release(alloc)
    pool.check()
    trace.append(("end", pool.blocks_in_use, pool.blocks_free))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_block_pool_churn_same_allocation_sequence(J, seed):
    want = _churn(J["kvpool"], seed)
    got = _churn(PK, seed)
    assert got == want
    assert got[-1] == ("end", 0, 24)
    if seed % 3 != 2:                                    # prefix hits ran
        assert any(t[0] == "admit" and t[2] for t in got)


def _timeline(mod):
    """A scripted admission timeline: iterations observed (a compile
    outlier, idle passes, fused fan-out), predictions and shed decisions
    at several backlogs, errors fed back; every output in order."""
    est = mod.ServiceRateEstimator(slots=4, min_samples=4, window=16)
    ctl = mod.AdmissionController(conservatism=1.3, min_samples=4)
    ctl.estimator.slots = 4
    out = []
    samples = [(0, 0.004, 0), (4, 2.0, 4)] + [
        (n, dt, n) for n, dt in ((4, 0.010), (3, 0.011), (4, 0.009),
                                 (2, 0.012), (4, 0.010), (1, 0.008))] + [
        (0, 0.02, 0), (4, 0.0105, 4)] * 3
    for tokens, dt, active in samples:
        for e in (est, ctl.estimator):
            e.observe(tokens, dt, active)
        out.append((est.ready, est.seconds_per_iteration,
                    est.tokens_per_second,
                    est.tokens_per_slot_conservative,
                    est.delivered_tokens_per_second,
                    est.predict_seconds(40, 12)))
        for backlog, own, budget in ((0, 8, 0.5), (120, 20, 0.3),
                                     (400, 40, 1.5)):
            out.append((ctl.predict_seconds(backlog, own),
                        ctl.should_shed(backlog, own, budget),
                        ctl.should_shed(backlog, own, budget, strict=True)))
    for err in (-0.05, 0.02, -0.2, 0.01, -0.01):
        ctl.observe_error(err)
        out.append((ctl.bias_seconds(), ctl.predict_seconds(100, 10)))
    return out


def test_estimator_and_controller_decide_the_same(J):
    assert _timeline(PA) == _timeline(J["admission"])


def _brownout(mod):
    pol = mod.BrownoutPolicy(
        classes={"interactive": (1.01, 1.01), "batch": (0.5, 0.9),
                 "bulk": (0.2, 0.6)},
        min_attainment=0.8)
    out = []
    for klass in ("interactive", "batch", "bulk", "default"):
        for frac in (0.0, 0.19, 0.2, 0.5, 0.59, 0.6, 0.9, 1.0):
            for att in (None, 1.0, 0.85, 0.79, 0.0):
                out.append(pol.decide(klass, frac, att))
        for other in ("interactive", "batch", "bulk", "default"):
            out.append(pol.may_preempt(klass, other))
    return out


def test_brownout_policy_decides_the_same(J):
    got = _brownout(PA)
    assert got == _brownout(J["admission"])
    assert {PA.ACCEPT, PA.DEFER, PA.SHED} <= set(got)


def _schedules(mod):
    procs = [mod.PoissonProcess(40.0), mod.OnOffProcess(200.0, 0.2, 0.5),
             mod.ClosedLoop(6)]
    mixes = [mod.DecodeSizeMix(((0.7, (3, 16), (4, 44), "interactive"),
                                (0.3, (20, 60), (30, 90), "batch")),
                               vocab=96),
             mod.SharedPrefixMix(n_prefixes=4, prefix_blocks=(16, 32),
                                 block_size=16, seed=3),
             mod.InferenceSizeMix(5)]
    out = [mod.build_schedule(p, m, 64, seed=s).digest()
           for p in procs for m in mixes for s in (0, 7)]
    out.append(mod.build_chaos_schedule(30.0, 12, seed=5).digest())
    return out


def test_loadgen_digests_byte_identical(J):
    got = _schedules(PL)
    assert got == _schedules(J["loadgen"])
    assert len(set(got)) == len(got)


def _artifacts(mod):
    rng = np.random.default_rng(0)
    panels = lambda rows, dt: [
        (rng.standard_normal((rows, 2, 16)).astype(dt),
         rng.standard_normal((rows, 2, 16)).astype(dt)) for _ in range(2)]
    req = mod.RequestArtifact([5, 9, 2, 7], [11, 3, 8], max_new=9,
                              tag="abc123", block_size=4,
                              panels=panels(6, np.float32), klass="batch",
                              trace={"trace_id": "i0-7"})
    pre = mod.PrefixCacheArtifact("abc123", 4, [
        ((1, 2, 3, 4), panels(4, np.float16)),
        ((1, 2, 3, 4, 5, 6, 7, 8), panels(4, np.float16))])
    return req, pre


def _same_request(a, b):
    assert (a.prompt, a.generated, a.max_new, a.tag, a.block_size,
            a.klass, a.trace) == (b.prompt, b.generated, b.max_new, b.tag,
                                  b.block_size, b.klass, b.trace)
    for (ka, va), (kb, vb) in zip(a.panels, b.panels):
        assert ka.dtype == kb.dtype
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(va, vb)


def _same_prefix(a, b):
    assert (a.tag, a.block_size) == (b.tag, b.block_size)
    assert [k for k, _ in a.entries] == [k for k, _ in b.entries]
    for (_, pa), (_, pb) in zip(a.entries, b.entries):
        for (ka, va), (kb, vb) in zip(pa, pb):
            np.testing.assert_array_equal(ka, kb)
            np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_kvstate_artifacts_read_across_packages(J, tmp_path, direction):
    src, dst = ((J["kvstate"], PS) if direction == "port_reads_jax"
                else (PS, J["kvstate"]))
    req, pre = _artifacts(src)
    assert req.to_bytes() == _artifacts(dst)[0].to_bytes()
    _same_request(dst.RequestArtifact.from_bytes(req.to_bytes()), req)
    _same_prefix(dst.PrefixCacheArtifact.from_bytes(pre.to_bytes()), pre)
    req.save(str(tmp_path / "req"))
    pre.save(str(tmp_path / "pre"))
    assert dst.artifact_kind(str(tmp_path / "req")) == "request"
    assert dst.artifact_kind(str(tmp_path / "pre")) == "prefix_cache"
    _same_request(dst.RequestArtifact.load(str(tmp_path / "req")), req)
    _same_prefix(dst.PrefixCacheArtifact.load(str(tmp_path / "pre")), pre)
    with pytest.raises(dst.KVStateError):
        dst.PrefixCacheArtifact.from_bytes(req.to_bytes())


def test_run_load_drives_the_port_server():
    from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import ContinuousDecodeServer
    lm = TransformerLM(96, d_model=32, n_heads=2, n_layers=2, max_len=64,
                       seed=0, device="cpu")
    sched = PL.build_schedule(
        PL.PoissonProcess(400.0),
        PL.SharedPrefixMix(n_prefixes=2, prefix_blocks=(1, 2), block_size=8,
                           suffix=(1, 5), new=(2, 8), seed=1), 16, seed=2)
    with ContinuousDecodeServer(lm, slots=4, prompt_buckets=(16, 32),
                                paged=True, block_size=8) as srv:
        out = PL.run_load(srv, sched, result_timeout=60)
        assert srv._pool.check() and srv.metrics.snapshot().get(
            "prefix_rows_hit", 0) > 0
    assert out["completed"] == 16 and out["failed"] == 0
    assert out["schedule"]["digest"] == sched.digest()
