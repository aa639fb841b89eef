"""The port's FleetManager (serving/fleet.py) and the decode server's
fleet verbs, `kill` and `drain` (serving/decode.py).

  * `kill` and `drain` against the JAX package's: the same workload on
    the same weights, in both cache layouts; the same futures fail with
    the same error types, the same requests come back as artifacts or as
    replay specs, the specs are equal, and a port-drained artifact
    resumes on the reference's server (and the reverse) to the
    uninterrupted stream.
  * The reference's own pins, rebuilt on the port: the bodies of
    tests/test_fleet_manager.py (router, zero added dispatches, crash
    survival, the drain seam, the autoscale loop, canary rollout, the
    tombstone lock discipline) and tests/test_fleet_containment.py
    (poison-pill quarantine, the spawn breaker, the retry budget) run
    against the port's classes. The model is the reference's toy
    TransformerLM(64, d_model=16, n_heads=2, n_layers=1, max_len=64), its
    weights drawn by the JAX package and moved with `from_jax_params`.
    Where a reference body leaned on wall-clock windows (a breaker
    backoff that a slow tick could outlive), the window is widened; no
    test asserts a wall-clock bound, and every wait names what it waited
    for.
"""
import concurrent.futures as cf
import functools
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common.resilience import (RetryBudget,
                                                        RetryBudgetExhaustedError,
                                                        FaultInjector,
                                                        RetryPolicy)
from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
from deeplearning4j_tpu_torch.obs.fleet import AutoscaleSignal, FleetView
from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                              FleetManager, PoisonPillError,
                                              ReplicaDeadError,
                                              RequestDrainedError,
                                              RequestMigratedError,
                                              ServerClosedError,
                                              ServerOverloadedError,
                                              ServingMetrics, fold_records,
                                              replay_journal)
from deeplearning4j_tpu_torch.serving.admission import BrownoutPolicy
from deeplearning4j_tpu_torch.serving.fleet import (BREAKER_CLOSED,
                                                    BREAKER_OPEN)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@functools.lru_cache(maxsize=None)
def jax_weights(seed):
    """(aux, blocks) as numpy of the JAX package's toy model
    (tests/test_fleet_manager.py's `_lm`)."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.models.zoo.transformer import TransformerLM as J
    j = J(64, d_model=16, n_heads=2, n_layers=1, max_len=64, seed=seed)
    return jax.tree.map(np.asarray, (j.aux, j.blocks))


def _lm(seed=3):
    """The reference's toy model on the port (CPU), weights moved from
    the JAX package."""
    aux, blocks = jax_weights(seed)
    return TransformerLM.from_jax_params(aux, blocks, 2, device="cpu")


def _factory(lm, **kw):
    def make(name):
        return ContinuousDecodeServer(
            lm, slots=2, prompt_buckets=(8, 16),
            metrics=ServingMetrics(name=name), instance=name, **kw)
    return make


def _warm(mgr, prompt=(1, 2, 3)):
    """Run each replica's programs once before the measured work."""
    for name in mgr.replicas:
        mgr.replica(name).generate(list(prompt), 2, timeout=120)


def _wait(pred, timeout=30.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.002)
    raise TimeoutError(f"never reached: {msg}")


# ---------------------------------------------------------------------------
# kill and drain against the JAX package's server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    """The reference's server class, artifact class and toy model."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.models.zoo.transformer import TransformerLM as J
    from deeplearning4j_tpu.serving import ContinuousDecodeServer as JS
    from deeplearning4j_tpu.serving import RequestArtifact as JA
    from deeplearning4j_tpu.serving import ServingMetrics as JM
    from deeplearning4j_tpu.common.resilience import FaultInjector as JF
    return {"S": JS, "A": JA, "M": JM, "F": JF,
            "lm": J(64, d_model=16, n_heads=2, n_layers=1, max_len=64,
                    seed=3)}


_LAYOUTS = {"fixed": {}, "paged": dict(paged=True, block_size=4,
                                       n_blocks=40)}


def _kind(fut):
    return type(fut.exception(0)).__name__


def _kill_scenario(S, M, lm, layout):
    """Two in flight, two queued, then kill(); a second server is killed
    from a done callback on its own serve thread."""
    srv = S(lm, slots=2, prompt_buckets=(8,), metrics=M(name="k"),
            instance="k", **_LAYOUTS[layout]).start()
    srv.generate([1, 2, 3], 2, timeout=120)
    futs = [srv.submit([1, 2, 3], 40) for _ in range(4)]
    srv.kill()
    srv.kill()                                  # idempotent
    kinds = [_kind(f) for f in futs]
    out = {"kinds": kinds, "alive": srv.alive}
    try:
        srv.start()
    except Exception as e:   # noqa: BLE001 - the refusal's type is pinned
        out["restart"] = type(e).__name__
    srv2 = S(lm, slots=2, prompt_buckets=(8,), metrics=M(name="c"),
             instance="c", **_LAYOUTS[layout]).start()
    srv2.generate([1, 2, 3], 2, timeout=120)
    first = srv2.submit([1, 2, 3], 2)
    first.add_done_callback(lambda _f: srv2.kill())
    second = srv2.submit([4, 5, 6], 40)
    first_len = len(first.result(120))
    exc = second.exception(30)
    out["callback"] = (first_len,
                       "completed" if exc is None else type(exc).__name__)
    _wait(lambda: not srv2.alive, msg="callback-killed server dead")
    out["failed"] = srv.metrics.count_value("failed")
    return out


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_kill_resolves_futures_like_the_reference(ref, layout):
    port = _kill_scenario(ContinuousDecodeServer, ServingMetrics, _lm(),
                          layout)
    jref = _kill_scenario(ref["S"], ref["M"], ref["lm"], layout)
    assert port == jref
    assert port["kinds"] == ["ReplicaDeadError"] * 4
    assert port["restart"] == "ServerClosedError"
    assert port["callback"] == (5, "ReplicaDeadError")
    assert port["alive"] is False


def _drain_scenario(S, M, F, lm, layout, migrate=None):
    """A decode-phase request, a prefilling one (chunked prefill, paced
    dispatches) and a queued one, then drain(): (outcome per request,
    artifacts, specs)."""
    inj = F()
    srv = S(lm, slots=2, prompt_buckets=(8, 16), chunked_prefill=2,
            fault_injector=inj, metrics=M(name="a"), instance="a",
            **_LAYOUTS[layout]).start()
    srv.generate([1, 2], 2, timeout=120)
    fa = srv.submit([1, 2], 12)
    _wait(lambda: any(r is not None and r.future is fa
                      and r.pf_next is None and r.generated
                      for r in srv._slot_req), msg="request A decoding")
    inj.plan("serve.batch", prob=1.0, times=500, delay=0.05, exc=None)
    fb = srv.submit(list(range(1, 15)), 6)
    _wait(lambda: any(r is not None and r.pf_next is not None
                      for r in srv._slot_req), msg="request B prefilling")
    fc = srv.submit([3, 4, 5], 8)
    migrated, replayed = srv.drain(migrate=migrate)
    order = {fa: "a", fb: "b", fc: "c"}
    outcome = {order[f]: ("migrated", _kind(f)) for f, _ in migrated}
    outcome.update({order[f]: ("replayed", _kind(f)) for f, _ in replayed})
    specs = {order[f]: dict(spec, deadline=None) for f, spec in replayed}
    arts = {order[f]: art for f, art in migrated}
    return outcome, arts, specs, srv.alive


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_drain_hands_off_like_the_reference(ref, layout):
    lm = _lm()
    port = _drain_scenario(ContinuousDecodeServer, ServingMetrics,
                           FaultInjector, lm, layout)
    jref = _drain_scenario(ref["S"], ref["M"], ref["F"], ref["lm"],
                           layout)
    assert port[0] == jref[0]
    assert port[2] == jref[2]
    assert port[3] is jref[3] is False
    want = {"a": ("migrated", "RequestMigratedError")} if layout == \
        "paged" else {"a": ("replayed", "RequestDrainedError")}
    want.update(b=("replayed", "RequestDrainedError"),
                c=("replayed", "RequestDrainedError"))
    assert port[0] == want
    if layout != "paged":
        return
    # each package's artifact resumes on the other's server to the
    # uninterrupted stream
    from deeplearning4j_tpu_torch.serving import RequestArtifact
    solo = list(lm.generate([1, 2], 12))
    kw = dict(slots=2, prompt_buckets=(8, 16), **_LAYOUTS["paged"])
    for S, art in ((ref["S"], ref["A"].from_bytes(port[1]["a"].to_bytes())),
                   (ContinuousDecodeServer,
                    RequestArtifact.from_bytes(jref[1]["a"].to_bytes()))):
        model = ref["lm"] if S is ref["S"] else lm
        with S(model, **kw) as dst:
            assert list(dst.migrate_in(art).result(120)) == solo


@pytest.mark.parametrize("mode", ["speculative", "preempting"])
def test_drain_hands_off_speculative_and_preempting_servers(mode):
    """drain() on the modes that hold extra state: a speculative server's
    rejected suffix rows never leave in an artifact, and a preempted
    request parked on the resume line leaves as its own artifact. Every
    handed-off request resumes (or replays) to its solo stream."""
    from deeplearning4j_tpu_torch.serving import NGramDraft, Speculator
    lm = _lm()
    kw = dict(paged=True, block_size=4, slots=2, prompt_buckets=(8,))
    if mode == "speculative":
        extra = dict(n_blocks=40, speculate=Speculator(NGramDraft(n=2), k=4))
        work = [([1, 2, 1, 2, 1], 30, "default"), ([3, 4, 3, 4], 30,
                                                   "default"),
                ([5, 6, 7], 10, "default")]
    else:
        extra = dict(n_blocks=10, preempt=True, brownout=BrownoutPolicy(
            classes={"batch": (0.9, 1.01)}))
        work = [([1, 2, 3, 4, 5, 6], 26, "batch"),
                ([7, 8, 9], 20, "interactive"),
                ([9, 8, 7], 20, "interactive")]
    srv = ContinuousDecodeServer(lm, **kw, **extra).start()
    srv.generate([1, 2], 2, timeout=120)
    futs = [srv.submit(list(p), n, klass=k) for p, n, k in work[:1]]
    _wait(lambda: any(r is not None and len(r.generated) >= 3
                      for r in srv._slot_req), msg="the first decoding")
    futs += [srv.submit(list(p), n, klass=k) for p, n, k in work[1:]]
    if mode == "preempting":
        _wait(lambda: srv.metrics.count_value("preempted") >= 1,
              msg="the batch request preempted")
    else:
        _wait(lambda: srv.metrics.count_value("spec_verify_dispatches") > 0
              or srv.metrics.count_value("dispatches") > 4,
              msg="speculative dispatches")
    migrated, replayed = srv.drain()
    assert {f for f, _ in migrated} | {f for f, _ in replayed} <= set(futs)
    assert migrated
    with ContinuousDecodeServer(lm, n_blocks=40, **kw) as dst:
        for f, art in migrated:
            p, n, _ = work[futs.index(f)]
            assert len(art.panels[0][0]) == len(p) + len(art.generated) - 1
            assert list(dst.migrate_in(art).result(120)) == \
                list(lm.generate(list(p), n))
        for f, spec in replayed:
            assert list(dst.submit(spec["prompt"], spec["max_new"]).result(
                120)) == list(lm.generate(spec["prompt"], spec["max_new"]))
    for f in futs:
        if f not in {g for g, _ in migrated} | {g for g, _ in replayed}:
            f.result(0)                 # finished before the drain


@pytest.mark.parametrize("mod", ["port", "ref"])
def test_drain_migrate_true_refused_on_fixed_slot_in_both(ref, mod):
    S, lm = ((ContinuousDecodeServer, _lm()) if mod == "port"
             else (ref["S"], ref["lm"]))
    srv = S(lm, slots=2, prompt_buckets=(8,)).start()
    try:
        with pytest.raises(ValueError, match="requires paged=True"):
            srv.drain(migrate=True)
    finally:
        srv.stop(timeout=60)


# ---------------------------------------------------------------------------
# (a) router
# ---------------------------------------------------------------------------
class TestRouter:
    def test_least_backlog_prefers_idle_replica(self):
        lm = _lm()
        with FleetManager(_factory(lm), n_replicas=2) as mgr:
            _warm(mgr)
            # two long streams pin i0 then i1; the third breaks the
            # tie by spawn order back onto i0
            futs = [mgr.submit([1, 2, 3], 24) for _ in range(3)]
            names = mgr.replicas
            [f.result(120) for f in futs]
            recv = {n: mgr.replica(n).metrics.count_value("received")
                    for n in names}
            # warm-up added 1 to each; the routed split is 2 / 1
            assert recv[names[0]] == 3 and recv[names[1]] == 2

    def test_round_robin_fleet_adds_zero_dispatches_vs_bare_servers(self):
        """The acceptance A/B: the same sequential workload through
        the managed fleet (round-robin policy, federation after every
        request) and through N bare servers — per-replica dispatch and
        token counters IDENTICAL, results bit-identical. The control
        plane observes the schedule, never alters it."""
        prompts = [[1 + i, 2, 3] for i in range(6)]
        counts = {}
        outs = {}
        lm = _lm()
        with FleetManager(_factory(lm), n_replicas=2,
                          policy="round_robin") as mgr:
            res = []
            for p in prompts:
                res.append(mgr.generate(p, 5, timeout=120))
                mgr.fleet_snapshot()        # federate every request
                mgr.control_tick()          # health probe every request
            names = mgr.replicas
            counts["fleet"] = [
                (mgr.replica(n).metrics.count_value("dispatches"),
                 mgr.replica(n).metrics.count_value("tokens_out"))
                for n in names]
            outs["fleet"] = res
        bare = [ContinuousDecodeServer(lm, slots=2,
                                       prompt_buckets=(8, 16)).start()
                for _ in range(2)]
        try:
            res = [bare[i % 2].generate(p, 5, timeout=120)
                   for i, p in enumerate(prompts)]
            counts["bare"] = [
                (s.metrics.count_value("dispatches"),
                 s.metrics.count_value("tokens_out")) for s in bare]
            outs["bare"] = res
        finally:
            for s in bare:
                s.stop(timeout=120)
        assert counts["fleet"] == counts["bare"]
        assert [list(r) for r in outs["fleet"]] == \
            [list(r) for r in outs["bare"]]

    def test_replica_shed_propagates_to_caller(self):
        """A shed at the chosen replica is a fleet shed: the manager
        owns failover, the caller owns overload retry policy."""
        lm = _lm()
        with FleetManager(_factory(lm, max_queue=1), n_replicas=2) as mgr:
            _warm(mgr)
            futs, sheds = [], 0
            for _ in range(64):         # tiny queues fill fast
                try:
                    futs.append(mgr.submit([1, 2, 3], 30))
                except ServerOverloadedError:
                    sheds += 1
            assert sheds > 0            # the shed reached the caller
            for f in futs:              # admitted work all completes
                f.result(120)


# ---------------------------------------------------------------------------
# (b) crash survival
# ---------------------------------------------------------------------------
class TestCrashSurvival:
    def test_kill_fails_inflight_loudly_and_refuses_restart(self):
        lm = _lm()
        srv = ContinuousDecodeServer(lm, slots=2,
                                     prompt_buckets=(8,)).start()
        srv.generate([1, 2, 3], 2, timeout=120)     # warm
        futs = [srv.submit([1, 2, 3], 40) for _ in range(4)]
        srv.kill()
        for f in futs:
            with pytest.raises(ReplicaDeadError):
                f.result(30)
        assert not srv.alive
        with pytest.raises(ServerClosedError):
            srv.start()

    def test_injected_replica_death_under_load_zero_lost(self):
        """THE crash acceptance pin: a fault-injected replica death
        mid-stream loses zero requests — every admitted future
        resolves, and every resolved stream is bit-identical to a solo
        run (failover replays the prompt; deterministic greedy decode
        reproduces the exact stream)."""
        lm = _lm()
        prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
        refs = {tuple(p): list(lm.generate(p, 32)) for p in prompts}
        inj = FaultInjector()
        with FleetManager(_factory(lm), n_replicas=2,
                          fault_injector=inj) as mgr:
            _warm(mgr)
            futs = [mgr.submit(prompts[i % len(prompts)], 32)
                    for i in range(10)]
            # sever at the NEXT fleet.replica probe = death mid-stream
            inj.plan("fleet.replica", on_call=0, sever=True, exc=None)
            time.sleep(0.05)
            tick = mgr.control_tick()
            # the sever fires inside this tick's own probe pass, so
            # the SAME tick's floor check already backfills to min=2
            # (the autoscale loop backfilling capacity) — with a fresh
            # never-reused id
            assert tick["backfilled"] == 1
            assert tick["n_replicas"] == 2
            for i, f in enumerate(futs):
                out = f.result(120)
                assert list(out) == refs[tuple(prompts[i % len(prompts)])]
            snap = mgr.fleet_snapshot()
            assert snap["fleet_replica_dead"] == 1
            assert snap["fleet_failover_resubmitted"] >= 1

    def test_backfilled_replica_never_reuses_a_dead_name(self):
        lm = _lm()
        with FleetManager(_factory(lm), n_replicas=2) as mgr:
            first = list(mgr.replicas)
            mgr.kill_replica(first[0])
            mgr.control_tick()                  # backfill to min=2
            assert mgr.n_alive() == 2
            fresh = set(mgr.replicas) - set(first)
            assert fresh and not (fresh & set(first))
            assert mgr.states()[first[0]] == "dead"

    def test_no_survivors_fails_loudly(self):
        lm = _lm()
        mgr = FleetManager(_factory(lm), n_replicas=2, min_replicas=1)
        mgr.start()
        try:
            _warm(mgr)
            futs = [mgr.submit([1, 2, 3], 40) for _ in range(3)]
            for n in list(mgr.replicas):
                mgr.kill_replica(n)
            for f in futs:
                with pytest.raises(Exception) as ei:
                    f.result(30)
                assert isinstance(ei.value, ReplicaDeadError)
            with pytest.raises(ReplicaDeadError):
                mgr.submit([1, 2, 3], 4)
        finally:
            mgr.stop()


# ---------------------------------------------------------------------------
# (c) the drain seam
# ---------------------------------------------------------------------------
class TestDrainSeam:
    def test_drain_migrates_decode_replays_prefill_and_queued(self):
        """ONE drain verb: decode-phase slots leave as artifacts,
        PREFILLING slots and queued requests come back as replay
        specs (a half-written panel is never an artifact — the victim
        rule at the drain seam), and both re-land bit-identically on
        a second server."""
        lm = _lm()
        inj = FaultInjector()
        a = ContinuousDecodeServer(
            lm, slots=2, prompt_buckets=(8, 16), paged=True,
            block_size=4, chunked_prefill=2, fault_injector=inj,
            metrics=ServingMetrics(name="a"), instance="a").start()
        b = ContinuousDecodeServer(
            lm, slots=2, prompt_buckets=(8, 16), paged=True,
            block_size=4, chunked_prefill=2,
            metrics=ServingMetrics(name="b"), instance="b").start()
        try:
            a.generate([1, 2], 2, timeout=120)      # warm (one-shot)
            # decode-phase occupant: short prompt, one-shot prefill
            fa = a.submit([1, 2], 12)
            _wait(lambda: any(r is not None and r.pf_next is None
                              and r.future is fa
                              for r in a._slot_req),
                  msg="request A decoding")
            # slow every subsequent dispatch so B stays mid-prefill
            inj.plan("serve.batch", prob=1.0, times=500, delay=0.05,
                     exc=None)
            long_prompt = list(range(1, 15))        # 14 rows, C=2
            fb = a.submit(long_prompt, 6)
            _wait(lambda: any(r is not None and r.pf_next is not None
                              for r in a._slot_req),
                  msg="request B prefilling")
            fc = a.submit([3, 4, 5], 8)             # queued: slots full
            migrated, replayed = a.drain(migrate=True)
            assert not a.alive
            assert [f for f, _ in migrated] == [fa]
            assert {f for f, _ in replayed} == {fb, fc}
            assert isinstance(fa.exception(), RequestMigratedError)
            assert isinstance(fb.exception(), RequestDrainedError)
            assert isinstance(fc.exception(), RequestDrainedError)
            # re-land on B: migrate_in the artifact, resubmit the specs
            (_, art), = migrated
            out_a = b.migrate_in(art).result(120)
            assert list(out_a) == list(lm.generate([1, 2], 12))
            for _, spec in replayed:
                out = b.submit(spec["prompt"], spec["max_new"],
                               klass=spec["klass"]).result(120)
                ref = lm.generate(spec["prompt"], spec["max_new"])
                assert list(out) == list(ref)
            assert b.metrics.count_value("migrated") == 1
        finally:
            for s in (a, b):
                try:
                    s.stop(timeout=120)
                except Exception:   # noqa: BLE001 — already drained
                    pass

    def test_drain_nonpaged_replays_everything(self):
        lm = _lm()
        srv = ContinuousDecodeServer(lm, slots=2,
                                     prompt_buckets=(8,)).start()
        srv.generate([1, 2, 3], 2, timeout=120)
        futs = [srv.submit([1, 2, 3], 16) for _ in range(3)]
        migrated, replayed = srv.drain()
        assert migrated == []
        assert {f for f, _ in replayed} <= set(futs)
        for _, spec in replayed:
            assert spec["prompt"] == [1, 2, 3] and spec["max_new"] == 16

    def test_drain_migrate_true_refused_on_fixed_slot(self):
        lm = _lm()
        srv = ContinuousDecodeServer(lm, slots=2,
                                     prompt_buckets=(8,)).start()
        try:
            with pytest.raises(ValueError):
                srv.drain(migrate=True)
        finally:
            srv.stop(timeout=60)

    def test_scale_down_migrates_live_requests_bit_identical(self):
        """Manager-level drain: the drained replica's live
        decode-phase requests RESUME on survivors (the durable-KV
        bit-identity pin, exercised across the router)."""
        lm = _lm()
        with FleetManager(_factory(lm, paged=True, block_size=4),
                          n_replicas=2, min_replicas=1) as mgr:
            _warm(mgr)
            futs = [mgr.submit([1, 2, 3], 28) for _ in range(4)]
            names = mgr.replicas
            _wait(lambda: mgr.replica(names[1])
                  .metrics.count_value("tokens_out") > 2,
                  msg="second replica decoding")
            mgr.scale_down(names[1])
            ref = list(lm.generate([1, 2, 3], 28))
            for f in futs:
                assert list(f.result(120)) == ref
            snap = mgr.fleet_snapshot()
            assert snap["fleet_replica_drained"] == 1
            assert mgr.n_alive() == 1
            # at least one stream actually MIGRATED (vs replayed):
            # the survivor adopted its artifact
            survivor = mgr.replica(names[0])
            assert survivor.metrics.count_value("migrated") >= 1


# ---------------------------------------------------------------------------
# (d) the closed autoscale loop
# ---------------------------------------------------------------------------
class _ScriptedSignal:
    """Duck-typed AutoscaleSignal: scripted decisions, so actuation
    tests are timing-free."""

    def __init__(self, seq):
        self.seq = list(seq)
        self.decision = "hold"
        self.transitions = []
        self.resets = 0

    def observe(self, snapshot=None, **kw):
        self.decision = self.seq.pop(0) if self.seq else "hold"
        return self.decision

    def reset(self):
        self.resets += 1


class TestAutoscaleLoop:
    def test_acts_on_decisions_and_resets_signal(self):
        lm = _lm()
        sig = _ScriptedSignal(["scale_up", "hold", "scale_down"])
        with FleetManager(_factory(lm), n_replicas=2, signal=sig,
                          max_replicas=3) as mgr:
            t1 = mgr.control_tick()
            assert t1["acted"] == "scale_up" and t1["n_replicas"] == 3
            t2 = mgr.control_tick()
            assert t2["acted"] is None and t2["n_replicas"] == 3
            t3 = mgr.control_tick()
            assert t3["acted"] == "scale_down" and t3["n_replicas"] == 2
            assert sig.resets == 2          # one per ACTION, not per tick
            snap = mgr.fleet_snapshot()
            assert snap["fleet_replica_spawned"] == 3   # 2 initial + 1
            assert snap["fleet_replica_drained"] == 1

    def test_scale_capped_at_min_and_max(self):
        lm = _lm()
        sig = _ScriptedSignal(["scale_up", "scale_down"])
        with FleetManager(_factory(lm), n_replicas=2, min_replicas=2,
                          max_replicas=2, signal=sig) as mgr:
            assert mgr.control_tick()["acted"] is None
            assert mgr.control_tick()["acted"] is None
            assert mgr.n_alive() == 2

    def test_federation_monotone_across_churn(self):
        """One instance dies mid-window, another spawns: fleet
        counters stay MONOTONE (the dead replica's final counters
        tombstone into every later federation) and the fresh replica
        never aliases the dead one's name."""
        lm = _lm()
        with FleetManager(_factory(lm), n_replicas=2) as mgr:
            _warm(mgr)
            for i in range(4):
                mgr.generate([1 + i, 2, 3], 4, timeout=120)
            snap1 = mgr.fleet_snapshot()
            victim = mgr.replicas[0]
            mgr.kill_replica(victim)
            mgr.control_tick()              # backfill spawns a fresh id
            for i in range(2):
                mgr.generate([1 + i, 2, 3], 4, timeout=120)
            snap2 = mgr.fleet_snapshot()
            assert snap2["fleet_tokens_out"] >= snap1["fleet_tokens_out"]
            assert snap2["fleet_sheds_total"] >= snap1["fleet_sheds_total"]
            assert victim in snap2["instances"]     # tombstoned, not
            #                                         vanished
            assert len(set(snap2["instances"])) == \
                len(snap2["instances"])             # no aliasing
            # the tombstone carries counters ONLY: its stale gauges
            # must not haunt the live capacity estimate
            fv = mgr.fleet_view()
            assert fv.gauge_view("service_rate_tokens_per_sec")[
                "per_instance"].get(victim) is None

    def test_autoscale_signal_reset_reenters_warmup(self):
        sig = AutoscaleSignal(window=4, hysteresis=1, min_shed_rate=1)
        sheds = 0
        for i in range(6):
            sheds += 10
            sig.observe(sheds=sheds, service_rate=100.0, occupancy=0.9)
        assert sig.decision == AutoscaleSignal.SCALE_UP
        sig.reset()
        assert sig.decision == AutoscaleSignal.HOLD
        for i in range(3):                  # part-window: never acts
            sheds += 10
            assert sig.observe(sheds=sheds, service_rate=100.0,
                               occupancy=0.9) == AutoscaleSignal.HOLD


# ---------------------------------------------------------------------------
# (e) canary rollout
# ---------------------------------------------------------------------------
class TestCanaryRollout:
    def test_poisoned_params_roll_back_before_any_request(self):
        lm = _lm()
        bad = _lm(seed=9)
        with torch.no_grad():
            bad.aux.tok[0, 0] = float("nan")
        with FleetManager(_factory(lm), n_replicas=2) as mgr:
            _warm(mgr)
            r = mgr.rollout(bad)
            assert r["status"] == "rolled_back"
            assert r["reason"] == "nan_screen"
            assert mgr.metrics.count_value("canary_rollbacks") == 1
            # zero requests served wrong bits: the fleet still speaks
            # the OLD params everywhere
            out = mgr.generate([1, 2, 3], 6, timeout=120)
            assert list(out) == list(lm.generate([1, 2, 3], 6))

    def test_failing_canary_rolls_back_zero_lost(self):
        lm = _lm()
        new = _lm(seed=9)
        inj = FaultInjector()

        def factory(name):
            # only the FIRST replica (the rollout's canary pick)
            # carries the injector
            return ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(8, 16),
                fault_injector=inj if name == "i0" else None,
                metrics=ServingMetrics(name=name), instance=name)

        with FleetManager(factory, n_replicas=2) as mgr:
            _warm(mgr)

            def traffic():
                futs = [mgr.submit([2, 3, 4], 6) for _ in range(4)]
                for f in futs:
                    f.result(120)       # failover keeps them whole

            # arm AFTER warm-up: the canary's decode dispatches fail
            inj.plan("serve.batch", prob=1.0, times=2,
                     exc=RuntimeError("canary dispatch fault"))
            r = mgr.rollout(new, watch_ticks=1, traffic=traffic)
            assert r["status"] == "rolled_back"
            assert r["reason"].startswith("failures")
            assert mgr.metrics.count_value("canary_rollbacks") == 1
            out = mgr.generate([1, 2, 3], 6, timeout=120)
            assert list(out) == list(lm.generate([1, 2, 3], 6))

    def test_healthy_rollout_rolls_forward_zero_dropped(self):
        lm = _lm()
        new = _lm(seed=9)
        with FleetManager(_factory(lm), n_replicas=2) as mgr:
            _warm(mgr)
            base = {n: mgr.replica(n).metrics.count_value("tokens_out")
                    for n in mgr.replicas}
            inflight = [mgr.submit([4, 5, 6], 24) for _ in range(3)]
            # ALL three must be decoding before the swap lands — a
            # still-queued request legitimately picks up the NEW
            # version at admission (single-server swap semantics); the
            # dual-version pin is about requests already in slots
            _wait(lambda: all(
                mgr.replica(n).metrics.count_value("tokens_out")
                - base[n] >= 4 for n in mgr.replicas),
                msg="in-flight requests decoding")

            def traffic():
                for _ in range(3):
                    mgr.generate([7, 8], 4, timeout=120)

            r = mgr.rollout(new, watch_ticks=1, traffic=traffic)
            assert r["status"] == "rolled_forward"
            # in-flight requests drained dual-version on their OLD
            # params — zero dropped, old bits (the hot-swap pin per
            # replica)
            old_ref = list(lm.generate([4, 5, 6], 24))
            for f in inflight:
                assert list(f.result(120)) == old_ref
            # new traffic speaks the new params on EVERY replica
            new_ref = list(new.generate([4, 5, 6], 8))
            for name in mgr.replicas:
                out = mgr.replica(name).generate([4, 5, 6], 8,
                                                 timeout=120)
                assert list(out) == new_ref
            # and a post-rollout spawn inherits them
            spawned = mgr.scale_up()
            out = mgr.replica(spawned).generate([4, 5, 6], 8,
                                                timeout=120)
            assert list(out) == new_ref


# ---------------------------------------------------------------------------
# report surface
# ---------------------------------------------------------------------------
class TestFleetReportSurface:
    def test_fleet_report_renders_control_counters(self):
        if TOOLS not in sys.path:
            sys.path.insert(0, TOOLS)
        from fleet_report import build_fleet_report, format_fleet_report
        m = ServingMetrics(name="i0", slo_target_ms=50)
        mgr_m = ServingMetrics(name="fleet")
        mgr_m.count("replica_spawned", 2)
        mgr_m.count("replica_dead", 1)
        report, merged = build_fleet_report({"i0": m, "fleet": mgr_m})
        assert merged is None
        fleet = report["fleet"]
        assert fleet["fleet_replica_spawned"] == 2
        assert fleet["fleet_replica_dead"] == 1
        assert fleet["fleet_canary_rollbacks"] == 0
        text = format_fleet_report(report)
        assert "fleet_replica_dead" in text
        assert "fleet_failover_resubmitted" in text

    def test_fleet_view_snapshot_counts_events_from_members(self):
        m = ServingMetrics(name="i0")
        m.count("failover_resubmitted", 3)
        snap = FleetView().add("i0", m).snapshot()
        assert snap["fleet_failover_resubmitted"] == 3
        assert snap["fleet_replica_drained"] == 0


# ---------------------------------------------------------------------------
# (f) graftlint regression: tombstone fetch runs OUTSIDE the manager
#     lock (a REMOTE replica's kind_snapshot is a wire
#     round-trip; holding _lock through it stalled every router/
#     probe/federation path on one dead replica's socket)
# ---------------------------------------------------------------------------
class _LockProbeMetrics:
    """ServingMetrics-shaped probe: kind_snapshot() records whether
    the calling thread holds the manager lock at fetch time — the
    crash/drain paths fetch on the caller's thread, so RLock's
    _is_owned() is exactly the question."""

    def __init__(self, name):
        self.name = name
        self.instance = name
        self.mgr = None
        self.lock_held_at_fetch = []

    def kind_snapshot(self):
        if self.mgr is not None:
            self.lock_held_at_fetch.append(
                self.mgr._lock._is_owned())
        return {"completed": {"kind": "counter", "value": 3}}

    def count_value(self, key):
        return 0


class _FakeReplica:
    """The minimal FleetManager-pluggable surface (no device work)."""

    def __init__(self, name):
        self.name = name
        self.instance = name
        self.metrics = _LockProbeMetrics(name)
        self._running = True
        self.paged = False
        self.killed = False

    @property
    def alive(self):
        return not self.killed

    def start(self):
        self._running = True
        return self

    def submit(self, prompt, max_new, **kw):
        fut = cf.Future()
        fut.set_result(list(prompt) + [0] * int(max_new))
        return fut

    def kill(self):
        self.killed = True
        self._running = False

    def stop(self, drain=True, timeout=None):
        self._running = False

    def drain(self, migrate=None, timeout=60.0):
        self._running = False
        return [], []


class TestTombstoneLockDiscipline:
    def _mgr(self):
        replicas = {}

        def factory(name):
            r = _FakeReplica(name)
            replicas[name] = r
            return r

        mgr = FleetManager(factory, n_replicas=2).start()
        for r in replicas.values():
            r.metrics.mgr = mgr
        return mgr, replicas

    def test_crash_fetches_tombstone_outside_manager_lock(self):
        mgr, replicas = self._mgr()
        try:
            victim = mgr.replicas[0]
            mgr.kill_replica(victim)
            probe = replicas[victim].metrics
            # both fetches happened (pre-removal + post-kill refresh)
            # and NEITHER ran while this thread held the manager lock
            assert len(probe.lock_held_at_fetch) >= 2
            assert not any(probe.lock_held_at_fetch)
            # the tombstone still landed atomically with the removal:
            # counters survive the instance, state reads dead
            assert mgr.states()[victim] == "dead"
            with mgr._lock:
                assert mgr._tombstones[victim]["completed"][
                    "value"] == 3
        finally:
            mgr.stop()

    def test_scale_down_fetches_tombstone_outside_manager_lock(self):
        mgr, replicas = self._mgr()
        try:
            victim = mgr.scale_down(timeout=10.0)
            probe = replicas[victim].metrics
            assert probe.lock_held_at_fetch
            assert not any(probe.lock_held_at_fetch)
            assert mgr.states()[victim] == "dead"
            with mgr._lock:
                assert victim in mgr._tombstones
        finally:
            mgr.stop()


# ---------------------------------------------------------------------------
# containment (tests/test_fleet_containment.py's bodies)
# ---------------------------------------------------------------------------
class _HoldReplica:
    """Fake replica whose submits stay IN FLIGHT until the test says
    otherwise: `kill()` fails the held futures with ReplicaDeadError
    (the real server contract), `resolve_all()` completes them with
    the deterministic greedy stream. The conviction/failover paths
    only engage against requests that are genuinely aboard."""

    def __init__(self, name):
        self.name = name
        self.instance = name
        self.metrics = ServingMetrics(name=name)
        self._running = True
        self.paged = False
        self.killed = False
        self._lock = threading.Lock()
        self.held = []          # (future, prompt, max_new)
        self.n_submits = 0

    @property
    def alive(self):
        return not self.killed

    def start(self):
        self._running = True
        return self

    def submit(self, prompt, max_new, **kw):
        fut = cf.Future()
        with self._lock:
            self.n_submits += 1
            self.held.append((fut, list(prompt), int(max_new)))
        return fut

    def resolve_all(self):
        with self._lock:
            held, self.held = self.held, []
        for fut, prompt, max_new in held:
            if not fut.done():
                fut.set_result(prompt + [0] * max_new)

    def kill(self):
        self.killed = True
        self._running = False
        with self._lock:
            held, self.held = self.held, []
        for fut, _, _ in held:
            if not fut.done():
                fut.set_exception(ReplicaDeadError(
                    f"replica {self.name} killed"))

    def stop(self, drain=True, timeout=None):
        self._running = False

    def drain(self, migrate=None, timeout=60.0):
        self._running = False
        return [], []


class _InstantReplica(_HoldReplica):
    """Fake replica that completes every submit synchronously — the
    no-fault / refill arms, where nothing is ever in flight."""

    def submit(self, prompt, max_new, **kw):
        fut = super().submit(prompt, max_new, **kw)
        fut.set_result(list(prompt) + [0] * int(max_new))
        return fut


def _fake_factory(cls, made=None):
    def make(name):
        r = cls(name)
        if made is not None:
            made[name] = r
        return r
    return make


POISON = [13, 13, 13]


def _poison_hook(prompt, replica_name):
    return list(prompt) == POISON


# ---------------------------------------------------------------------------
# (a) poison-pill quarantine
# ---------------------------------------------------------------------------
class TestQuarantine:
    def test_poison_convicted_after_exactly_two_deaths(self):
        made = {}
        with FleetManager(_fake_factory(_HoldReplica, made), n_replicas=3,
                          kill_hook=_poison_hook) as mgr:
            pre_alive = mgr.n_alive()
            fut = mgr.submit(POISON, 4)
            with pytest.raises(PoisonPillError):
                fut.result(10)
            # the cascade stopped at the conviction threshold: two
            # replicas died, the third never saw the poison
            assert mgr.metrics.count_value("replica_dead") == 2
            assert mgr.n_alive() == pre_alive - 2
            assert mgr.metrics.count_value(
                "requests_quarantined") == 1

    def test_resubmission_shed_at_the_door(self):
        made = {}
        with FleetManager(_fake_factory(_HoldReplica, made), n_replicas=3,
                          kill_hook=_poison_hook) as mgr:
            with pytest.raises(PoisonPillError):
                mgr.submit(POISON, 4).result(10)
            dead_before = mgr.metrics.count_value("replica_dead")
            submits_before = sum(r.n_submits for r in made.values())
            with pytest.raises(PoisonPillError):
                mgr.submit(POISON, 4)       # raises AT submit
            # the shed never reached a replica, let alone killed one
            assert sum(r.n_submits
                       for r in made.values()) == submits_before
            assert mgr.metrics.count_value(
                "replica_dead") == dead_before
            assert mgr.metrics.count_value(
                "requests_quarantined") == 2

    def test_innocent_co_victims_fail_over_and_complete(self):
        made = {}
        with FleetManager(_fake_factory(_HoldReplica, made), n_replicas=3,
                          kill_hook=_poison_hook) as mgr:
            # innocents land on i0 and i1 (least backlog), so the
            # poison takes i2 first, then replays onto a loaded
            # survivor and kills it too — one innocent rides a death
            inn_a = mgr.submit([1, 2, 3], 2)
            inn_b = mgr.submit([4, 5, 6], 2)
            poison = mgr.submit(POISON, 4)
            with pytest.raises(PoisonPillError):
                poison.result(10)
            assert mgr.metrics.count_value("replica_dead") == 2
            assert mgr.n_alive() == 1
            # the survivor serves everything that failed over onto it
            for r in made.values():
                r.resolve_all()
            assert inn_a.result(10) == [1, 2, 3, 0, 0]
            assert inn_b.result(10) == [4, 5, 6, 0, 0]
            # exactly the poison was lost
            assert mgr.metrics.count_value("completed") == 2
            assert mgr.metrics.count_value("failed") == 1

    def test_operator_kill_never_convicts(self):
        made = {}
        with FleetManager(_fake_factory(_HoldReplica, made),
                          n_replicas=2) as mgr:
            f1 = mgr.submit([1, 2, 3], 2)
            f2 = mgr.submit([1, 2, 3], 2)
            for name in list(mgr.replicas):
                mgr.kill_replica(name)
            # an administrative kill of every replica is an outage,
            # not evidence: both requests fail with the infrastructure
            # error, neither is branded a poison pill
            for fut in (f1, f2):
                with pytest.raises(ReplicaDeadError):
                    fut.result(10)
            assert mgr.metrics.count_value(
                "requests_quarantined") == 0


# ---------------------------------------------------------------------------
# (b) quarantine durability across manager generations
# ---------------------------------------------------------------------------
class TestQuarantineDurability:
    def test_conviction_is_journaled(self, tmp_path):
        jpath = str(tmp_path / "fleet.journal")
        with FleetManager(_fake_factory(_HoldReplica), n_replicas=3,
                          kill_hook=_poison_hook,
                          journal=jpath) as mgr:
            with pytest.raises(PoisonPillError):
                mgr.submit(POISON, 4).result(10)
        folded = fold_records(replay_journal(jpath))
        assert len(folded["quarantine"]) == 1

    def test_successor_keeps_shedding(self, tmp_path):
        jpath = str(tmp_path / "fleet.journal")
        with FleetManager(_fake_factory(_HoldReplica), n_replicas=3,
                          kill_hook=_poison_hook,
                          journal=jpath) as mgr:
            with pytest.raises(PoisonPillError):
                mgr.submit(POISON, 4).result(10)
        made = {}
        with FleetManager(_fake_factory(_HoldReplica, made), n_replicas=2,
                          journal=jpath) as mgr2:
            # no kill_hook on the successor: only the inherited
            # quarantine set stands between the poison and the fleet
            with pytest.raises(PoisonPillError):
                mgr2.submit(POISON, 4)
            assert sum(r.n_submits for r in made.values()) == 0
            assert mgr2.metrics.count_value(
                "requests_quarantined") == 1
            # innocents still flow
            ok = mgr2.submit([7, 8, 9], 2)
            for r in made.values():
                r.resolve_all()
            assert ok.result(10) == [7, 8, 9, 0, 0]


# ---------------------------------------------------------------------------
# (c) spawn circuit breaker + degraded mode
# ---------------------------------------------------------------------------
def _flaky_factory(made, arm):
    """Factory that refuses to spawn while `arm["on"]` (counting every
    attempt) — the spawn_fail chaos window in unit form."""
    calls = {"n": 0}

    def make(name):
        calls["n"] += 1
        if arm["on"]:
            raise RuntimeError("spawn_fail window: factory refused")
        r = _InstantReplica(name)
        made[name] = r
        return r
    return make, calls


class TestSpawnBreaker:
    def _mgr(self, backoff=0.2, **kw):
        made, arm = {}, {"on": False}
        factory, calls = _flaky_factory(made, arm)
        mgr = FleetManager(factory, n_replicas=2, breaker_strikes=3,
                           breaker_backoff_s=backoff,
                           infant_mortality_s=0.1, **kw).start()
        return mgr, made, arm, calls

    def test_one_tick_costs_exactly_k_strikes(self):
        # a backoff no slow tick outlives: the second tick must land
        # inside the window
        mgr, made, arm, calls = self._mgr(backoff=60.0)
        try:
            mgr.kill_replica(mgr.replicas[0])
            arm["on"] = True
            base = calls["n"]
            mgr.control_tick()
            # the backfill loop stopped AT the breaker, not at the
            # tick boundary: exactly K attempts, then OPEN
            assert calls["n"] - base == mgr.breaker_strikes
            assert mgr.breaker_state == BREAKER_OPEN
            assert mgr.metrics.count_value("breaker_open_total") == 1
            assert mgr.metrics.count_value("degraded_mode_ticks") == 1
            # ticks inside the backoff window spawn NOTHING
            mgr.control_tick()
            assert calls["n"] - base == mgr.breaker_strikes
            assert mgr.metrics.count_value("degraded_mode_ticks") == 2
        finally:
            arm["on"] = False
            mgr.stop()

    def test_half_open_probe_backoff_doubles_then_heals(self):
        mgr, made, arm, calls = self._mgr()
        try:
            mgr.kill_replica(mgr.replicas[0])
            arm["on"] = True
            mgr.control_tick()
            base = calls["n"]
            time.sleep(0.25)            # past the first backoff
            mgr.control_tick()
            # ONE half-open probe, it failed, the breaker re-opened
            # with doubled backoff
            assert calls["n"] - base == 1
            assert mgr.breaker_state == BREAKER_OPEN
            assert mgr.metrics.count_value("breaker_open_total") == 2
            arm["on"] = False
            time.sleep(0.45)            # past the doubled backoff
            mgr.control_tick()          # probe spawn succeeds
            assert mgr.n_alive() == 2
            time.sleep(0.15)            # probe survives infancy
            mgr.control_tick()
            assert mgr.breaker_state == BREAKER_CLOSED
        finally:
            arm["on"] = False
            mgr.stop()

    def test_degraded_mode_brownout_sheds_low_classes(self):
        mgr, made, arm, calls = self._mgr(
            brownout=BrownoutPolicy(classes={"batch": (0.0, 0.0)}))
        try:
            mgr.kill_replica(mgr.replicas[0])
            arm["on"] = True
            mgr.control_tick()          # opens the breaker
            with pytest.raises(ServerOverloadedError):
                mgr.submit([1, 2, 3], 2, klass="batch")
            assert mgr.metrics.count_value("shed_brownout") == 1
            # the default class still serves on what is alive
            assert mgr.submit([1, 2, 3], 2).result(10) == \
                [1, 2, 3, 0, 0]
        finally:
            arm["on"] = False
            mgr.stop()

    def test_infant_death_strikes_the_breaker(self):
        made = {}
        with FleetManager(_fake_factory(_InstantReplica, made),
                          n_replicas=1, breaker_strikes=1,
                          infant_mortality_s=30.0) as mgr:
            name = mgr.replicas[0]
            # dies well inside infant_mortality_s of its spawn
            mgr._crash(name, reason="died at startup")
            assert mgr.metrics.count_value("infant_deaths") == 1
            assert mgr.breaker_state == BREAKER_OPEN


class TestBreakerRecovery:
    def _crashloop_journal(self, tmp_path):
        """A journal left by a manager that died with the breaker
        OPEN (its roster has no wire identity, so a successor cannot
        re-adopt anything)."""
        jpath = str(tmp_path / "fleet.journal")
        made, arm = {}, {"on": False}
        factory, calls = _flaky_factory(made, arm)
        mgr = FleetManager(factory, n_replicas=2, breaker_strikes=3,
                           breaker_backoff_s=1.0,
                           infant_mortality_s=0.1,
                           journal=jpath).start()
        mgr.kill_replica(mgr.replicas[0])
        arm["on"] = True
        mgr.control_tick()
        assert mgr.breaker_state == BREAKER_OPEN
        # abandon WITHOUT stop(): the manager "crashed" mid-outage
        return jpath

    def test_recovered_manager_inherits_open_breaker(self, tmp_path):
        jpath = self._crashloop_journal(tmp_path)
        made2, arm2 = {}, {"on": False}
        factory2, calls2 = _flaky_factory(made2, arm2)
        mgr2 = FleetManager.recover(factory2, jpath, n_replicas=2,
                                    breaker_strikes=3,
                                    breaker_backoff_s=0.2,
                                    infant_mortality_s=0.05)
        try:
            # the successor did NOT resume the spawn crash-loop: the
            # inherited open breaker (a 1 s backoff, which recover()'s
            # own backfill cannot outlive) held the backfill to zero
            # spawns
            assert mgr2.breaker_state == BREAKER_OPEN
            assert calls2["n"] == 0
            assert mgr2.n_alive() == 0
            # after the inherited backoff it probes and heals
            time.sleep(1.1)
            mgr2.control_tick()
            assert mgr2.n_alive() >= 1
        finally:
            mgr2.stop()

    def test_recovery_backfill_is_bounded(self, tmp_path):
        # a CLOSED-breaker journal + an infant-death factory: the
        # recovery backfill must strike out and fall through to
        # degraded mode, not loop forever
        jpath = str(tmp_path / "fleet.journal")
        mgr = FleetManager(_fake_factory(_InstantReplica), n_replicas=2,
                           journal=jpath).start()
        mgr._journal.close()            # abandon mid-flight
        made2, arm2 = {}, {"on": True}
        factory2, calls2 = _flaky_factory(made2, arm2)
        mgr2 = FleetManager.recover(factory2, jpath, n_replicas=2,
                                    breaker_strikes=3)
        try:
            assert calls2["n"] == mgr2.breaker_strikes
            assert calls2["n"] <= mgr2.min_replicas \
                + mgr2.breaker_strikes
            assert mgr2.breaker_state == BREAKER_OPEN
            assert mgr2.n_alive() == 0
        finally:
            mgr2.stop()
        mgr._running = False


# ---------------------------------------------------------------------------
# (d) fleet-wide retry budget
# ---------------------------------------------------------------------------
class TestRetryBudget:
    def test_replays_bounded_by_budget(self):
        budget = RetryBudget(capacity=8, initial=2)
        made = {}
        with FleetManager(_fake_factory(_HoldReplica, made), n_replicas=2,
                          retry_budget=budget,
                          retry_policy=RetryPolicy(
                              max_retries=10, base_delay=0.0,
                              jitter=0.0)) as mgr:
            futs = [mgr.submit([1, 2, 3], 2) for _ in range(4)]
            for name in list(mgr.replicas):
                mgr.kill_replica(name)
            for fut in futs:
                with pytest.raises((ReplicaDeadError,
                                    RetryBudgetExhaustedError)):
                    fut.result(10)
            # total replays never exceeded the two tokens the bucket
            # held; everything past them failed LOUDLY, typed + counted
            assert mgr.metrics.count_value(
                "failover_resubmitted") <= 2
            assert mgr.metrics.count_value(
                "retry_budget_exhausted") >= 1
            assert budget.denied >= 1
            assert budget.tokens == 0.0

    def test_exhaustion_is_typed_and_counted(self):
        budget = RetryBudget(capacity=4, initial=0)
        made = {}
        with FleetManager(_fake_factory(_HoldReplica, made), n_replicas=2,
                          retry_budget=budget) as mgr:
            fut = mgr.submit([1, 2, 3], 2)
            victim = next(r.name for r in made.values() if r.held)
            mgr.kill_replica(victim)
            with pytest.raises(RetryBudgetExhaustedError):
                fut.result(10)
            assert mgr.metrics.count_value(
                "retry_budget_exhausted") == 1
            assert mgr.metrics.count_value("failed") == 1

    def test_successes_refill_the_bucket(self):
        budget = RetryBudget(capacity=8, initial=0,
                             refill_fraction=0.5)
        with FleetManager(_fake_factory(_InstantReplica), n_replicas=2,
                          retry_budget=budget) as mgr:
            for _ in range(4):
                assert mgr.submit([1, 2, 3], 2).result(10) == \
                    [1, 2, 3, 0, 0]
            # four completions at 0.5 token each
            assert budget.tokens == 2.0
            assert budget.take()
            assert budget.take()
            assert not budget.take()

    def test_no_fault_ab_zero_behavior_change(self):
        prompts = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]

        def run(retry_budget):
            made = {}
            with FleetManager(_fake_factory(_InstantReplica, made),
                              n_replicas=2,
                              retry_budget=retry_budget) as mgr:
                out = [mgr.submit(p, 3).result(10) for p in prompts]
            return out, sum(r.n_submits for r in made.values())

        budget = RetryBudget(capacity=64)
        with_budget, dispatches_b = run(budget)
        without, dispatches = run(None)
        # bit-identical streams, ZERO added dispatches, zero spend
        assert with_budget == without
        assert dispatches_b == dispatches == len(prompts)
        assert budget.tokens == float(budget.capacity)
        assert budget.denied == 0

    def test_policy_without_budget_always_grants(self):
        pol = RetryPolicy(max_retries=3, base_delay=0.0, jitter=0.0)
        assert pol.grant_retry()
        pol.budget = RetryBudget(capacity=1, initial=1)
        assert pol.grant_retry()
        assert not pol.grant_retry()


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_card_fleet_drain_canary_and_wire_swap(cuda):
    """On the card: a scale_down's migrated and replayed streams equal a
    replica's of the same configuration; the NaN screen reads the card's
    parameters where they live; a SWAP over the wire lands the leaves on
    the serving model's device with the new weights' fingerprint; kill()
    fails a card server's futures with ReplicaDeadError."""
    from deeplearning4j_tpu_torch.serving import (RemoteReplica,
                                                  ReplicaServer)
    from deeplearning4j_tpu_torch.serving.decode import _param_fingerprint
    from deeplearning4j_tpu_torch.serving.fleet import _params_finite
    kw = dict(paged=True, block_size=4, slots=2, prompt_buckets=(8, 16))
    lm = TransformerLM(64, d_model=16, n_heads=2, n_layers=1, max_len=64,
                       seed=3, device="cuda")
    new = TransformerLM(64, d_model=16, n_heads=2, n_layers=1, max_len=64,
                        seed=9, device="cuda")
    prompts = [[1 + i, 2, 3] for i in range(6)]
    with FleetManager(_factory(lm, paged=True, block_size=4),
                      n_replicas=2, min_replicas=1) as mgr:
        _warm(mgr)
        futs = [mgr.submit(p, 40) for p in prompts]
        victim = mgr.replicas[1]
        _wait(lambda: mgr.replica(victim).metrics.count_value(
            "tokens_out") > 8, msg="second replica decoding")
        mgr.scale_down(victim)
        got = [list(f.result(120)) for f in futs]
        assert _params_finite(new)
        with torch.no_grad():
            bad = TransformerLM(64, d_model=16, n_heads=2, n_layers=1,
                                max_len=64, seed=9, device="cuda")
            bad.blocks[0].mlp.w1[0, 0] = float("inf")
        assert not _params_finite(bad)
        assert mgr.rollout(bad)["reason"] == "nan_screen"
    with ContinuousDecodeServer(lm, **kw) as ref:
        want = [list(f.result(120)) for f in
                [ref.submit(p, 40) for p in prompts]]
    assert got == want
    srv = ContinuousDecodeServer(lm, metrics=ServingMetrics(name="w"),
                                 instance="w", **kw)
    rs = ReplicaServer(srv)
    rr = RemoteReplica("127.0.0.1", rs.port, name="w",
                       heartbeat_interval=0.05)
    try:
        rr.swap(new)
        aux, blocks = srv.current_params()
        assert aux.tok.is_cuda and blocks[0].attn.wqkv.is_cuda
        assert _param_fingerprint(aux, blocks) == \
            _param_fingerprint(new.aux, new.blocks)
        held = [srv.submit([1, 2, 3], 40) for _ in range(4)]
        srv.kill()
        for f in held:
            with pytest.raises(ReplicaDeadError):
                f.result(30)
    finally:
        rr.kill()
        rs.close(stop_server=False)
