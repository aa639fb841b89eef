"""The port's ContinuousDecodeServer (serving/decode.py).

Two parts:
  * Against the JAX package: one seeded workload of greedy requests (some
    behind a shared prefix) through the JAX server and the port's, with
    the same weights (`TransformerLM.from_jax_params`), in each mode -
    fixed slots, paged with the prefix cache, chunked prefill, fused
    windows, static batching: the token streams are equal.
  * The reference's own pins, rebuilt on the port (on torch's CPU, f32):
    the decode cases of tests/test_serving.py, tests/test_paged.py
    without speculation, tests/test_overload.py without
    `test_chunked_composes_with_speculate`, and tests/test_fused_serve.py.
    Their bodies are the reference's, run against the port's classes;
    the speculative ones are in tests/test_torch_speculative.py. The
    fleet verbs (`kill`, `drain`) are held here to their contract and in
    tests/test_torch_fleet_manager.py against the reference's.

Tests marked `gpu` run on the card and skip without one.
"""
import math
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common.resilience import (FaultInjected,
                                                        FaultInjector,
                                                        RetryPolicy)
from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
from deeplearning4j_tpu_torch.serving import (AdmissionController,
                                              BlockPool, BrownoutPolicy,
                                              ContinuousDecodeServer,
                                              DeadlineExceededError,
                                              ServerClosedError,
                                              ServerOverloadedError,
                                              ServiceRateEstimator)
from deeplearning4j_tpu_torch.serving.admission import ACCEPT, DEFER, SHED


def _lm(seed=3, max_len=64):
    """The model of tests/test_serving.py, test_paged.py and
    test_fused_serve.py, drawn by the port."""
    return TransformerLM(64, d_model=32, n_heads=2, n_layers=2,
                         max_len=max_len, seed=seed, device="cpu")


def _lm_small(seed=3):
    """The model of tests/test_overload.py, drawn by the port."""
    return TransformerLM(64, d_model=16, n_heads=2, n_layers=1,
                         max_len=48, seed=seed, device="cpu")


def _paged(lm, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("prompt_buckets", (8, 16))
    kw.setdefault("block_size", 4)
    kw.setdefault("n_blocks", 40)
    return ContinuousDecodeServer(lm, paged=True, **kw)


def _paced():
    """Delay-only faults that slow every dispatch after the first by 10 ms:
    the port's CPU decode steps are faster than the reference's, so the
    pins that need a request still holding its blocks when the next one
    arrives pace the iterations (the reference's eviction-test pattern)."""
    return FaultInjector(seed=6).plan("serve.batch", on_calls=range(1, 400),
                                      times=400, delay=0.01, exc=None)


def _prompt(seed=4, n=5):
    return np.random.default_rng(seed).integers(1, 64, n).tolist()


# ---------------------------------------------------------------------------
# the port's server against the JAX package's
# ---------------------------------------------------------------------------
V, DM, NH, NL, MAXLEN = 96, 32, 2, 2, 64
_MODES = {
    "fixed": dict(slots=3, prompt_buckets=(8, 16)),
    "paged_prefix": dict(slots=3, prompt_buckets=(16,), paged=True,
                         block_size=8, n_blocks=24),
    "chunked": dict(slots=3, prompt_buckets=(8, 16), chunked_prefill=4),
    "fused": dict(slots=3, prompt_buckets=(8, 16), fused_serve=4),
    "static": dict(slots=3, prompt_buckets=(8, 16), static_batching=True),
}


def _workload():
    """Seven greedy requests: four behind one 9-token prefix (a full block
    of 8 plus a partial one), three cold; 3-15 prompt tokens, 2-9 new."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, V, 9).tolist()
    work = []
    for i in range(7):
        own = rng.integers(1, V, int(rng.integers(1, 7))).tolist()
        prompt = sysp + own if i % 2 == 0 else own + [7, 3]
        work.append((prompt, int(rng.integers(2, 10))))
    return work


def _serve(server_cls, lm, mode, work):
    """Streams of `work` through one server: the first request alone (the
    prefix cache fills), then the rest submitted together."""
    with server_cls(lm, **_MODES[mode]) as srv:
        out = [srv.generate(*work[0], timeout=120)]
        futs = [srv.submit(p, n) for p, n in work[1:]]
        out += [f.result(120) for f in futs]
        snap = srv.metrics.snapshot()
    return [list(map(int, s)) for s in out], snap


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX server's streams of `_workload()` in every mode, and the
    weights as numpy. One JAX model; its servers compile few buckets."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeplearning4j_tpu.models.zoo.transformer import TransformerLM as J
    from deeplearning4j_tpu.serving import ContinuousDecodeServer as JS
    jlm = J(V, d_model=DM, n_heads=NH, n_layers=NL, max_len=MAXLEN, seed=0,
            dtype=jnp.float32)
    work = _workload()
    streams = {mode: _serve(JS, jlm, mode, work)[0] for mode in _MODES}
    aux, blocks = jax.tree.map(np.asarray, (jlm.aux, jlm.blocks))
    return {"aux": aux, "blocks": blocks, "work": work, "streams": streams}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_streams_equal_jax_server(jax_streams, mode):
    lm = TransformerLM.from_jax_params(jax_streams["aux"],
                                       jax_streams["blocks"], NH,
                                       device="cpu")
    got, snap = _serve(ContinuousDecodeServer, lm, mode, jax_streams["work"])
    assert got == jax_streams["streams"][mode]
    assert snap.get("failed", 0) == 0
    if mode == "paged_prefix":
        assert snap["prefix_rows_hit"] >= 8
    if mode == "fused":
        assert snap["fused_windows"] > 0


# ---------------------------------------------------------------------------
# the fleet verbs and the deferred options
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("verb", ["kill", "drain"])
def test_fleet_verbs_resolve_every_future(verb):
    """kill() fails every in-flight and queued future with
    ReplicaDeadError; drain() hands them all off as (migrated, replayed),
    each local future failed with its hand-off error. Either way the
    server ends stopped, holding nothing."""
    from deeplearning4j_tpu_torch.serving import (ReplicaDeadError,
                                                  RequestDrainedError,
                                                  RequestMigratedError)
    srv = _paged(_lm(), slots=2, fault_injector=_paced()).start()
    srv.generate([1, 2, 3], 2, timeout=120)
    futs = [srv.submit([1, 2, 3], 30) for _ in range(4)]
    _wait_decoding(srv)
    if verb == "kill":
        srv.kill()
        for f in futs:
            with pytest.raises(ReplicaDeadError):
                f.result(30)
        with pytest.raises(ServerClosedError):
            srv.start()
    else:
        migrated, replayed = srv.drain()
        assert {f for f, _ in migrated} | {f for f, _ in replayed} == \
            set(futs)
        assert migrated and replayed        # two decoding, two queued
        for f, art in migrated:
            assert isinstance(f.exception(0), RequestMigratedError)
            assert list(art.prompt) == [1, 2, 3] and art.generated
        for f, spec in replayed:
            assert isinstance(f.exception(0), RequestDrainedError)
            assert spec == {"prompt": [1, 2, 3], "max_new": 30,
                            "deadline": None, "klass": "default"}
    assert not srv.alive
    assert all(r is None for r in srv._slot_req)


def _wait_decoding(srv, timeout=60.0):
    t0 = time.monotonic()
    while not any(r is not None and r.pf_next is None and r.generated
                  for r in srv._slot_req):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("no request ever reached decode")
        time.sleep(0.002)


def test_fused_with_speculate_names_the_deferred_item():
    """The reference's pin (tests/test_fused_serve.py): fused_serve > 1
    with speculate= is refused at the constructor with a ValueError."""
    from deeplearning4j_tpu_torch.serving import NGramDraft, Speculator
    with pytest.raises(ValueError, match="does not compose"):
        ContinuousDecodeServer(_lm(), prompt_buckets=(8,), fused_serve=4,
                               speculate=Speculator(NGramDraft(n=2), k=4))


def test_swap_rejects_another_architecture():
    with ContinuousDecodeServer(_lm(), prompt_buckets=(8,)) as srv:
        other = TransformerLM(64, d_model=32, n_heads=2, n_layers=2,
                              max_len=32, seed=3, device="cpu")
        with pytest.raises(ValueError, match="swap rejected"):
            srv.swap(other)
        half = TransformerLM(64, d_model=32, n_heads=2, n_layers=2,
                             max_len=64, seed=3, device="cpu",
                             dtype=torch.float64)
        with pytest.raises(ValueError, match="swap rejected"):
            srv.swap(half)


# ---------------------------------------------------------------------------
# the reference's pins on the port (bodies from the reference's tests)
# ---------------------------------------------------------------------------
class TestContinuousDecode:
    def test_join_running_batch_equals_solo(self):
        """A request joining a batch mid-decode emits the same tokens as
        the same request decoding alone."""
        lm = _lm()
        rng = np.random.default_rng(4)
        pa = rng.integers(1, 64, 5).tolist()
        pb = rng.integers(1, 64, 8).tolist()
        pc = rng.integers(1, 64, 3).tolist()
        with ContinuousDecodeServer(lm, slots=4,
                                    prompt_buckets=(4, 8)) as srv:
            solo = srv.generate(pa, 10, timeout=60)
            flong = srv.submit(pb, 30)       # running batch
            time.sleep(0.05)                 # let pb decode a few tokens
            fa = srv.submit(pa, 10)          # joins mid-flight
            fc = srv.submit(pc, 6)
            joined = fa.result(60)
            flong.result(60)
            fc.result(60)
        assert joined == solo

    def test_equal_arrival_matches_generate_batch(self):
        """4 equal-length requests admitted together == generate_batch
        greedy rows, token-for-token."""
        lm = _lm()
        rng = np.random.default_rng(5)
        prompts = rng.integers(1, 64, (4, 4)).astype(np.int32)
        expect = lm.generate_batch(prompts, max_new_tokens=8)
        with ContinuousDecodeServer(lm, slots=4,
                                    prompt_buckets=(4,)) as srv:
            futs = [srv.submit(prompts[i], 8) for i in range(4)]
            rows = [f.result(60) for f in futs]
        for i in range(4):
            assert rows[i] == expect[i].tolist()

    def test_matches_generate_use_cache(self):
        """The serving path agrees with the pinned single-request
        generate(use_cache=True) reference."""
        lm = _lm()
        rng = np.random.default_rng(6)
        p = rng.integers(1, 64, 4).tolist()
        expect = lm.generate(p, max_new_tokens=9)
        with ContinuousDecodeServer(lm, slots=2,
                                    prompt_buckets=(4,)) as srv:
            got = srv.generate(p, 9, timeout=60)
        assert got == expect

    def test_one_token_request_resolves_at_prefill(self):
        lm = _lm()
        p = [5, 9, 2]
        expect = lm.generate(p, max_new_tokens=1)
        with ContinuousDecodeServer(lm, slots=2,
                                    prompt_buckets=(4,)) as srv:
            got = srv.generate(p, 1, timeout=60)
            with pytest.raises(ValueError, match="max_new_tokens"):
                srv.submit(p, 0)
        assert got == expect

    def test_prefill_compile_cache_bounded(self):
        lm = _lm()
        rng = np.random.default_rng(7)
        with ContinuousDecodeServer(lm, slots=2,
                                    prompt_buckets=(4, 8)) as srv:
            for n in (2, 3, 4, 5, 7, 8, 6, 1):
                srv.generate(rng.integers(1, 64, n).tolist(), 2,
                             timeout=60)
            assert len(srv.prefill_programs) <= 2


class TestDecodeHotSwap:
    def test_decode_dual_version_drain(self):
        """In-flight decode requests finish on pre-swap params (token
        streams identical to a pre-swap solo run) while a post-swap
        request gets the new params — dual-version dispatch."""
        lm1, lm2 = _lm(3), _lm(11)
        rng = np.random.default_rng(10)
        pa = rng.integers(1, 64, 4).tolist()
        pb = rng.integers(1, 64, 4).tolist()
        with ContinuousDecodeServer(lm1, slots=2,
                                    prompt_buckets=(4,)) as srv:
            solo_old = srv.generate(pa, 14, timeout=60)
            fa = srv.submit(pa, 14)
            time.sleep(0.03)                  # pa decoding on v0
            srv.swap(lm2)
            fb = srv.submit(pb, 5)            # admitted on v1
            ra, rb = fa.result(60), fb.result(60)
        assert ra == solo_old                 # drained on old params
        expect_new = lm2.generate_batch(np.asarray([pb], np.int32),
                                        max_new_tokens=5)
        assert rb == expect_new[0].tolist()   # routed to new params
        assert srv.metrics.snapshot().get("failed", 0) == 0


class TestDecodeHardening:
    def test_decode_thread_survives_terminal_dispatch_fault(self):
        """A non-retryable fault during a decode iteration fails the
        occupied requests LOUDLY, resets the slot state, and keeps the
        server serving — no dead thread stranding future requests."""
        lm = _lm()
        inj = FaultInjector(seed=5).plan("serve.batch", on_call=1,
                                         exc=FaultInjected)  # 0 = prefill
        rng = np.random.default_rng(19)
        p = rng.integers(1, 64, 4).tolist()
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(4,),
                                    fault_injector=inj) as srv:
            f = srv.submit(p, 6)
            with pytest.raises(FaultInjected):
                f.result(60)
            # the server recovers: same request serves fine afterwards
            got = srv.generate(p, 6, timeout=60)
        assert got == lm.generate(p, max_new_tokens=6)
        assert srv.metrics.snapshot().get("failed") == 1

    def test_decode_stop_no_drain_fails_queued_fast(self):
        """stop(drain=False) must FAIL queued requests, not admit them
        into slots freed by the draining ones."""
        lm = _lm()
        rng = np.random.default_rng(20)
        with ContinuousDecodeServer(lm, slots=1, prompt_buckets=(4,),
                                    fault_injector=_paced()) as srv:
            busy = srv.submit(rng.integers(1, 64, 4).tolist(), 24)
            time.sleep(0.02)          # occupies the only slot
            queued = [srv.submit(rng.integers(1, 64, 4).tolist(), 24)
                      for _ in range(3)]
            srv.stop(drain=False)
            assert busy.result(60)    # in-flight work still completes
            for f in queued:
                with pytest.raises(Exception):
                    f.result(60)      # queued work failed, not served

    def test_decode_deadline_evicted_mid_decode(self):
        """A request whose deadline expires WHILE it occupies a slot is
        evicted between iterations: its future fails with
        DeadlineExceededError, the shed is counted, and the slot frees
        the same iteration (a queued request takes it over immediately —
        the server never rides a dead request to max_new)."""
        lm = _lm()
        rng = np.random.default_rng(22)
        p = rng.integers(1, 64, 4).tolist()
        # delay-only faults slow every decode iteration deterministically
        # so the deadline reliably lands mid-decode, not at admission
        inj = FaultInjector(seed=6).plan(
            "serve.batch", on_calls=range(1, 60), times=60,
            delay=0.02, exc=None)
        with ContinuousDecodeServer(lm, slots=1, prompt_buckets=(4,),
                                    fault_injector=inj) as srv:
            doomed = srv.submit(p, 40, deadline_ms=100)
            queued = srv.submit(p, 4)        # waits for the only slot
            with pytest.raises(DeadlineExceededError,
                               match="mid-decode"):
                doomed.result(60)
            assert queued.result(60) == lm.generate(p, max_new_tokens=4)
        snap = srv.metrics.snapshot()
        assert snap.get("evicted_mid_decode") == 1
        assert snap.get("shed_deadline") == 1

    def test_decode_cancelled_future_expiring_keeps_thread_alive(self):
        """A caller-cancel()ed future whose deadline then expires must not
        kill the serve thread (set_exception on a cancelled future raises
        InvalidStateError): the slot is released silently and the server
        keeps serving."""
        lm = _lm()
        p = [3, 9, 11, 4]
        inj = FaultInjector(seed=7).plan(
            "serve.batch", on_calls=range(1, 60), times=60,
            delay=0.02, exc=None)
        with ContinuousDecodeServer(lm, slots=1, prompt_buckets=(4,),
                                    fault_injector=inj) as srv:
            f = srv.submit(p, 40, deadline_ms=150)
            time.sleep(0.05)
            assert f.cancel() or f.done()
            time.sleep(0.4)           # deadline passes on the dead future
            got = srv.generate(p, 4, timeout=60)
        assert got == lm.generate(p, max_new_tokens=4)

    def test_decode_deadline_shed_and_swap_site(self):
        lm = _lm()
        inj = FaultInjector(seed=4)
        rng = np.random.default_rng(16)
        p = rng.integers(1, 64, 4).tolist()
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(4,),
                                    fault_injector=inj) as srv:
            f = srv.submit(p, 4, deadline_ms=0.0)
            with pytest.raises(DeadlineExceededError):
                f.result(60)
            srv.swap(_lm(12))
        assert srv.metrics.snapshot().get("shed_deadline") == 1
        assert inj.calls("serve.swap") == 1
        assert inj.calls("serve.request") == 1


class TestBlockPool:
    def test_churn_no_leak_property(self):
        """Random admit/release churn (shared prefixes included): the
        accounting invariants hold after EVERY operation and the pool
        returns to fully-reusable when the last request releases."""
        rng = np.random.default_rng(0)
        pool = BlockPool(24, 4)
        live = []
        prefixes = [tuple(rng.integers(1, 9, 8)),
                    tuple(rng.integers(1, 9, 8))]
        for _ in range(300):
            if live and (rng.random() < 0.45 or len(live) >= 8):
                alloc = live.pop(int(rng.integers(0, len(live))))
                if alloc.cow is not None and rng.random() < 0.5:
                    pool.cow(alloc)     # sometimes materialize first
                pool.release(alloc)
            else:
                base = list(prefixes[int(rng.integers(0, 2))])
                prompt = base[:int(rng.integers(1, 9))] + \
                    list(rng.integers(1, 9, int(rng.integers(0, 4))))
                rows = len(prompt) + int(rng.integers(1, 12))
                alloc = pool.admit(prompt, rows)
                if alloc is not None:
                    pool.commit(alloc)   # as the scheduler does on
                    live.append(alloc)   # prefill success
            pool.check()
        for alloc in live:
            pool.release(alloc)
        pool.check()
        assert pool.blocks_in_use == 0
        assert pool.blocks_free == pool.capacity

    def test_prefix_reuse_and_lru_eviction(self):
        pool = BlockPool(6, 4)
        p = list(range(1, 9))                   # 2 full blocks
        a = pool.admit(p, len(p))
        assert a is not None and a.shared_rows == 0
        pool.commit(a)                           # "prefill succeeded"
        pool.release(a)                          # retire to prefix cache
        assert pool.blocks_in_use == 0 and pool.blocks_free == 6
        b = pool.admit(p, len(p) + 3)            # same prompt: full hit
        assert b.shared_rows == 8 and b.n_shared == 2
        # demand exceeding the free list evicts cached blocks LRU
        pool.release(b)
        c = pool.admit(list(range(20, 44)), 24)  # needs all 6 blocks
        assert c is not None
        pool.release(c)
        # the old prefix was evicted to make room: no hit anymore
        d = pool.admit(p, len(p))
        assert d.shared_rows == 0
        pool.release(d)
        pool.check()

    def test_prefix_index_namespaced_by_tag(self):
        """Blocks indexed under one tag never match another tag's
        lookups: the server tags by param version, so k/v rows computed
        under swapped-out weights are structurally unreachable."""
        pool = BlockPool(8, 4)
        p = list(range(1, 9))
        a = pool.admit(p, len(p), tag=0)
        pool.commit(a)
        pool.release(a)
        assert pool.match_prefix(p, tag=0)[1] == 8
        assert pool.match_prefix(p, tag=1) == ([], 0, None)
        b = pool.admit(p, len(p) + 3, tag=1)     # no cross-tag hit
        assert b.shared_rows == 0
        pool.commit(b)
        pool.release(b)
        # both versions' blocks now cached, each under its own tag
        assert pool.match_prefix(p, tag=0)[1] == 8
        assert pool.match_prefix(p, tag=1)[1] == 8
        pool.check()

    def test_partial_match_reserves_cow_spare(self):
        pool = BlockPool(12, 4)
        long = list(range(1, 9))                # blocks [1..4][5..8]
        a = pool.admit(long, len(long) + 4)
        pool.commit(a)
        short = long[:6]                        # rides block 2 partially
        b = pool.admit(short, len(short) + 4, will_append=True)
        assert b.shared_rows == 6 and b.cow is not None
        idx, spare = b.cow
        assert b.ids[idx] == a.ids[1]           # shared physical block
        src, dst = pool.cow(b)
        assert (src, dst) == (a.ids[1], spare) and b.cow is None
        assert b.ids[idx] == spare
        # a prefill-only rider shares with NO spare and no copy
        c = pool.admit(short, len(short), will_append=False)
        assert c.shared_rows == 6 and c.cow is None
        for alloc in (a, b, c):
            pool.release(alloc)
        pool.check()
        assert pool.blocks_in_use == 0

    def test_capacity_sized_table_forgoes_cow_ride(self):
        """A capacity-sized block table plus its CoW spare can NEVER be
        satisfied — admit() must forgo the partial-tail ride (prefill
        recomputes those rows) instead of returning None forever, which
        would park the request at the head of the memory queue and
        deadlock every later admission behind it."""
        pool = BlockPool(4, 4)
        a = pool.admit(list(range(1, 9)), 8)     # 2 blocks
        pool.commit(a)
        pool.release(a)                          # both cached + indexed
        # 6-token prompt rides a's partial tail; 15 total rows -> a
        # 4-block table == capacity, so the spare would be block 5
        b = pool.admit(list(range(1, 7)), 15)
        assert b is not None                     # not parked forever
        assert b.cow is None and len(b.ids) == 4
        assert b.shared_rows == 4                # full-block hit kept
        pool.release(b)
        pool.check()

    def test_admit_blocks_when_pool_short(self):
        pool = BlockPool(4, 4)
        a = pool.admit(list(range(1, 7)), 12)   # 3 blocks
        assert pool.admit(list(range(30, 36)), 12) is None  # 3 > 1 free
        pool.release(a)
        assert pool.admit(list(range(30, 36)), 12) is not None


class TestPagedDeterminism:
    def test_join_running_batch_equals_solo(self):
        """The continuous-decode determinism pin, over the block table:
        a request joining mid-flight emits the same tokens as alone."""
        lm = _lm()
        rng = np.random.default_rng(4)
        pa = rng.integers(1, 64, 5).tolist()
        pb = rng.integers(1, 64, 8).tolist()
        pc = rng.integers(1, 64, 3).tolist()
        with _paged(lm) as srv:
            solo = srv.generate(pa, 10, timeout=60)
            flong = srv.submit(pb, 30)
            time.sleep(0.05)
            fa = srv.submit(pa, 10)
            fc = srv.submit(pc, 6)
            joined = fa.result(60)
            flong.result(60)
            fc.result(60)
        assert joined == solo

    def test_paged_equals_fixed_slot_and_generate(self):
        """Same request through the paged server, the fixed-slot server,
        and the pinned generate(use_cache=True) reference: one stream."""
        lm = _lm()
        rng = np.random.default_rng(5)
        p = rng.integers(1, 64, 6).tolist()
        expect = lm.generate(p, max_new_tokens=9)
        with ContinuousDecodeServer(lm, slots=2,
                                    prompt_buckets=(8,)) as srv:
            fixed = srv.generate(p, 9, timeout=60)
        with _paged(lm) as srv:
            paged = srv.generate(p, 9, timeout=60)
        assert fixed == expect
        assert paged == expect

    def test_prefix_shared_equals_unshared(self):
        """Two requests behind one system prefix decode bit-identically
        with sharing on (leading blocks one physical copy) and off —
        and the shared run actually hits the prefix cache."""
        lm = _lm()
        rng = np.random.default_rng(6)
        sysp = rng.integers(1, 64, 8).tolist()      # 2 full blocks
        pa = sysp + rng.integers(1, 64, 3).tolist()
        pb = sysp + rng.integers(1, 64, 2).tolist()
        with _paged(lm, prefix_cache=False) as srv:
            ra0 = srv.generate(pa, 8, timeout=60)
            rb0 = srv.generate(pb, 8, timeout=60)
            assert srv.metrics.snapshot()["prefix_rows_hit"] == 0
        with _paged(lm) as srv:
            fa = srv.submit(pa, 8)
            time.sleep(0.05)
            fb = srv.submit(pb, 8)
            ra, rb = fa.result(60), fb.result(60)
            snap = srv.metrics.snapshot()
        assert ra == ra0 and rb == rb0
        # B's two leading blocks were resident from A
        assert snap["prefix_rows_hit"] >= 8
        assert snap["prefix_hit_rate"] > 0

    def test_copy_on_write_correctness(self):
        """A shorter prompt rides a longer prompt's final block; its
        first divergent append triggers exactly one CoW, and BOTH
        streams stay bit-identical to their unshared runs."""
        lm = _lm()
        rng = np.random.default_rng(7)
        p8 = rng.integers(1, 64, 8).tolist()
        p6 = p8[:6]
        with _paged(lm, prefix_cache=False) as srv:
            a0 = srv.generate(p8, 10, timeout=60)
            b0 = srv.generate(p6, 10, timeout=60)
        with _paged(lm) as srv:
            fa = srv.submit(p8, 10)
            time.sleep(0.05)
            fb = srv.submit(p6, 10)     # shares [p8[0:4]] + part of blk 2
            a1, b1 = fa.result(60), fb.result(60)
            snap = srv.metrics.snapshot()
        assert a1 == a0          # owner's rows never clobbered
        assert b1 == b0          # sharer diverges onto its private copy
        assert snap["cow_copies"] == 1
        assert snap["prefix_rows_hit"] >= 6


class TestPagedScheduling:
    def test_blocked_on_memory_admits_when_blocks_free(self):
        """Admission is gated by FREE BLOCKS: a request that cannot get
        its reservation waits (counted once), then serves correctly
        when the resident request completes — no deadlock, no drop."""
        lm = _lm()
        rng = np.random.default_rng(8)
        p1 = rng.integers(1, 64, 8).tolist()
        p2 = rng.integers(1, 64, 6).tolist()
        expect = lm.generate(p2, max_new_tokens=16)
        with _paged(lm, slots=4, n_blocks=8,
                    fault_injector=_paced()) as srv:
            f1 = srv.submit(p1, 16)          # 6 of 8 blocks
            time.sleep(0.05)
            f2 = srv.submit(p2, 16)          # needs 6 > 2 free: waits
            r1, r2 = f1.result(60), f2.result(60)
            snap = srv.metrics.snapshot()
            assert srv._pool.blocks_in_use == 0     # all returned
        assert len(r1) == 8 + 16
        assert r2 == expect
        assert snap["blocked_on_memory"] == 1
        assert snap.get("failed", 0) == 0

    def test_never_fits_shed_at_submit(self):
        lm = _lm()
        with _paged(lm, n_blocks=4) as srv:
            with pytest.raises(ServerOverloadedError, match="KV blocks"):
                srv.submit([1, 2, 3, 4], 30)     # needs 9 > 4 blocks
            assert srv.metrics.snapshot()["shed_blocks"] == 1

    def test_deadline_expires_while_blocked_on_memory(self):
        """Blocked-on-blocks is queue wait: the deadline still fires,
        the shed is counted, and the blocks it never got stay free.
        Delay-only faults pace the decode iterations (the
        test_serving.py eviction pattern) so the block-holder reliably
        outlives the blocked request's deadline."""
        from deeplearning4j_tpu_torch.common.resilience import FaultInjector
        lm = _lm()
        rng = np.random.default_rng(9)
        p1 = rng.integers(1, 64, 8).tolist()
        inj = FaultInjector(seed=6).plan(
            "serve.batch", on_calls=range(1, 120), times=120,
            delay=0.02, exc=None)
        with _paged(lm, slots=4, n_blocks=8,
                    fault_injector=inj) as srv:
            f1 = srv.submit(p1, 24)          # holds 31 rows -> all 8
            # wait past prefill + the first (compile-bearing) decode
            # iterations, so admission examines the doomed request
            # BEFORE its deadline can expire
            t0 = time.monotonic()
            while srv.metrics.count_value("dispatches") < 3 and \
                    time.monotonic() - t0 < 30:
                time.sleep(0.01)
            doomed = srv.submit(p1, 16, deadline_ms=150)
            # the shed fires from whichever sweep sees the expiry first:
            # the mem-wait sweep ("KV blocks") or the admission re-check
            # ("before prefill") — both count it identically
            with pytest.raises(DeadlineExceededError,
                               match="KV blocks|before prefill"):
                doomed.result(60)
            f1.result(60)
        snap = srv.metrics.snapshot()
        assert snap["shed_deadline"] == 1
        assert snap["blocked_on_memory"] == 1

    def test_no_leak_after_request_churn(self):
        """N mixed requests (shared prefixes, mixed lengths) through a
        small arena: every future resolves, the pool ends empty, and
        the invariants hold — the serving-level refcount/free-list
        pin."""
        lm = _lm()
        rng = np.random.default_rng(10)
        sysp = rng.integers(1, 64, 4).tolist()
        with _paged(lm, slots=3, n_blocks=16) as srv:
            futs = []
            for i in range(12):
                own = rng.integers(1, 64, int(rng.integers(1, 5))).tolist()
                p = (sysp + own) if i % 2 else own
                futs.append(srv.submit(p, int(rng.integers(2, 8))))
            for f in futs:
                assert f.result(120)
            assert srv._pool.blocks_in_use == 0
            assert srv._pool.check()
            assert srv.metrics.snapshot().get("failed", 0) == 0

    def test_dispatch_counter_ab_zero_extra_per_token(self):
        """Paging must be free in DISPATCHES: the same workload through
        fixed-slot and paged servers costs the identical number of
        decode dispatches (the per-token device cost), and the paged
        arm pays no CoW copies on an unshared workload."""
        lm = _lm()
        rng = np.random.default_rng(11)
        work = [(rng.integers(1, 64, int(rng.integers(3, 8))).tolist(),
                 int(rng.integers(3, 9))) for _ in range(6)]
        counts = {}
        for name, srv in (
                ("fixed", ContinuousDecodeServer(
                    lm, slots=2, prompt_buckets=(8,))),
                ("paged", _paged(lm, slots=2))):
            with srv:
                for p, n in work:       # sequential: same iteration count
                    srv.generate(p, n, timeout=60)
                snap = srv.metrics.snapshot()
            counts[name] = (snap["dispatches"], snap["tokens_out"],
                            snap.get("cow_copies", 0))
        assert counts["fixed"][:2] == counts["paged"][:2]
        assert counts["paged"][2] == 0

    def test_hot_swap_drain_with_paged_slots(self):
        """Dual-version drain over the block table: in-flight requests
        finish on pre-swap params, a post-swap request gets the new —
        zero failures, blocks all returned."""
        lm1, lm2 = _lm(3), _lm(11)
        rng = np.random.default_rng(12)
        pa = rng.integers(1, 64, 4).tolist()
        pb = rng.integers(1, 64, 4).tolist()
        with _paged(lm1, slots=2) as srv:
            solo_old = srv.generate(pa, 14, timeout=60)
            fa = srv.submit(pa, 14)
            time.sleep(0.03)
            srv.swap(lm2)
            fb = srv.submit(pb, 5)
            ra, rb = fa.result(60), fb.result(60)
            assert srv._pool.blocks_in_use == 0
        assert ra == solo_old
        expect_new = lm2.generate_batch(np.asarray([pb], np.int32),
                                        max_new_tokens=5)
        assert rb == expect_new[0].tolist()
        assert srv.metrics.snapshot().get("failed", 0) == 0

    def test_fail_fast_stop_fails_memory_waiters(self):
        """stop(drain=False) with a request parked on the memory gate:
        the parked future fails with ServerClosedError and the loop
        exits promptly. Parked requests count as _busy(), so leaving
        them parked would keep the serve thread spinning (and the
        caller blocked on the future) forever once the slots drain."""
        from deeplearning4j_tpu_torch.serving import ServerClosedError
        lm = _lm()
        rng = np.random.default_rng(15)
        pa = rng.integers(1, 64, 4).tolist()
        pb = rng.integers(1, 64, 4).tolist()
        srv = _paged(lm, slots=2, n_blocks=4,
                     fault_injector=_paced()).start()
        try:
            fa = srv.submit(pa, 9)          # 12 rows -> 3 of 4 blocks
            time.sleep(0.05)                # let A occupy its slot
            fb = srv.submit(pb, 9)          # needs 3, 1 free: parks
            deadline = time.monotonic() + 5
            while (srv.metrics.snapshot().get("blocked_on_memory", 0)
                   < 1 and time.monotonic() < deadline):
                time.sleep(0.005)
            assert srv.metrics.snapshot()["blocked_on_memory"] == 1
        finally:
            srv.stop(drain=False, timeout=30)
        assert srv._thread is None          # loop actually exited
        assert fa.result(1) == lm.generate(pa, max_new_tokens=9)
        with pytest.raises(ServerClosedError):
            fb.result(1)

    def test_swap_invalidates_prefix_reuse(self):
        """A post-swap request with a prompt already in the prefix cache
        must NOT share the old version's blocks — those k/v rows were
        computed under the old params. Pinned two ways: the post-swap
        result is bit-identical to the new params' solo decode, and the
        prefix-hit counter does not move across the swap."""
        lm1, lm2 = _lm(3), _lm(11)
        p = list(range(1, 10))                   # 2 full blocks + tail
        with _paged(lm1, slots=2) as srv:
            srv.generate(p, 4, timeout=60)       # populates the index
            srv.generate(p, 4, timeout=60)       # proves it hits
            hits_before = srv.metrics.snapshot()["prefix_rows_hit"]
            assert hits_before >= 8
            srv.swap(lm2)
            got = srv.generate(p, 4, timeout=60)
            assert srv.metrics.snapshot()["prefix_rows_hit"] \
                == hits_before                   # no cross-version hit
        expect = lm2.generate_batch(np.asarray([p], np.int32),
                                    max_new_tokens=4)
        assert got == expect[0].tolist()

    def test_paged_thread_survives_terminal_dispatch_fault(self):
        """A terminal decode-dispatch fault fails the occupied requests
        LOUDLY and rebuilds arena + pool + tables together (a pool that
        outlived its arena would hand out rows in dead buffers); the
        server keeps serving."""
        from deeplearning4j_tpu_torch.common.resilience import (FaultInjected,
                                                          FaultInjector)
        lm = _lm()
        inj = FaultInjector(seed=5).plan("serve.batch", on_call=1,
                                         exc=FaultInjected)  # 0 = prefill
        rng = np.random.default_rng(13)
        p = rng.integers(1, 64, 4).tolist()
        with _paged(lm, slots=2, fault_injector=inj) as srv:
            f = srv.submit(p, 6)
            with pytest.raises(FaultInjected):
                f.result(60)
            got = srv.generate(p, 6, timeout=60)
            assert srv._pool.blocks_in_use == 0
        assert got == lm.generate(p, max_new_tokens=6)
        assert srv.metrics.snapshot().get("failed") == 1

    def test_paged_prefill_fault_fails_only_that_request(self):
        """The paged prefill does NOT donate the arena precisely so a
        prefill-time failure stays per-request: the arena survives, the
        failed request's reserved blocks release, the next request
        serves bit-identically."""
        from deeplearning4j_tpu_torch.common.resilience import (FaultInjected,
                                                          FaultInjector)
        lm = _lm()
        inj = FaultInjector(seed=5).plan("serve.batch", on_call=0,
                                         exc=FaultInjected)
        rng = np.random.default_rng(14)
        p = rng.integers(1, 64, 4).tolist()
        with _paged(lm, slots=2, fault_injector=inj) as srv:
            f = srv.submit(p, 6)
            with pytest.raises(FaultInjected):
                f.result(60)
            assert srv._pool.blocks_in_use == 0
            got = srv.generate(p, 6, timeout=60)
        assert got == lm.generate(p, max_new_tokens=6)
        assert srv.metrics.snapshot().get("failed") == 1

    def test_one_token_request_releases_blocks_at_prefill(self):
        lm = _lm()
        p = [5, 9, 2]
        expect = lm.generate(p, max_new_tokens=1)
        with _paged(lm) as srv:
            got = srv.generate(p, 1, timeout=60)
            assert srv._pool.blocks_in_use == 0
        assert got == expect


class TestPagedGuards:
    def test_oversize_for_slot_table_shed_at_submit(self):
        """A caller-tuned max_blocks_per_slot below ceil(max_len/bs) is
        a hard per-request ceiling too: an oversize request sheds
        loudly at submit instead of crashing the admission thread on
        the block-table write."""
        lm = _lm()
        with _paged(lm, max_blocks_per_slot=2) as srv:
            with pytest.raises(ServerOverloadedError, match="table"):
                srv.submit(list(range(1, 10)), 5)
            got = srv.generate([5, 1], 4, timeout=60)
            assert srv.metrics.snapshot()["shed_blocks"] == 1
        assert got == lm.generate([5, 1], max_new_tokens=4)


class TestChunkedPrefill:
    def test_chunk_size_guards(self):
        lm = _lm_small()
        # 1-row chunks take XLA:CPU's gemv path (different accumulation
        # order) — the same floor every padding bucket enforces
        with pytest.raises(ValueError, match="gemv|>= 2"):
            ContinuousDecodeServer(lm, chunked_prefill=1)
        with pytest.raises(ValueError, match="max_len"):
            ContinuousDecodeServer(lm, chunked_prefill=1000)

    def test_chunked_equals_one_shot_fixed(self):
        """Prompt lengths spanning below/at/above the chunk size (and a
        single-token prompt) through ONE chunked server: every stream
        bit-identical to the pinned generate() reference."""
        lm = _lm_small()
        rng = np.random.default_rng(4)
        cases = [rng.integers(1, 64, n).tolist()
                 for n in (1, 3, 4, 5, 11, 16)]
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8, 16),
                                    chunked_prefill=4) as srv:
            for p in cases:
                assert srv.generate(p, 7, timeout=120) == \
                    lm.generate(p, max_new_tokens=7)
            snap = srv.metrics.snapshot()
        # the chunk SIZING RULE: prompts longer than one chunk run
        # ceil(plen/C) chunk dispatches; prompts that fit in one chunk
        # take the cheaper one-shot bucket program (zero chunks)
        assert snap["chunk_dispatches"] == sum(
            -(-len(p) // 4) for p in cases if len(p) > 4)

    def test_chunked_equals_one_shot_paged(self):
        lm = _lm_small()
        rng = np.random.default_rng(5)
        cases = [rng.integers(1, 64, n).tolist() for n in (1, 4, 9, 14)]
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(16,),
                                    paged=True, block_size=4,
                                    n_blocks=40,
                                    chunked_prefill=4) as srv:
            for p in cases:
                assert srv.generate(p, 7, timeout=120) == \
                    lm.generate(p, max_new_tokens=7)
            assert srv._pool.blocks_in_use == 0

    def test_chunked_join_equals_solo(self):
        """The join==solo pin EXTENDED: a long-prompt joiner prefilling
        in chunks beside live decoders changes nobody's bits — neither
        its own nor its co-residents'."""
        lm = _lm_small()
        rng = np.random.default_rng(6)
        pa = rng.integers(1, 64, 4).tolist()
        pb = rng.integers(1, 64, 15).tolist()     # the long joiner
        pc = rng.integers(1, 64, 3).tolist()
        with ContinuousDecodeServer(lm, slots=3, prompt_buckets=(8, 16),
                                    chunked_prefill=4) as srv:
            solo = {k: srv.generate(p, n, timeout=120)
                    for k, (p, n) in {"a": (pa, 12), "b": (pb, 10),
                                      "c": (pc, 8)}.items()}
            fa = srv.submit(pa, 12)
            time.sleep(0.03)                      # a is decoding...
            fb = srv.submit(pb, 10)               # ...b chunks in beside
            fc = srv.submit(pc, 8)
            assert fa.result(120) == solo["a"]
            assert fb.result(120) == solo["b"]
            assert fc.result(120) == solo["c"]

    def test_chunked_prefix_hit_saves_chunk_dispatches(self):
        """Chunked prefill COMPOSES with the prefix cache — and closes
        the PR 8 compute-reuse seam: a full-prefix hit re-runs ONE
        chunk (the final row, for its logits) instead of the whole
        prompt, streams bit-identical and hit counters live."""
        lm = _lm_small()
        rng = np.random.default_rng(7)
        p = rng.integers(1, 64, 11).tolist()      # 2 full blocks + tail
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(16,),
                                    paged=True, block_size=4,
                                    n_blocks=40, prefix_cache=False,
                                    chunked_prefill=4) as srv:
            unshared = srv.generate(p, 8, timeout=120)
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(16,),
                                    paged=True, block_size=4,
                                    n_blocks=40,
                                    chunked_prefill=4) as srv:
            first = srv.generate(p, 8, timeout=120)
            c1 = srv.metrics.snapshot()["chunk_dispatches"]
            again = srv.generate(p, 8, timeout=120)
            snap = srv.metrics.snapshot()
        assert first == unshared and again == unshared
        assert c1 == 3                  # ceil(11/4) chunks, no hit
        assert snap["chunk_dispatches"] - c1 == 1   # full hit: 1 chunk
        assert snap["prefix_rows_hit"] >= 8

    def test_chunked_shared_prefix_streams_unperturbed(self):
        """Two concurrent streams behind one system prefix, chunked +
        paged: shared leading blocks + write-window gating change WHERE
        rows live and WHAT gets recomputed, never any stream's bits."""
        lm = _lm_small()
        rng = np.random.default_rng(8)
        sysp = rng.integers(1, 64, 8).tolist()
        pa = sysp + rng.integers(1, 64, 3).tolist()
        pb = sysp + rng.integers(1, 64, 2).tolist()
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(16,),
                                    paged=True, block_size=4,
                                    n_blocks=40, prefix_cache=False,
                                    chunked_prefill=4) as srv:
            ra0 = srv.generate(pa, 24, timeout=120)
            rb0 = srv.generate(pb, 8, timeout=120)
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(16,),
                                    paged=True, block_size=4,
                                    n_blocks=40,
                                    chunked_prefill=4) as srv:
            fa = srv.submit(pa, 24)
            # chunked commit is DEFERRED to the final chunk (a failed
            # chunk must never leave garbage blocks matchable): wait for
            # a's blocks to become matchable, then join b while a still
            # DECODES — co-resident prefix reuse, not sequential
            deadline = time.monotonic() + 30
            while srv.metrics.snapshot()["prefix_rows_total"] < len(pa) \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            fb = srv.submit(pb, 8)
            ra, rb = fa.result(120), fb.result(120)
            snap = srv.metrics.snapshot()
            assert srv._pool.blocks_in_use == 0
        assert ra == ra0 and rb == rb0
        assert snap["prefix_rows_hit"] >= 8

    def test_chunked_one_token_request_releases_at_prefill(self):
        lm = _lm_small()
        p = [5, 9, 2, 7, 1]
        expect = lm.generate(p, max_new_tokens=1)
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    paged=True, block_size=4,
                                    n_blocks=20,
                                    chunked_prefill=2) as srv:
            assert srv.generate(p, 1, timeout=120) == expect
            assert srv._pool.blocks_in_use == 0

    def test_mid_prefill_deadline_eviction_releases_blocks(self):
        """A deadline expiring DURING chunked prefill evicts the slot
        between iterations: future fails, blocks release, the server
        keeps serving."""
        from deeplearning4j_tpu_torch.common.resilience import FaultInjector
        from deeplearning4j_tpu_torch.serving import DeadlineExceededError
        lm = _lm_small()
        rng = np.random.default_rng(10)
        p = rng.integers(1, 64, 16).tolist()
        inj = FaultInjector(seed=3).plan(
            "serve.batch", on_calls=range(0, 200), times=200,
            delay=0.03, exc=None)
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(16,),
                                    paged=True, block_size=4,
                                    n_blocks=40, chunked_prefill=2,
                                    fault_injector=inj) as srv:
            # warm the compile OFF the doomed request's clock (delay
            # plan paces every dispatch; compile only the first)
            srv.generate([1, 2], 2, deadline_ms=600_000, timeout=120)
            doomed = srv.submit(p, 8, deadline_ms=60)   # 8 chunks x30ms
            with pytest.raises(DeadlineExceededError):
                doomed.result(120)
            deadline = time.monotonic() + 10
            while srv._pool.blocks_in_use and time.monotonic() < deadline:
                time.sleep(0.01)
            assert srv._pool.blocks_in_use == 0
            assert srv.metrics.snapshot()["shed_deadline"] == 1


class TestServiceRateEstimator:
    def test_warm_up_guard_and_prediction(self):
        est = ServiceRateEstimator(slots=4, min_samples=4)
        assert not est.ready
        assert est.predict_seconds(100, 10) is None
        for _ in range(4):
            est.observe(4, 0.01, active=4)      # 4 slots, 10ms/iter
        assert est.ready
        assert est.seconds_per_iteration == pytest.approx(0.01)
        assert est.tokens_per_second == pytest.approx(400.0)
        # 100 backlog tokens at 400 tok/s + 10 own iterations
        assert est.predict_seconds(100, 10) == pytest.approx(0.35)

    def test_median_absorbs_compile_outlier(self):
        """One compile-sized sample (1000x an iteration) must not move
        predictions — the rolling median, unlike an EWMA, shrugs it
        off."""
        est = ServiceRateEstimator(slots=2, min_samples=2)
        for _ in range(9):
            est.observe(2, 0.002, active=2)
        est.observe(2, 2.0, active=2)           # the compile spike
        assert est.seconds_per_iteration == pytest.approx(0.002)

    def test_zero_token_iterations_lengthen_but_never_ready(self):
        est = ServiceRateEstimator(slots=2, min_samples=2)
        for _ in range(50):
            est.observe(0, 0.005)               # chunk-only passes
        assert not est.ready                    # no token-bearing iters

    def test_controller_guards(self):
        with pytest.raises(ValueError, match="conservatism"):
            AdmissionController(conservatism=0.5)
        ac = AdmissionController(min_samples=1, slots=2)
        assert not ac.should_shed(10_000, 100, 0.001)   # cold: never
        ac.estimator.observe(2, 0.01, active=2)
        assert ac.should_shed(10_000, 100, 0.001)
        assert not ac.should_shed(10_000, 100, None)    # no deadline

    def test_variance_margin_widens_predictions(self):
        """High-variance acceptance (the speculative regime: per-slot
        rate swinging 1..K) must make predictions MORE conservative
        than the mean rate implies — the margined rate sits below the
        EWMA mean, never below the structural 1.0 floor, and a steady
        stream (plain decode: every sample exactly 1.0) pays nothing."""
        est = ServiceRateEstimator(slots=2, min_samples=4, margin=1.0)
        for t in (4, 1, 4, 1, 4, 1, 4, 1):      # thrash-shaped stream
            est.observe(t, 0.01, active=1)
        cons = est.tokens_per_slot_conservative
        assert 1.0 <= cons < est._tok_slot
        # zero-variance stream: margin is free, any margin value
        steady = ServiceRateEstimator(slots=2, min_samples=4, margin=5.0)
        for _ in range(10):
            steady.observe(2, 0.01, active=2)
        assert steady.tokens_per_slot_conservative \
            == steady._tok_slot == 1.0
        # wider margin => longer (or equal) predictions, same samples
        wide = ServiceRateEstimator(slots=2, min_samples=4, margin=3.0)
        for t in (4, 1, 4, 1, 4, 1, 4, 1):
            wide.observe(t, 0.01, active=1)
        assert wide.predict_seconds(100, 10) \
            >= est.predict_seconds(100, 10)
        with pytest.raises(ValueError, match="margin"):
            ServiceRateEstimator(margin=-1.0)

    def test_variance_margin_never_sheds_feasible_solo_property(self):
        """The never-sheds-feasible-solo invariant survives ANY margin:
        whatever high-variance sample stream the estimator saw, a
        request whose deadline covers its WORST-CASE solo run
        (own_units x s_iter — one token per iteration, the speculative
        floor: every round lands at least its bonus token) is never
        shed on an idle server. Structural, because the margined rate
        is floored at 1.0 token/slot/iteration — property-tested over
        random streams and margins."""
        rng = np.random.default_rng(12)
        for trial in range(20):
            margin = float(rng.uniform(0.0, 4.0))
            ac = AdmissionController(conservatism=1.0, min_samples=4,
                                     slots=int(rng.integers(1, 8)),
                                     margin=margin)
            k = int(rng.integers(2, 9))
            for _ in range(int(rng.integers(8, 40))):
                # per-slot rates in [1, K]: the speculative envelope
                active = int(rng.integers(1, ac.estimator.slots + 1))
                per_slot = int(rng.integers(1, k + 1))
                ac.estimator.observe(per_slot * active,
                                     float(rng.uniform(0.002, 0.05)),
                                     active=active)
            own = int(rng.integers(1, 50))
            worst_solo = own * ac.estimator.seconds_per_iteration
            assert not ac.should_shed(0, own, worst_solo), (
                f"trial {trial}: margin {margin} shed a feasible solo "
                f"request")


class TestDeadlineAwareAdmission:
    def test_sheds_predicted_at_submit(self):
        lm = _lm_small()
        ac = AdmissionController(conservatism=1.0, min_samples=2)
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    admission=ac) as srv:
            for _ in range(3):                  # warm the estimator
                srv.generate([1, 2, 3], 6, timeout=120)
            assert ac.estimator.ready
            with pytest.raises(ServerOverloadedError,
                               match="predicted"):
                srv.submit([1, 2, 3], 40, deadline_ms=1)
            snap = srv.metrics.snapshot()
        assert snap["shed_predicted"] == 1
        assert snap["service_rate_tokens_per_sec"] is not None

    def test_conservatism_invariant_property(self):
        """The predictor never sheds a request that solo execution
        would have completed within deadline: random feasible requests
        against an IDLE warmed server (deadline = 3x measured solo
        time, floored well above scheduler jitter) must all admit and
        complete in time. The margin is weather, not semantics: the
        shared-CPU host runs back-to-back identical work >2x apart
        (measured, PERF r12), so a 2x budget flakes on the
        COMPLETION half of the assertion while the shedding half —
        the property under test — was never in doubt."""
        lm = _lm_small()
        rng = np.random.default_rng(11)
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    admission=AdmissionController(
                                        min_samples=4)) as srv:
            for _ in range(3):                  # warm compile+estimator
                srv.generate([1, 2, 3], 8, timeout=120)
            for _ in range(8):
                p = rng.integers(1, 64, int(rng.integers(1, 8))).tolist()
                n = int(rng.integers(2, 14))
                t0 = time.monotonic()
                solo = srv.generate(p, n, timeout=120)  # idle => solo
                solo_ms = (time.monotonic() - t0) * 1e3
                got = srv.generate(p, n,
                                   deadline_ms=max(3 * solo_ms, 250),
                                   timeout=120)
                assert got == solo
            snap = srv.metrics.snapshot()
        assert snap["shed_predicted"] == 0
        assert snap.get("evicted_mid_decode", 0) == 0

    def test_admission_error_histogram_and_exposition(self):
        from deeplearning4j_tpu_torch.obs import MetricsRegistry
        from deeplearning4j_tpu_torch.serving import ServingMetrics
        lm = _lm_small()
        reg = MetricsRegistry()
        metrics = ServingMetrics(registry=reg, name="adm")
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    metrics=metrics,
                                    admission=AdmissionController(
                                        min_samples=2)) as srv:
            for _ in range(4):
                srv.generate([1, 2, 3], 6, timeout=120)
        snap = metrics.snapshot()
        # estimator warmed after request 1-2: later completions carry a
        # prediction, so the signed error histogram has mass
        assert snap["admission_error_ms_count"] >= 1
        assert snap["admission_error_ms_p50"] is not None
        text = reg.prometheus_text()
        assert "# TYPE serving_adm_admission_error_ms histogram" in text
        assert "serving_adm_service_rate_tokens_per_sec" in text


class TestPrefixPriorityAdmission:
    def _srv(self, lm, **kw):
        kw.setdefault("slots", 1)
        kw.setdefault("prompt_buckets", (8, 16))
        kw.setdefault("block_size", 4)
        kw.setdefault("n_blocks", 40)
        kw.setdefault("chunked_prefill", 4)
        return ContinuousDecodeServer(lm, paged=True, **kw)

    def test_prefix_hit_overtakes_cold_prompt(self):
        """slots=1, the slot held by a long request: a cold prompt
        queued FIRST is overtaken by a later full-prefix-hit request —
        completion order flips, `admitted_prefix_priority` counts the
        reorder, and BOTH streams stay bit-identical to solo."""
        lm = _lm_small()
        sysp = list(range(1, 9))                 # 2 full blocks
        order = []
        with self._srv(lm) as srv:
            srv.generate(sysp + [9], 4, timeout=120)   # prime the index
            fa = srv.submit(list(range(20, 28)), 30)   # holds the slot
            cold = list(range(30, 42))
            hit = sysp + [13]
            fb = srv.submit(cold, 6)
            fb.add_done_callback(lambda f: order.append("cold"))
            fc = srv.submit(hit, 6)
            fc.add_done_callback(lambda f: order.append("hit"))
            fa.result(120)
            rb, rc = fb.result(120), fc.result(120)
            snap = srv.metrics.snapshot()
        assert rb == lm.generate(cold, max_new_tokens=6)
        assert rc == lm.generate(hit, max_new_tokens=6)
        assert order == ["hit", "cold"]
        assert snap["admitted_prefix_priority"] == 1

    def test_priority_off_keeps_fifo(self):
        """prefix_priority=False: the same workload admits in FIFO
        order and the counter never moves."""
        lm = _lm_small()
        sysp = list(range(1, 9))
        order = []
        with self._srv(lm, prefix_priority=False) as srv:
            srv.generate(sysp + [9], 4, timeout=120)
            fa = srv.submit(list(range(20, 28)), 30)
            fb = srv.submit(list(range(30, 42)), 6)
            fb.add_done_callback(lambda f: order.append("cold"))
            fc = srv.submit(sysp + [13], 6)
            fc.add_done_callback(lambda f: order.append("hit"))
            fa.result(120), fb.result(120), fc.result(120)
            snap = srv.metrics.snapshot()
        assert order == ["cold", "hit"]
        assert snap["admitted_prefix_priority"] == 0

    def test_cold_prompt_never_takes_priority(self):
        """A prompt with NO resident prefix stays in the FIFO queue
        even with priority armed (the line is for hits only)."""
        lm = _lm_small()
        with self._srv(lm) as srv:
            got = srv.generate(list(range(30, 42)), 4, timeout=120)
            snap = srv.metrics.snapshot()
        assert got == lm.generate(list(range(30, 42)), max_new_tokens=4)
        assert snap["admitted_prefix_priority"] == 0

    def test_priority_burst_cannot_starve_cold_prompts(self):
        """After _PRIO_BURST consecutive overtakes the primary head
        gets one turn: 6 parked hits + 1 parked cold on a slots=1
        server admit as hit x4, cold, hit x2 — sustained hit traffic
        degrades a cold prompt's position, never parks it forever."""
        lm = _lm_small()
        sysp = list(range(1, 9))
        order = []
        with self._srv(lm, max_queue=16) as srv:
            srv.generate(sysp + [9], 4, timeout=120)   # prime the index
            fa = srv.submit(list(range(20, 28)), 30)   # holds the slot
            deadline = time.monotonic() + 20
            while not any(srv._slot_req) and time.monotonic() < deadline:
                time.sleep(0.002)
            cold = list(range(30, 42))
            fc = srv.submit(cold, 4)
            fc.add_done_callback(lambda f: order.append("cold"))
            hits = []
            for i in range(6):
                f = srv.submit(sysp + [10 + i], 4)
                f.add_done_callback(
                    lambda _f, j=i: order.append(f"hit{j}"))
                hits.append(f)
            fa.result(120)
            fc.result(120)
            for f in hits:
                f.result(120)
            snap = srv.metrics.snapshot()
        assert order == ["hit0", "hit1", "hit2", "hit3", "cold",
                         "hit4", "hit5"]
        # hits 4-5 popped against an EMPTY primary queue (the cold
        # request was already served): no overtake, not counted
        assert snap["admitted_prefix_priority"] == 4

    def test_idle_server_serves_priority_submit(self):
        """A prefix-hit submit landing on an IDLE server rides the
        priority line through the idle wait (the blocking get watches
        only the primary queue — the poll must see the parked line)
        and decodes bit-identically."""
        lm = _lm_small()
        sysp = list(range(1, 9))
        with self._srv(lm) as srv:
            srv.generate(sysp + [9], 4, timeout=120)   # prime the index
            time.sleep(0.12)    # let the loop settle into its idle wait
            got = srv.generate(sysp + [13], 5, timeout=120)
        assert got == lm.generate(sysp + [13], max_new_tokens=5)

    def test_priority_line_shares_queue_budget(self):
        """max_queue bounds the SUM of the primary queue and the
        priority line, both ways: parked hits consume the backpressure
        budget cold submits see, and vice versa — two lines must not
        stack 2x the operator's bound."""
        lm = _lm_small()
        sysp = list(range(1, 9))
        with self._srv(lm, max_queue=2) as srv:
            srv.generate(sysp + [9], 4, timeout=120)   # prime the index
            fa = srv.submit(list(range(20, 28)), 30)   # holds the slot
            deadline = time.monotonic() + 20
            while not any(srv._slot_req) and time.monotonic() < deadline:
                time.sleep(0.002)
            f1 = srv.submit(sysp + [13], 4)            # parks: prio 1/2
            f2 = srv.submit(sysp + [14], 4)            # parks: prio 2/2
            with pytest.raises(ServerOverloadedError, match="queue full"):
                srv.submit(list(range(30, 38)), 4)     # cold: budget gone
            with pytest.raises(ServerOverloadedError, match="queue full"):
                srv.submit(sysp + [15], 4)             # hit: budget gone
            fa.result(120)
            r1, r2 = f1.result(120), f2.result(120)
            snap = srv.metrics.snapshot()
        assert r1 == lm.generate(sysp + [13], max_new_tokens=4)
        assert r2 == lm.generate(sysp + [14], max_new_tokens=4)
        assert snap["shed_queue_full"] == 2

    def test_deadline_expires_in_priority_line(self):
        """Priority-line wait is queue wait: the deadline sweep fails a
        parked priority request and counts the shed."""
        from deeplearning4j_tpu_torch.common.resilience import FaultInjector
        from deeplearning4j_tpu_torch.serving import DeadlineExceededError
        lm = _lm_small()
        sysp = list(range(1, 9))
        inj = FaultInjector(seed=9).plan(
            "serve.batch", on_calls=range(0, 300), times=300,
            delay=0.02, exc=None)
        with self._srv(lm, fault_injector=inj) as srv:
            srv.generate(sysp + [9], 4, deadline_ms=600_000,
                         timeout=120)                  # prime + compile
            fa = srv.submit(list(range(20, 28)), 40)   # slot held long
            # wait until fa actually OWNS the slot: a priority submit
            # racing fa's queue pop would legitimately overtake it and
            # win the slot instead of parking
            deadline = time.monotonic() + 20
            while not any(srv._slot_req) and time.monotonic() < deadline:
                time.sleep(0.002)
            doomed = srv.submit(sysp + [13], 6, deadline_ms=100)
            with pytest.raises(DeadlineExceededError,
                               match="priority|before prefill"):
                doomed.result(120)
            fa.result(120)
            snap = srv.metrics.snapshot()
        assert snap["shed_deadline"] == 1
        # the doomed request never ADMITTED: an expired pop must not
        # count as a reordered admission
        assert snap["admitted_prefix_priority"] == 0


class TestBrownoutPolicy:
    def test_decide_thresholds(self):
        bp = BrownoutPolicy(classes={"batch": (0.5, 0.9)})
        assert bp.decide("batch", 0.1) == ACCEPT
        assert bp.decide("batch", 0.5) == DEFER
        assert bp.decide("batch", 0.95) == SHED
        # unlisted classes use the never-defer default
        assert bp.decide("interactive", 0.95) == ACCEPT

    def test_attainment_brownout(self):
        bp = BrownoutPolicy(classes={"batch": (0.5, 0.9)},
                            min_attainment=0.8)
        assert bp.decide("batch", 0.0, attainment=0.9) == ACCEPT
        assert bp.decide("batch", 0.0, attainment=0.5) == DEFER
        assert bp.decide("batch", 0.0, attainment=None) == ACCEPT

    def test_shed_below_defer_raises(self):
        with pytest.raises(ValueError, match="defer"):
            BrownoutPolicy(classes={"x": (0.9, 0.5)})

    def test_deferred_class_parks_and_still_decodes_identically(self):
        """batch-class requests defer (counter moves), interactive
        requests do not, and deferred work still produces the pinned
        bit-identical stream once pressure allows."""
        lm = _lm_small()
        bp = BrownoutPolicy(classes={"batch": (0.0, 1.01)})
        rng = np.random.default_rng(12)
        pi = rng.integers(1, 64, 4).tolist()
        pb = rng.integers(1, 64, 5).tolist()
        expect_i = lm.generate(pi, max_new_tokens=8)
        expect_b = lm.generate(pb, max_new_tokens=6)
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    brownout=bp) as srv:
            fb = srv.submit(pb, 6, klass="batch")   # defers (>= 0.0)
            fi = srv.submit(pi, 8)                  # default: accepted
            assert fi.result(120) == expect_i
            assert fb.result(120) == expect_b
            snap = srv.metrics.snapshot()
        assert snap["deferred"] == 1
        assert snap["shed_brownout"] == 0

    def test_brownout_shed_class(self):
        lm = _lm_small()
        bp = BrownoutPolicy(classes={"batch": (0.0, 0.0)})
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    brownout=bp) as srv:
            with pytest.raises(ServerOverloadedError, match="brownout"):
                srv.submit([1, 2, 3], 4, klass="batch")
            got = srv.generate([1, 2, 3], 4, timeout=120)  # default ok
            snap = srv.metrics.snapshot()
        assert snap["shed_brownout"] == 1
        assert got == lm.generate([1, 2, 3], max_new_tokens=4)

    def test_fail_fast_stop_fails_deferred(self):
        """stop(drain=False) with requests parked in the deferred line:
        the parked futures fail with ServerClosedError and the loop
        exits promptly — deferred requests count as _busy(), so leaving
        them parked would spin the serve thread forever (the PR 8
        memory-waiter livelock, extended)."""
        from deeplearning4j_tpu_torch.common.resilience import FaultInjector
        lm = _lm_small()
        bp = BrownoutPolicy(classes={"batch": (0.0, 1.01)})
        inj = FaultInjector(seed=4).plan(
            "serve.batch", on_calls=range(0, 200), times=200,
            delay=0.02, exc=None)
        srv = ContinuousDecodeServer(lm, slots=1, prompt_buckets=(8,),
                                     brownout=bp,
                                     fault_injector=inj).start()
        try:
            fa = srv.submit([1, 2, 3], 12)      # occupies the one slot
            time.sleep(0.1)
            fbs = [srv.submit([4, 5], 6, klass="batch")
                   for _ in range(3)]           # all park deferred
            assert srv.metrics.snapshot()["deferred"] == 3
        finally:
            srv.stop(drain=False, timeout=60)
        assert srv._thread is None              # loop actually exited
        assert fa.result(1)                     # busy slot finished
        for f in fbs:
            with pytest.raises(ServerClosedError):
                f.result(1)


class TestOverloadDrain:
    def test_drain_stop_bounded_under_saturation(self):
        """stop(drain=True) on a SATURATED paged server — slow decode,
        deep deadline-carrying backlog, a request parked on the memory
        gate — must drain bounded by the remaining work: expired
        backlog sheds at admission instead of decoding, parked waiters
        admit as blocks free, and EVERY future resolves."""
        from deeplearning4j_tpu_torch.common.resilience import FaultInjector
        lm = _lm_small()
        rng = np.random.default_rng(14)
        inj = FaultInjector(seed=5).plan(
            "serve.batch", on_calls=range(1, 400), times=400,
            delay=0.01, exc=None)
        srv = ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                     paged=True, block_size=4,
                                     n_blocks=8, max_queue=64,
                                     fault_injector=inj).start()
        futs = []
        try:
            p1 = rng.integers(1, 64, 7).tolist()
            futs.append(srv.submit(p1, 16))     # 6 of 8 blocks
            time.sleep(0.05)
            futs.append(srv.submit(p1, 16))     # parks on the mem gate
            # deep deadline-carrying backlog: most of it EXPIRES in the
            # queue while the head decodes — drain must shed it at
            # admission, not decode it
            for _ in range(24):
                futs.append(srv.submit(
                    rng.integers(1, 64, 3).tolist(), 8,
                    deadline_ms=100))
        finally:
            t0 = time.monotonic()
            srv.stop(drain=True, timeout=90)
            drain_s = time.monotonic() - t0
        assert srv._thread is None, "drain did not complete"
        assert drain_s < 60
        resolved = 0
        for f in futs:
            try:
                f.result(1)
                resolved += 1
            except Exception:       # noqa: BLE001 — shed/expired: fine
                resolved += 1
        assert resolved == len(futs)
        assert srv._pool.blocks_in_use == 0


class TestFusedPrograms:
    def test_window_k_floor(self):
        """k=1 is the plain decode program — the factories refuse it
        (scan overhead for nothing), mirroring the chunk-size floor's
        loud-constructor style."""
        from deeplearning4j_tpu_torch.models.zoo.transformer import (
            make_fused_decode_fn, make_paged_fused_decode_fn)
        with pytest.raises(ValueError, match=">= 2"):
            make_fused_decode_fn(2, 1)
        with pytest.raises(ValueError, match=">= 2"):
            make_paged_fused_decode_fn(2, 8, 1)

    def test_server_flag_validation(self):
        with pytest.raises(ValueError, match="fused_serve"):
            ContinuousDecodeServer(_lm(), slots=2, prompt_buckets=(8,),
                                   fused_serve=0)


class TestFusedBitIdentity:
    def test_solo_and_join_bit_identical_across_k(self):
        """For K in {2,4,8}: a fused solo stream matches plain decode,
        and a request JOINING a running fused batch (admitted at a
        window boundary) matches its own solo stream — the
        continuous-decode pin under windowed advance."""
        lm = _lm()
        rng = np.random.default_rng(4)
        pa = rng.integers(1, 64, 5).tolist()
        pb = rng.integers(1, 64, 8).tolist()
        plain = lm.generate(pa, 10, use_cache=True)
        for k in (2, 4, 8):
            with ContinuousDecodeServer(
                    lm, slots=4, prompt_buckets=(4, 8),
                    fused_serve=k) as srv:
                solo = srv.generate(pa, 10, timeout=60)
                flong = srv.submit(pb, 24)      # running fused batch
                time.sleep(0.05)
                fa = srv.submit(pa, 10)         # joins at a boundary
                joined = fa.result(60)
                flong.result(60)
            assert solo == plain
            assert joined == solo

    def test_paged_bit_identical_across_k(self):
        """Same pin over the PAGED layout: the scanned window threads
        the block-table frontier through the carry and never crosses
        the reservation (pool fully drains after)."""
        lm = _lm()
        p = _prompt()
        plain = lm.generate(p, 14, use_cache=True)
        for k in (2, 4, 8):
            with ContinuousDecodeServer(
                    lm, slots=2, prompt_buckets=(8,), paged=True,
                    block_size=4, n_blocks=40, fused_serve=k) as srv:
                got = srv.generate(p, 14, timeout=60)
                flong = srv.submit(_prompt(9, 6), 18)
                fa = srv.submit(p, 14)
                joined = fa.result(60)
                flong.result(60)
                assert srv._pool.blocks_in_use == 0
            assert got == plain
            assert joined == plain

    def test_swap_drain_fused(self):
        """Dual-version drain under fused windows: one fused window
        per live version per pass — the in-flight stream finishes on
        pre-swap params bit-identical to a pre-swap solo run while a
        post-swap request decodes the new params."""
        lm1, lm2 = _lm(3), _lm(11)
        rng = np.random.default_rng(10)
        pa = rng.integers(1, 64, 4).tolist()
        pb = rng.integers(1, 64, 4).tolist()
        with ContinuousDecodeServer(
                lm1, slots=2, prompt_buckets=(4,),
                fused_serve=4) as srv:
            solo_old = srv.generate(pa, 14, timeout=60)
            fa = srv.submit(pa, 14)
            time.sleep(0.03)                  # pa decoding on v0
            srv.swap(lm2)
            fb = srv.submit(pb, 5)            # admitted on v1
            ra, rb = fa.result(60), fb.result(60)
        assert ra == solo_old
        expect_new = lm2.generate_batch(np.asarray([pb], np.int32),
                                        max_new_tokens=5)
        assert rb == expect_new[0].tolist()
        assert srv.metrics.snapshot().get("failed", 0) == 0

    def test_k1_is_zero_behavior_change(self):
        """fused_serve=1 (and the default None) build NO window
        program and count NO windows — the plain path, untouched."""
        lm = _lm()
        p = _prompt()
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    fused_serve=1) as srv:
            assert srv._window_step is None
            got = srv.generate(p, 10, timeout=60)
        snap = srv.metrics.snapshot()
        assert got == lm.generate(p, 10, use_cache=True)
        assert snap["fused_windows"] == 0
        assert snap["iterations_per_dispatch"] == pytest.approx(1.0)


class TestFusedDispatchCount:
    @pytest.mark.parametrize("max_new,k", [(13, 4), (12, 4), (17, 8)])
    def test_exactly_ceil_iters_over_k_dispatches(self, max_new, k):
        """Solo stream: max_new-1 decode iterations (the first token
        comes from prefill) in exactly ceil((max_new-1)/K) decode
        dispatches — the A/B the amortization claim rests on."""
        lm = _lm()
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    fused_serve=k) as srv:
            got = srv.generate(_prompt(), max_new, timeout=60)
        assert got == lm.generate(_prompt(), max_new, use_cache=True)
        snap = srv.metrics.snapshot()
        iters = max_new - 1
        assert snap["decode_iterations"] == iters
        assert snap["dispatches"] == math.ceil(iters / k)
        assert snap["fused_windows"] == snap["dispatches"]
        assert snap["iterations_per_dispatch"] == pytest.approx(
            iters / math.ceil(iters / k))


class TestFusedDeadlines:
    def test_window_ok_gate(self):
        """The clamp's decision table, directly: no deadlines -> fused;
        any deadline + cold EWMA -> plain (conservative warm-up); ample
        headroom -> fused; headroom under K iterations -> plain."""

        class R:
            def __init__(self, deadline):
                self.deadline = deadline

        srv = ContinuousDecodeServer(_lm(), slots=2, prompt_buckets=(8,),
                                     fused_serve=4)
        try:
            now = time.monotonic()
            assert srv._fused_window_ok([(0, R(None))])
            assert not srv._fused_window_ok([(0, R(now + 60.0))])  # cold
            srv._iter_ewma = 0.01
            assert srv._fused_window_ok([(0, R(now + 60.0))])
            assert not srv._fused_window_ok([(0, R(now + 0.02))])
            # the TIGHTEST deadline governs a mixed batch
            assert not srv._fused_window_ok(
                [(0, R(now + 60.0)), (1, R(now + 0.02))])
        finally:
            srv.stop()

    def test_tight_horizon_falls_back_to_plain(self):
        """With the EWMA seeded at 10 s/iteration, a 4 s-deadline
        request can never afford an 8-iteration window (the EWMA
        decays by at most 0.8^11 over the stream's 11 iterations, so
        the horizon stays above the headroom throughout): every round
        takes the plain path (fused_windows stays 0) and the stream
        still completes bit-identical."""
        lm = _lm()
        p = _prompt()
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    fused_serve=8) as srv:
            srv._iter_ewma = 10.0
            got = srv.generate(p, 12, deadline_ms=4_000, timeout=60)
        assert got == lm.generate(p, 12, use_cache=True)
        assert srv.metrics.snapshot()["fused_windows"] == 0

    def test_tight_deadline_evicted_at_plain_cadence(self):
        """A request whose token budget outlives its latency budget
        under fused_serve=8 is evicted by the boundary sweep no later
        than the K=1 cadence + one iteration of slack — the clamp
        forces plain rounds (per-iteration sweeps) once headroom drops
        below the window horizon, so eviction lateness is iteration
        granularity, not K-1 iterations of overshoot. Delay-only
        faults pace every dispatch at 20 ms so the cadences are
        distinguishable on wall clock: a mis-clamped window would
        overshoot by ~8 x 20 ms; the clamp keeps lateness under half
        a window."""
        lm = _lm()
        inj = FaultInjector(seed=6).plan(
            "serve.batch", on_calls=range(1, 300), times=300,
            delay=0.02, exc=None)
        with ContinuousDecodeServer(lm, slots=1, prompt_buckets=(8,),
                                    fault_injector=inj,
                                    fused_serve=8) as srv:
            # warm-up compiles BOTH decode programs off-clock (a loose
            # deadline starts plain while the EWMA is cold, then fuses
            # once it warms), so the doomed request's lateness measures
            # cadence, not first-dispatch compilation
            srv.generate(_prompt(), 12, deadline_ms=60_000, timeout=60)
            t0 = time.monotonic()
            f = srv.submit(_prompt(), 40, deadline_ms=100)
            with pytest.raises(DeadlineExceededError,
                               match="mid-decode"):
                f.result(60)
            late = (time.monotonic() - t0) - 0.1
        snap = srv.metrics.snapshot()
        assert snap["evicted_mid_decode"] == 1
        assert late < 0.1


class TestFusedComposition:
    def test_chunked_prefill_composes(self):
        """Chunk transitions land at window boundaries: a long prompt
        prefills chunk-at-a-time while a co-resident stream decodes in
        fused windows, and both streams stay bit-identical."""
        lm = _lm()
        rng = np.random.default_rng(7)
        long_p = rng.integers(1, 64, 24).tolist()
        short_p = rng.integers(1, 64, 4).tolist()
        with ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(4, 8, 32),
                chunked_prefill=8, fused_serve=4) as srv:
            fs = srv.submit(short_p, 16)
            time.sleep(0.03)                  # decoding mid-window
            fl = srv.submit(long_p, 8)        # chunked joiner
            rs, rl = fs.result(60), fl.result(60)
        assert rs == lm.generate(short_p, 16, use_cache=True)
        assert rl == lm.generate(long_p, 8, use_cache=True)


class TestFusedFaults:
    def test_terminal_fault_mid_window_fails_loudly_and_recovers(self):
        """Terminal fault at `serve.batch` on the first WINDOW dispatch
        (call 0 is the admission prefill): the occupied slot fails
        LOUDLY, device state resets, and the server serves the next
        request bit-identically — the PR 4 contract under windows."""
        lm = _lm()
        p = _prompt()
        inj = FaultInjector(seed=2).plan("serve.batch", on_call=1,
                                         exc=FaultInjected)
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    fault_injector=inj,
                                    fused_serve=4) as srv:
            f = srv.submit(p, 6)
            with pytest.raises(FaultInjected):
                f.result(60)
            got = srv.generate(p, 6, timeout=60)
        assert got == lm.generate(p, 6, use_cache=True)
        assert srv.metrics.snapshot().get("failed") == 1

    def test_retry_keeps_stream_bit_identical(self):
        """Transient fault before the first window dispatch: the retry
        re-runs the whole window (the injector site sits before the
        compiled call — donated buffers are untouched) and the stream
        is unchanged."""
        lm = _lm()
        p = _prompt()
        inj = FaultInjector(seed=1).plan("serve.batch", on_call=1,
                                         exc=FaultInjected)
        rp = RetryPolicy(max_retries=3, base_delay=0.001,
                         retryable=(ConnectionError,))
        with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                    fault_injector=inj, retry_policy=rp,
                                    fused_serve=4) as srv:
            got = srv.generate(p, 10, timeout=60)
        snap = srv.metrics.snapshot()
        assert got == lm.generate(p, 10, use_cache=True)
        assert snap.get("retries") == 1 and snap.get("failed", 0) == 0


class TestFusedEstimator:
    def test_window_feeds_k_per_iteration_samples(self):
        """The fan-out contract, deterministically: a K=8 window of
        0.8 s with 2 slots at full budget feeds 8 samples of
        (2 tokens, 0.1 s) — the median reads the PER-ITERATION time
        and readiness arrives after one window. One K-sized sample
        (the bug this satellite fixes) would leave the estimator cold
        for 8x longer AND inflate its median ~K-fold, shedding
        feasible work."""
        window_dt, k = 0.8, 8
        steps = np.asarray([8, 8, 0, 0])
        est = ServiceRateEstimator(slots=4)
        for i in range(k):
            t_i = int(np.sum(steps > i))
            est.observe(t_i, window_dt / k, t_i)
        assert est.samples == 8 and est.ready
        assert est.seconds_per_iteration == pytest.approx(0.1)
        assert est.tokens_per_slot_conservative == pytest.approx(1.0)
        bad = ServiceRateEstimator(slots=4)
        bad.observe(16, window_dt, 2)        # the one-sample mistake
        assert bad.samples == 1 and not bad.ready
        assert bad._s_iter == pytest.approx(0.8)   # ~K-fold inflation

    def test_ragged_window_tail_feeds_partial_samples(self):
        """A slot that exhausts its budget mid-window stops counting
        toward later per-iteration samples — token totals across the
        fan-out equal the window's realized tokens exactly."""
        steps = np.asarray([4, 2, 0])
        est = ServiceRateEstimator(slots=3, min_samples=1)
        for i in range(4):
            t_i = int(np.sum(steps > i))
            est.observe(t_i, 0.05, t_i)
        # samples only count token-bearing iterations: steps 0..3 all
        # carry tokens here (2, 2, 1, 1)
        assert est.samples == 4
        tok = sum(t for t, _ in est._win)
        assert tok == int(steps.sum())

    def test_server_estimator_stays_per_iteration_under_fused(self):
        """Integration: a fused K=8 server's admission estimator reads
        a per-iteration median comparable to a plain server's on the
        same workload — not ~8x it."""
        lm = _lm()
        p = _prompt()

        def run(**kw):
            adm = AdmissionController()
            with ContinuousDecodeServer(lm, slots=2, prompt_buckets=(8,),
                                        admission=adm, **kw) as srv:
                srv.generate(p, 20, timeout=60)     # warm-up/compile
                srv.generate(p, 20, timeout=60)
            return adm.estimator

        plain = run()
        fused = run(fused_serve=8)
        assert fused.ready
        assert fused.seconds_per_iteration < \
            4 * max(plain.seconds_per_iteration, 1e-4)


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_card_join_equals_solo_and_fused_graph_equals_plain(cuda, paged):
    """On the card, within one server and one shape: a request joining a
    running batch emits its solo stream bit for bit; a fused_serve=4
    server (one CUDA graph) gives the plain server's stream in
    ceil(iterations / 4) dispatches."""
    lm = TransformerLM(64, d_model=32, n_heads=2, n_layers=2, max_len=64,
                       seed=3, device="cuda")
    kw = dict(paged=True, block_size=4, n_blocks=40) if paged else {}
    rng = np.random.default_rng(4)
    pa = rng.integers(1, 64, 5).tolist()
    pb = rng.integers(1, 64, 8).tolist()
    with ContinuousDecodeServer(lm, slots=4, prompt_buckets=(8,),
                                fault_injector=_paced(), **kw) as srv:
        solo = srv.generate(pa, 10, timeout=120)
        flong = srv.submit(pb, 30)
        time.sleep(0.05)
        joined = srv.submit(pa, 10).result(120)
        flong.result(120)
    assert joined == solo
    with ContinuousDecodeServer(lm, slots=4, prompt_buckets=(8,),
                                fused_serve=4, **kw) as srv:
        got = srv.generate(pa, 10, timeout=120)
        snap = srv.metrics.snapshot()
    assert got == solo
    assert snap["fused_graphs"] == 1
    assert snap["dispatches"] == snap["fused_windows"] == math.ceil(9 / 4)
