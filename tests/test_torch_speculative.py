"""Speculative decoding on the port (serving/speculate.py, the verify
programs of models/zoo/transformer.py, `generate(draft=)`,
`generate_batch(draft=)` and `ContinuousDecodeServer(speculate=)`).

Two parts:
  * Against the JAX package, on the same numpy weights: the K-wide verify
    programs in both cache layouts (logits 1e-5, argmax, acceptance
    counts and new positions equal, the rows written equal, rejected rows
    dead), the speculative token streams of `generate` / `generate_batch`
    for both draft sources and K in {1, 2, 4, 8}, and the speculative
    server's streams, fixed and paged.
  * The reference's own pins, their bodies copied from
    tests/test_speculative.py and tests/test_paged.py (paged speculation)
    and run on the port's classes (torch's CPU, f32). The reference's
    `test_spec_metrics_reach_ui_storage` waits for the port of `ui/`
    (ROADMAP.md queue 1 item 22); the metrics it reads are pinned here by
    `test_metrics_record_speculation_shape`.
"""
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common.resilience import (FaultInjected,
                                                        FaultInjector,
                                                        RetryPolicy)
from deeplearning4j_tpu_torch.models.zoo import transformer as T
from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
from deeplearning4j_tpu_torch.serving import (ContinuousDecodeServer,
                                              DeadlineExceededError,
                                              ModelDraft, NGramDraft,
                                              ServingMetrics, Speculator)

V, DM, NH, NL, MAXLEN, BS = 96, 32, 2, 2, 64, 8
HD = DM // NH
S, K = 4, 4
ATOL = 1e-5


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    """The JAX transformer module and models (a target and a smaller draft
    model), their weights as numpy, and the port's models on them."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeplearning4j_tpu.models.zoo import transformer as J
    target = J.TransformerLM(V, d_model=DM, n_heads=NH, n_layers=NL,
                             max_len=MAXLEN, seed=0, dtype=jnp.float32)
    small = J.TransformerLM(V, d_model=16, n_heads=2, n_layers=1,
                            max_len=MAXLEN + 8, seed=5, dtype=jnp.float32)
    port = {}
    for name, m in (("target", target), ("small", small)):
        aux, blocks = jax.tree.map(np.asarray, (m.aux, m.blocks))
        port[name] = TransformerLM.from_jax_params(aux, blocks, m.n_heads,
                                                   device="cpu")
    return {"J": J, "jnp": jnp, "target": target, "small": small,
            "port": port}


def _i64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def _b(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.bool)


def _params(lm):
    return lm.aux, list(lm.blocks)


def _crafted_toks(run, first):
    """Drafts built from the program's own argmax, one probe per draft
    position: slot 0 accepts all K-1, slot 1 one, slot 2 none. `run(toks)`
    returns nxt [S, K] as numpy; toks[s, 0] is the slot's last token."""
    toks = np.array(first, np.int64)
    for i in range(K - 1):
        nxt = run(toks)
        toks[0, i + 1] = nxt[0, i]
        if i == 0:
            toks[1, 1] = nxt[1, 0]
            toks[2, 1] = (nxt[2, 0] + 1) % V
        if i == 1:
            toks[1, 2] = (nxt[1, 1] + 1) % V
    return toks


def _fixed_cache(seed):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((S, MAXLEN, NH, HD)).astype(np.float32),
             r.standard_normal((S, MAXLEN, NH, HD)).astype(np.float32))
            for _ in range(NL)]


def _port_cache(cache):
    """numpy [(k, v)] -> the port's cache with a zero spare slot / row."""
    out = []
    for k, v in cache:
        spare = np.zeros((1,) + k.shape[1:], np.float32)
        out.append({"k": torch.from_numpy(np.concatenate([k, spare])),
                    "v": torch.from_numpy(np.concatenate([v, spare]))})
    return out


def _check_verify(got, want, n_rows, port_cache, cache0, rows_written):
    nxt, n_acc, logits, _, pos = got
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[2]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[4]))
    for c, j, (k0, _) in zip(port_cache, want[3], cache0):
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name][:n_rows].numpy(),
                                       np.asarray(j[name]), rtol=0,
                                       atol=ATOL)
        changed = (c["k"][:n_rows] != torch.from_numpy(k0)).any(-1).any(-1)
        assert sorted(map(tuple, changed.nonzero().tolist())) == \
            sorted(rows_written)


def test_slot_verify_matches_jax(ref):
    J, jnp = ref["J"], ref["jnp"]
    lm = ref["port"]["target"]
    cache = _fixed_cache(1)
    pos = np.array([5, 20, 62, 9])
    active = np.array([True, True, True, False])
    first = np.random.default_rng(2).integers(0, V, (S, K))
    toks = _crafted_toks(lambda t: T.make_slot_verify_fn(NH, K)(
        *_params(lm), _port_cache(cache), _i64(pos), _i64(t),
        _b(active))[0].numpy(), first)
    jc = [{"k": jnp.asarray(k), "v": jnp.asarray(v)} for k, v in cache]
    want = J.make_slot_verify_fn(NH, K)(
        ref["target"].aux, ref["target"].blocks, jc,
        jnp.asarray(pos, jnp.int32), jnp.asarray(toks, jnp.int32),
        jnp.asarray(active))
    port = _port_cache(cache)
    got = T.make_slot_verify_fn(NH, K)(*_params(lm), port, _i64(pos),
                                      _i64(toks), _b(active))
    # slot 2's rows 64, 65 lie past the cache: only 62, 63 are written
    written = [(s, p) for s in range(3) for p in range(pos[s], pos[s] + K)
               if p < MAXLEN]
    _check_verify(got, want, S, port, cache, written)
    assert got[1].tolist() == [K - 1, 1, 0, 0]


def test_slot_verify_rejected_rows_are_dead(ref):
    """Rows past the accepted frontier are written but never read: the
    next verify from the new positions gives the same output whatever
    those rows hold."""
    lm = ref["port"]["target"]
    cache = _fixed_cache(3)
    pos = np.array([4, 10, 30, 2])
    active = np.ones(S, bool)
    first = np.random.default_rng(4).integers(0, V, (S, K))
    verify = T.make_slot_verify_fn(NH, K)
    toks = _crafted_toks(lambda t: verify(
        *_params(lm), _port_cache(cache), _i64(pos), _i64(t),
        _b(active))[0].numpy(), first)
    runs = []
    for scrub in (False, True):
        port = _port_cache(cache)
        nxt, n_acc, _, _, new_pos = verify(*_params(lm), port, _i64(pos),
                                           _i64(toks), _b(active))
        if scrub:
            for c in port:
                for s in range(S):
                    lo = int(new_pos[s])
                    c["k"][s, lo:] = 1e3
                    c["v"][s, lo:] = -1e3
        nxt_tok = nxt[torch.arange(S), n_acc]
        toks2 = np.zeros((S, K), np.int64)
        toks2[:, 0] = nxt_tok.numpy()
        runs.append(verify(*_params(lm), port, new_pos, _i64(toks2),
                           _b(active))[2])
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def test_paged_verify_matches_jax(ref):
    J, jnp = ref["J"], ref["jnp"]
    lm = ref["port"]["target"]
    NB, NBLK = 4, 20
    r = np.random.default_rng(5)
    arena = [(r.standard_normal((NBLK * BS, NH, HD)).astype(np.float32),
              r.standard_normal((NBLK * BS, NH, HD)).astype(np.float32))
             for _ in range(NL)]
    btabs = np.array([[3, 7, 0, 0], [1, 2, 4, 5], [9, 10, 11, 12],
                      [6, 8, 13, 14]])
    pos = np.array([6, 13, 27, 3])
    # slot 0 reserved 2 blocks (16 rows), slot 2 28 rows: overhang gated
    wto = np.array([16, 32, 28, 32])
    active = np.array([True, True, True, False])
    first = r.integers(0, V, (S, K))
    verify = T.make_paged_verify_fn(NH, K, BS)
    toks = _crafted_toks(lambda t: verify(
        *_params(lm), _port_cache(arena), _i64(btabs), _i64(pos), _i64(t),
        _b(active), _i64(wto))[0].numpy(), first)
    jc = [{"k": jnp.asarray(k), "v": jnp.asarray(v)} for k, v in arena]
    want = J.make_paged_verify_fn(NH, K, BS)(
        ref["target"].aux, ref["target"].blocks, jc,
        jnp.asarray(btabs, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(toks, jnp.int32), jnp.asarray(active),
        jnp.asarray(wto, jnp.int32))
    port = _port_cache(arena)
    got = verify(*_params(lm), port, _i64(btabs), _i64(pos), _i64(toks),
                 _b(active), _i64(wto))
    written = [(int(btabs[s, p // BS]) * BS + p % BS,)
               for s in range(3) for p in range(pos[s], pos[s] + K)
               if p < wto[s]]
    _check_verify(got, want, NBLK * BS, port, arena, written)


def _jax_draft(ref, kind):
    from deeplearning4j_tpu.serving import ModelDraft as JMD
    from deeplearning4j_tpu.serving import NGramDraft as JND
    return JND(n=3) if kind == "ngram" else JMD(ref["small"])


def _port_draft(ref, kind):
    return (NGramDraft(n=3) if kind == "ngram"
            else ModelDraft(ref["port"]["small"]))


_PROMPT = [5, 17, 3, 5, 17, 3, 5, 40]
_BATCH = np.array([[5, 17, 3, 5, 17, 3], [9, 9, 2, 71, 9, 9],
                   [60, 1, 60, 1, 60, 1]])


@pytest.fixture(scope="module")
def jax_spec_streams(ref):
    """The reference's speculative streams: generate and generate_batch
    for both draft sources and K in {1, 2, 4, 8}."""
    out = {}
    for kind in ("ngram", "model"):
        for k in (1, 2, 4, 8):
            out["gen", kind, k] = ref["target"].generate(
                _PROMPT, 24, draft=_jax_draft(ref, kind), speculate_k=k)
            out["batch", kind, k] = np.asarray(ref["target"].generate_batch(
                _BATCH, 14, draft=_jax_draft(ref, kind), speculate_k=k))
    return out


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_generate_draft_streams_equal_jax(ref, jax_spec_streams, kind, k):
    lm = ref["port"]["target"]
    got = lm.generate(_PROMPT, 24, draft=_port_draft(ref, kind),
                      speculate_k=k)
    assert got == [int(t) for t in jax_spec_streams["gen", kind, k]]
    assert got == lm.generate(_PROMPT, 24, use_cache=True)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_generate_batch_draft_streams_equal_jax(ref, jax_spec_streams,
                                                kind, k):
    lm = ref["port"]["target"]
    got = lm.generate_batch(_BATCH, 14, draft=_port_draft(ref, kind),
                            speculate_k=k)
    np.testing.assert_array_equal(got, jax_spec_streams["batch", kind, k])


_SERVER_MODES = {
    "fixed": dict(slots=3, prompt_buckets=(8, 16)),
    "paged": dict(slots=3, prompt_buckets=(8, 16), paged=True,
                  block_size=BS, n_blocks=30),
}


def _spec_workload():
    rng = np.random.default_rng(8)
    work = []
    for i in range(5):
        pat = rng.integers(1, V, 3).tolist()
        work.append(((pat * 4)[:int(rng.integers(4, 12))],
                     int(rng.integers(4, 14))))
    return work


def _serve_spec(server_cls, lm, mode, speculator):
    with server_cls(lm, speculate=speculator, **_SERVER_MODES[mode]) as srv:
        work = _spec_workload()
        out = [srv.generate(*work[0], timeout=120)]
        futs = [srv.submit(p, n) for p, n in work[1:]]
        out += [f.result(120) for f in futs]
        snap = srv.metrics.snapshot()
    return [list(map(int, s)) for s in out], snap


@pytest.mark.parametrize("mode", sorted(_SERVER_MODES))
@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_server_streams_equal_jax_server(ref, mode, kind):
    from deeplearning4j_tpu.serving import ContinuousDecodeServer as JS
    from deeplearning4j_tpu.serving import Speculator as JSpec
    want, _ = _serve_spec(JS, ref["target"], mode,
                          JSpec(_jax_draft(ref, kind), k=K))
    got, snap = _serve_spec(ContinuousDecodeServer, ref["port"]["target"],
                            mode, Speculator(_port_draft(ref, kind), k=K))
    assert got == want
    assert snap.get("failed", 0) == 0
    assert snap["spec_tokens"] == snap["tokens_out"]


# ---------------------------------------------------------------------------
# the reference's pins (tests/test_speculative.py), on the port
# ---------------------------------------------------------------------------
def _lm(seed=3, max_len=64):
    return TransformerLM(64, d_model=32, n_heads=2, n_layers=2,
                         max_len=max_len, seed=seed, device="cpu")


def _draft_lm(seed=21):
    """A genuinely SMALLER draft model (the Leviathan setting); max_len
    covers the target's plus the speculative overhang."""
    return TransformerLM(64, d_model=16, n_heads=2, n_layers=1,
                         max_len=80, seed=seed, device="cpu")


def _prompt(seed=4, n=5):
    return np.random.default_rng(seed).integers(1, 64, n).tolist()


class TestNGramDraft:
    def test_prompt_lookup_proposes_continuation(self):
        d = NGramDraft(n=3)
        d.start("r", [1, 2, 3, 4, 5, 1, 2, 3])
        # suffix [1,2,3] occurred at the start; continuation is [4,5,...]
        assert d.propose("r", 3) == [4, 5, 1]
        d.stop("r")

    def test_most_recent_match_wins(self):
        d = NGramDraft(n=2)
        d.start("r", [7, 8, 1, 7, 8, 2, 7, 8])
        assert d.propose("r", 1) == [2]     # recency, not first occurrence

    def test_no_match_returns_empty(self):
        d = NGramDraft(n=3, min_match=2)
        d.start("r", [1, 2, 3, 4])
        assert d.propose("r", 4) == []

    def test_observe_extends_history(self):
        d = NGramDraft(n=2)
        d.start("r", [5, 6])
        d.observe("r", [9, 5, 6])
        assert d.propose("r", 1) == [9]

    def test_stop_is_idempotent(self):
        d = NGramDraft()
        d.start("r", [1])
        d.stop("r")
        d.stop("r")                          # no KeyError


class TestGenerateSpeculative:
    def test_ngram_bit_identical_across_k(self):
        lm = _lm()
        p = _prompt()
        plain = lm.generate(p, 20, use_cache=True)
        for k in (2, 4, 8):
            assert lm.generate(p, 20, draft=NGramDraft(),
                               speculate_k=k) == plain

    def test_k1_degenerates_to_plain_decode(self):
        lm = _lm()
        p = _prompt()
        assert lm.generate(p, 12, draft=NGramDraft(),
                           speculate_k=1) == lm.generate(p, 12,
                                                         use_cache=True)

    def test_model_draft_bit_identical(self):
        lm = _lm()
        p = _prompt()
        plain = lm.generate(p, 16, use_cache=True)
        assert lm.generate(p, 16, draft=ModelDraft(_draft_lm()),
                           speculate_k=4) == plain

    def test_speculator_bundle_accepted(self):
        lm = _lm()
        p = _prompt()
        spec = Speculator(NGramDraft(), k=4)
        assert lm.generate(p, 10, draft=spec) == lm.generate(
            p, 10, use_cache=True)

    def test_generate_batch_both_sources(self):
        lm = _lm()
        prompts = np.random.default_rng(5).integers(
            1, 64, (3, 4)).astype(np.int32)
        plain = lm.generate_batch(prompts, max_new_tokens=12)
        for draft in (NGramDraft(), ModelDraft(_draft_lm())):
            got = lm.generate_batch(prompts, max_new_tokens=12,
                                    draft=draft, speculate_k=4)
            assert np.array_equal(got, plain)

    def test_greedy_only(self):
        lm = _lm()
        with pytest.raises(ValueError, match="greedy-only"):
            lm.generate(_prompt(), 8, temperature=0.7, draft=NGramDraft())
        with pytest.raises(ValueError, match="greedy-only"):
            lm.generate_batch(np.asarray([[1, 2]], np.int32), 8,
                              temperature=0.7, draft=NGramDraft())

    def test_max_len_guard(self):
        lm = _lm()
        with pytest.raises(ValueError, match="max_len"):
            lm.generate([1] * 10, 60, draft=NGramDraft())


class TestServerSpeculative:
    def test_solo_and_join_bit_identical_across_k(self):
        """For K in {2,4,8}: a speculative solo stream matches plain
        decode, and a request JOINING a running speculative batch matches
        its own solo stream."""
        lm = _lm()
        rng = np.random.default_rng(4)
        pa = rng.integers(1, 64, 5).tolist()
        pb = rng.integers(1, 64, 8).tolist()
        plain = lm.generate(pa, 10, use_cache=True)
        for k in (2, 4, 8):
            with ContinuousDecodeServer(
                    lm, slots=4, prompt_buckets=(4, 8),
                    speculate=Speculator(NGramDraft(), k=k)) as srv:
                solo = srv.generate(pa, 10, timeout=60)
                flong = srv.submit(pb, 24)      # running batch
                time.sleep(0.05)
                fa = srv.submit(pa, 10)         # joins mid-flight
                joined = fa.result(60)
                flong.result(60)
            assert solo == plain
            assert joined == solo

    def test_model_draft_server_bit_identical(self):
        lm = _lm()
        p = _prompt()
        with ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(8,),
                speculate=Speculator(ModelDraft(_draft_lm()), k=4)) as srv:
            got = srv.generate(p, 14, timeout=60)
        assert got == lm.generate(p, 14, use_cache=True)

    def test_paged_server_bit_identical_both_sources(self):
        lm = _lm()
        p = _prompt()
        plain = lm.generate(p, 14, use_cache=True)
        for draft in (NGramDraft(), ModelDraft(_draft_lm())):
            with ContinuousDecodeServer(
                    lm, slots=2, prompt_buckets=(8,), paged=True,
                    block_size=4, n_blocks=40,
                    speculate=Speculator(draft, k=4)) as srv:
                got = srv.generate(p, 14, timeout=60)
                assert srv._pool.blocks_in_use == 0
            assert got == plain

    def test_equal_arrival_matches_generate_batch(self):
        lm = _lm()
        prompts = np.random.default_rng(5).integers(
            1, 64, (4, 4)).astype(np.int32)
        expect = lm.generate_batch(prompts, max_new_tokens=8)
        with ContinuousDecodeServer(
                lm, slots=4, prompt_buckets=(4,),
                speculate=Speculator(NGramDraft(), k=4)) as srv:
            futs = [srv.submit(prompts[i], 8) for i in range(4)]
            rows = [f.result(60) for f in futs]
        for i in range(4):
            assert rows[i] == expect[i].tolist()

    def test_self_draft_accepts_k_per_dispatch(self):
        """The target drafting for itself: exactly K accepted tokens per
        dispatch, dispatches/token == 1/K."""
        lm = _lm()
        k = 4
        with ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(8,),
                speculate=Speculator(ModelDraft(lm), k=k)) as srv:
            got = srv.generate(_prompt(), 21, timeout=60)
        assert got == lm.generate(_prompt(), 21, use_cache=True)
        snap = srv.metrics.snapshot()
        # 21 tokens: 1 at prefill, then 20 = 5 full-acceptance dispatches
        assert snap["spec_accepted_per_dispatch_mean"] == pytest.approx(k)
        assert snap["dispatches_per_token"] == pytest.approx(1.0 / k)
        assert snap["spec_acceptance_rate_mean"] == pytest.approx(1.0)
        assert snap["draft_dispatches"] > 0
        assert snap["device_dispatches_per_token"] > \
            3 * snap["dispatches_per_token"]

    def test_garbage_draft_still_advances(self):
        class WorstDraft(NGramDraft):
            def propose(self, key, k):
                hist = self._hist[key]
                return [(hist[-1] + 1) % 3 for _ in range(k)]

        lm = _lm()
        p = _prompt()
        with ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(8,),
                speculate=Speculator(WorstDraft(), k=4)) as srv:
            got = srv.generate(p, 10, timeout=60)
        assert got == lm.generate(p, 10, use_cache=True)
        snap = srv.metrics.snapshot()
        assert snap["spec_accepted_per_dispatch_mean"] < 2.0
        assert snap["dispatches_per_token"] <= 1.0

    def test_swap_drain_speculative(self):
        lm1, lm2 = _lm(3), _lm(11)
        rng = np.random.default_rng(10)
        pa = rng.integers(1, 64, 4).tolist()
        pb = rng.integers(1, 64, 4).tolist()
        with ContinuousDecodeServer(
                lm1, slots=2, prompt_buckets=(4,),
                speculate=Speculator(NGramDraft(), k=4)) as srv:
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


class TestSpeculationFaults:
    def test_retry_keeps_stream_bit_identical(self):
        lm = _lm()
        p = _prompt()
        inj = FaultInjector(seed=1).plan("serve.batch", on_call=1,
                                         exc=FaultInjected)
        rp = RetryPolicy(max_retries=3, base_delay=0.001,
                         retryable=(ConnectionError,))
        with ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(8,), fault_injector=inj,
                retry_policy=rp,
                speculate=Speculator(NGramDraft(), k=4)) as srv:
            got = srv.generate(p, 10, timeout=60)
        snap = srv.metrics.snapshot()
        assert got == lm.generate(p, 10, use_cache=True)
        assert snap.get("retries") == 1 and snap.get("failed", 0) == 0

    def test_terminal_fault_fails_loudly_and_recovers(self):
        lm = _lm()
        p = _prompt()
        inj = FaultInjector(seed=2).plan("serve.batch", on_call=1,
                                         exc=FaultInjected)
        with ContinuousDecodeServer(
                lm, slots=2, prompt_buckets=(8,), fault_injector=inj,
                speculate=Speculator(NGramDraft(), k=4)) as srv:
            f = srv.submit(p, 6)
            with pytest.raises(FaultInjected):
                f.result(60)
            # slot state reset (incl. the draft stream): serves again
            got = srv.generate(p, 6, timeout=60)
        assert got == lm.generate(p, 6, use_cache=True)
        assert srv.metrics.snapshot().get("failed") == 1


def test_metrics_record_speculation_shape():
    m = ServingMetrics(window=8)
    m.count("dispatches", 2)
    m.count("tokens_out", 6)
    m.record_speculation(4, 3, 3)
    m.record_speculation(2, 3, 1)
    snap = m.snapshot()
    assert snap["spec_accepted_per_dispatch_mean"] == 3.0
    assert snap["spec_acceptance_rate_mean"] == pytest.approx(2 / 3)
    assert snap["dispatches_per_token"] == pytest.approx(1 / 3)
    assert snap["spec_tokens"] == 6 and snap["spec_matched"] == 4


# ---------------------------------------------------------------------------
# the reference's paged speculation pins (tests/test_paged.py), on the port
# ---------------------------------------------------------------------------
def _paged(lm, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("prompt_buckets", (8, 16))
    kw.setdefault("block_size", 4)
    kw.setdefault("n_blocks", 40)
    return ContinuousDecodeServer(lm, paged=True, **kw)


def _spec(k=4, draft=None):
    return Speculator(draft if draft is not None else NGramDraft(n=3),
                      k=k)


class TestPagedSpeculative:
    def test_constructs_and_serves(self):
        lm = _lm()
        p = [5, 9, 2, 7]
        with _paged(lm, speculate=_spec()) as srv:
            got = srv.generate(p, 6, timeout=60)
            assert srv._pool.blocks_in_use == 0
        assert got == lm.generate(p, max_new_tokens=6)

    def test_solo_join_fixed_bit_identical_across_k(self):
        lm = _lm()
        rng = np.random.default_rng(21)
        pa = rng.integers(1, 64, 5).tolist()
        pb = rng.integers(1, 64, 8).tolist()
        plain = lm.generate(pa, 10, use_cache=True)
        for k in (2, 4, 8):
            with ContinuousDecodeServer(
                    lm, slots=4, prompt_buckets=(8, 16),
                    speculate=_spec(k)) as srv:
                fixed = srv.generate(pa, 10, timeout=60)
            with _paged(lm, speculate=_spec(k)) as srv:
                solo = srv.generate(pa, 10, timeout=60)
                flong = srv.submit(pb, 24)      # running batch
                time.sleep(0.05)
                joined = srv.submit(pa, 10).result(60)
                flong.result(60)
                assert srv._pool.blocks_in_use == 0
            assert fixed == plain
            assert solo == plain
            assert joined == plain

    def test_model_draft_bit_identical(self):
        lm = _lm()
        draft_lm = TransformerLM(64, d_model=16, n_heads=2, n_layers=1,
                                 max_len=80, seed=21, device="cpu")
        rng = np.random.default_rng(22)
        p = rng.integers(1, 64, 5).tolist()
        plain = lm.generate(p, 16, use_cache=True)
        with _paged(lm, slots=2, speculate=_spec(4, ModelDraft(
                draft_lm))) as srv:
            assert srv.generate(p, 16, timeout=60) == plain
        k = 4
        with _paged(lm, slots=2, speculate=_spec(k, ModelDraft(
                lm))) as srv:
            got = srv.generate(p, 21, timeout=60)
            snap = srv.metrics.snapshot()
        assert got == lm.generate(p, 21, use_cache=True)
        assert snap["spec_accepted_per_dispatch_mean"] == pytest.approx(k)
        assert snap["dispatches_per_token"] == pytest.approx(1.0 / k)

    def test_cow_divergent_verify_write(self):
        lm = _lm()
        rng = np.random.default_rng(23)
        p8 = rng.integers(1, 64, 8).tolist()
        p6 = p8[:6]
        with _paged(lm, prefix_cache=False, speculate=_spec()) as srv:
            a0 = srv.generate(p8, 10, timeout=60)
            b0 = srv.generate(p6, 10, timeout=60)
        with _paged(lm, speculate=_spec()) as srv:
            fa = srv.submit(p8, 10)
            time.sleep(0.05)
            fb = srv.submit(p6, 10)
            a1, b1 = fa.result(60), fb.result(60)
            snap = srv.metrics.snapshot()
            assert srv._pool.blocks_in_use == 0
        assert a1 == a0          # owner's rows never clobbered
        assert b1 == b0          # sharer diverges onto its private copy
        assert snap["cow_copies"] == 1
        assert snap["prefix_rows_hit"] >= 6

    def test_no_leak_after_spec_request_churn(self):
        lm = _lm()
        rng = np.random.default_rng(24)
        sysp = rng.integers(1, 64, 4).tolist()
        with _paged(lm, slots=3, n_blocks=16, speculate=_spec(8)) as srv:
            futs = []
            for i in range(12):
                own = rng.integers(1, 64, int(rng.integers(1, 5))).tolist()
                p = (sysp + own) if i % 2 else own
                futs.append(srv.submit(p, int(rng.integers(2, 10))))
            for f in futs:
                assert f.result(120)
            assert srv._pool.blocks_in_use == 0
            assert srv._pool.check()
            assert srv.metrics.snapshot().get("failed", 0) == 0

    def test_mid_round_deadline_eviction_releases_blocks(self):
        lm = _lm()
        rng = np.random.default_rng(25)
        p = rng.integers(1, 64, 4).tolist()
        inj = FaultInjector(seed=7).plan(
            "serve.batch", on_calls=range(0, 200), times=200,
            delay=0.03, exc=None)
        with _paged(lm, slots=2, fault_injector=inj,
                    speculate=_spec()) as srv:
            srv.generate([1, 2], 2, deadline_ms=600_000, timeout=120)
            doomed = srv.submit(p, 40, deadline_ms=120)
            with pytest.raises(DeadlineExceededError):
                doomed.result(120)
            deadline = time.monotonic() + 10
            while srv._pool.blocks_in_use and time.monotonic() < deadline:
                time.sleep(0.01)
            assert srv._pool.blocks_in_use == 0
            snap = srv.metrics.snapshot()
        assert snap["shed_deadline"] == 1
        assert snap["evicted_mid_decode"] == 1

    def test_dispatch_counter_ab_paged_spec_equals_fixed_spec(self):
        lm = _lm()
        rng = np.random.default_rng(26)
        work = []
        for _ in range(6):
            pat = rng.integers(1, 64, 3).tolist()
            work.append(((pat * 3)[:int(rng.integers(4, 8))],
                         int(rng.integers(6, 12))))
        counts = {}
        for name, srv in (
                ("fixed", ContinuousDecodeServer(
                    lm, slots=2, prompt_buckets=(8,),
                    speculate=_spec())),
                ("paged", _paged(lm, slots=2, speculate=_spec()))):
            with srv:
                for p, n in work:       # sequential: same round count
                    srv.generate(p, n, timeout=60)
                snap = srv.metrics.snapshot()
            counts[name] = (snap["dispatches"], snap["tokens_out"],
                            snap.get("cow_copies", 0))
        assert counts["fixed"][:2] == counts["paged"][:2]
        assert counts["paged"][2] == 0

    def test_hot_swap_drain_paged_speculative(self):
        lm1, lm2 = _lm(3), _lm(11)
        rng = np.random.default_rng(27)
        pa = rng.integers(1, 64, 4).tolist()
        pb = rng.integers(1, 64, 4).tolist()
        with _paged(lm1, slots=2, speculate=_spec()) as srv:
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
