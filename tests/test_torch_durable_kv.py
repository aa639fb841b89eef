"""Durable KV state on the port (serving/kvstate.py, the decode server's
preemption, migration, prefix cache on disk and prefix export/adopt,
`make_block_extract_fn`, `_param_fingerprint`).

Three parts:
  * Against the JAX package: the extract program on the same arena, the
    parameter fingerprint for the same weights in f32 and bf16, and
    artifacts crossing between the two packages' servers both ways
    (`migrate_out` on one, `migrate_in` on the other, f32: the stream
    goes on to the other package's solo stream; a prefix chain exported
    by one is adopted by the other).
  * bf16 artifacts without `ml_dtypes`: a fresh process in which
    `import ml_dtypes` fails writes and reads a bf16 RequestArtifact and
    PrefixCacheArtifact through disk and bytes, and those bytes equal
    the reference's for the same panels.
  * The reference's server pins, their bodies copied from
    tests/test_kvstate.py (pool adoption, preemption, migration, the
    persistent prefix cache, the metric keys) and run on the port's
    classes (torch's CPU, f32).
"""
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.zoo import transformer as T
from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
from deeplearning4j_tpu_torch.serving import (BlockPool, BrownoutPolicy,
                                              ContinuousDecodeServer,
                                              KVStateError,
                                              KVStateVersionError,
                                              NGramDraft,
                                              PrefixCacheArtifact,
                                              RequestArtifact,
                                              RequestMigratedError,
                                              Speculator)
from deeplearning4j_tpu_torch.serving import decode as PD
from deeplearning4j_tpu_torch.serving.kvstate import artifact_kind

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, DM, NH, NL, MAXLEN = 96, 32, 2, 2, 64


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeplearning4j_tpu.models.zoo import transformer as JT
    from deeplearning4j_tpu.serving import decode as JD
    from deeplearning4j_tpu.serving import kvstate as JK
    return {"jax": jax, "jnp": jnp, "T": JT, "D": JD, "K": JK}


def _jax_lm(J, seed=0, dtype=None):
    return J["T"].TransformerLM(V, d_model=DM, n_heads=NH, n_layers=NL,
                                max_len=MAXLEN, seed=seed,
                                dtype=dtype or J["jnp"].float32)


def _port_of(J, jlm):
    aux, blocks = J["jax"].tree.map(np.asarray, (jlm.aux, jlm.blocks))
    return TransformerLM.from_jax_params(aux, blocks, NH, device="cpu")


def test_block_extract_matches_jax(J):
    jnp = J["jnp"]
    bs, nblk = 4, 12
    r = np.random.default_rng(0)
    arena = [(r.standard_normal((nblk * bs, NH, DM // NH)).astype(np.float32),
              r.standard_normal((nblk * bs, NH, DM // NH)).astype(np.float32))
             for _ in range(NL)]
    tab = np.array([5, 2, 11, 0, 0, 0])
    want = J["T"].make_block_extract_fn(bs)(
        [{"k": jnp.asarray(k), "v": jnp.asarray(v)} for k, v in arena],
        jnp.asarray(tab, jnp.int32))
    spare = np.full((1, NH, DM // NH), np.nan, np.float32)
    port = [{"k": torch.from_numpy(np.concatenate([k, spare])),
             "v": torch.from_numpy(np.concatenate([v, spare]))}
            for k, v in arena]
    got = T.make_block_extract_fn(bs)(port, torch.from_numpy(tab))
    for (gk, gv), (wk, wv) in zip(got, want):
        assert gk.shape == (len(tab) * bs, NH, DM // NH)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        assert not torch.isnan(gk).any()        # the spare row is never read


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_fingerprint_equals_jax(J, dtype):
    jlm = _jax_lm(J, seed=4, dtype=getattr(J["jnp"], dtype))
    lm = _port_of(J, jlm)
    assert lm.aux.tok.dtype == getattr(torch, dtype)
    want = J["D"]._param_fingerprint(jlm.aux, jlm.blocks)
    assert PD._param_fingerprint(lm.aux, list(lm.blocks)) == want
    other = _port_of(J, _jax_lm(J, seed=5, dtype=getattr(J["jnp"], dtype)))
    assert PD._param_fingerprint(other.aux, list(other.blocks)) != want


_MIG = dict(slots=2, prompt_buckets=(8, 16), paged=True, block_size=4,
            n_blocks=40)
_MIG_PROMPT = [5, 9, 2, 7, 1, 3, 8, 8, 4]


def _solo(server_cls, lm, prompt, n):
    with server_cls(lm, **_MIG) as srv:
        return [int(t) for t in srv.generate(prompt, n, timeout=120)]


def _export_mid_stream(srv, prompt, n, after):
    """Submit, wait until the request has decoded `after` tokens in its
    slot, migrate it out; returns the artifact."""
    fut = srv.submit(prompt, n)
    t0 = time.monotonic()
    while not any(r is not None and r.future is fut and r.pf_next is None
                  and len(r.generated) >= after for r in srv._slot_req):
        assert time.monotonic() - t0 < 60, "never reached decode"
        time.sleep(0.001)
    art = srv.migrate_out(fut)
    with pytest.raises(Exception) as exc:     # either package's class
        fut.result(10)
    assert type(exc.value).__name__ == "RequestMigratedError"
    return art


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_migration_crosses_packages(J, direction):
    """An artifact exported by one package's server is taken in by the
    other's, and the stream goes on to the other package's own solo
    stream (f32, tokens equal)."""
    from deeplearning4j_tpu.serving import ContinuousDecodeServer as JS
    jlm = _jax_lm(J)
    lm = _port_of(J, jlm)
    src, dst = ((JS, jlm), (ContinuousDecodeServer, lm))
    if direction == "port_to_jax":
        src, dst = dst, src
    want = _solo(*dst, _MIG_PROMPT, 24)
    assert want == _solo(*src, _MIG_PROMPT, 24)
    with src[0](src[1], **_MIG) as a:
        art = _export_mid_stream(a, _MIG_PROMPT, 24, after=3)
    mod = J["K"] if direction == "port_to_jax" else None
    wire = art.to_bytes()
    art = (mod.RequestArtifact.from_bytes(wire) if mod is not None
           else RequestArtifact.from_bytes(wire))
    with dst[0](dst[1], **_MIG) as b:
        out = b.migrate_in(art).result(120)
        assert b.metrics.snapshot()["migrated"] == 1
    assert [int(t) for t in out] == want


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_prefix_chain_crosses_packages(J, direction):
    """prefix_export on one package's running server, prefix_adopt on the
    other's: the adopted rows are hit and the stream equals a cold run."""
    from deeplearning4j_tpu.serving import ContinuousDecodeServer as JS
    jlm = _jax_lm(J)
    lm = _port_of(J, jlm)
    src, dst = ((JS, jlm), (ContinuousDecodeServer, lm))
    if direction == "port_to_jax":
        src, dst = dst, src
    sysp = list(range(1, 13))
    prompt = sysp + [20, 21]
    cold = _solo(*dst, prompt, 8)
    with src[0](src[1], **_MIG) as a:
        a.generate(prompt, 8, timeout=120)
        art = a.prefix_export(sysp)
    assert art is not None and len(art.entries) == 3
    mod = J["K"] if direction == "port_to_jax" else None
    wire = art.to_bytes()
    art = (mod.PrefixCacheArtifact.from_bytes(wire) if mod is not None
           else PrefixCacheArtifact.from_bytes(wire))
    with dst[0](dst[1], **_MIG) as b:
        assert b.prefix_adopt(art) == 3
        warm = [int(t) for t in b.generate(prompt, 8, timeout=120)]
        snap = b.metrics.snapshot()
    assert warm == cold
    assert snap["prefix_pull_hits"] == 3
    assert snap["prefix_rows_hit"] >= 12


def test_prefix_export_truncates_and_adopt_refuses_other_weights():
    lm = TransformerLM(64, d_model=32, n_heads=2, n_layers=2, max_len=64,
                       seed=3, device="cpu")
    sysp = list(range(1, 13))
    with _paged(lm) as a:
        a.generate(sysp + [20], 4, timeout=120)
        full = a.prefix_export(sysp)
        one = a.prefix_export(sysp, max_bytes=full.nbytes // 3)
        assert a.prefix_export([60, 61, 62, 63]) is None
    assert len(full.entries) == 3 and len(one.entries) == 1
    with _paged(_lm(seed=9)) as b:
        with pytest.raises(KVStateVersionError):
            b.prefix_adopt(full)
        snap = b.metrics.snapshot()
        assert b._pool.blocks_in_use == 0 and not b._pool.restored
    assert snap["prefix_pull_refused"] == 1


# ---------------------------------------------------------------------------
# bf16 artifacts without ml_dtypes
# ---------------------------------------------------------------------------
_BF16_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["ml_dtypes"] = None        # `import ml_dtypes` now fails
    import hashlib, json, os
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.serving import kvstate as K
    out = sys.argv[1]
    r = np.random.default_rng(0)
    bf = lambda rows: torch.from_numpy(
        r.standard_normal((rows, 2, 16)).astype(np.float32)).to(
        torch.bfloat16)
    req = K.RequestArtifact([5, 9, 2, 7], [11, 3, 8], 9, "abc123", 4,
                            [(bf(6), bf(6)) for _ in range(2)],
                            klass="batch")
    pre = K.PrefixCacheArtifact("abc123", 4, [
        ((1, 2, 3, 4), [(bf(4), bf(4)) for _ in range(2)]),
        ((1, 2, 3, 4, 5, 6, 7, 8), [(bf(4), bf(4)) for _ in range(2)])])
    res = {}
    for name, art, cls in (("req", req, K.RequestArtifact),
                           ("pre", pre, K.PrefixCacheArtifact)):
        wire = art.to_bytes()
        disk = cls.load(art.save(os.path.join(out, name)))
        back = cls.from_bytes(wire)
        assert back.to_bytes() == wire and disk.to_bytes() == wire
        flat = lambda a: [t for kv in (a.panels if name == "req" else
                                       [kv for _, p in a.entries
                                        for kv in p]) for t in kv]
        for x, y in zip(flat(art), flat(disk)):
            assert y.dtype == torch.bfloat16 and torch.equal(x, y)
        with open(os.path.join(out, name + ".bin"), "wb") as fh:
            fh.write(wire)
        res[name] = hashlib.sha256(wire).hexdigest()
    assert "ml_dtypes" not in [m for m in sys.modules
                               if sys.modules[m] is not None]
    print(json.dumps(res))
""")


def test_bf16_artifacts_without_ml_dtypes_byte_equal_to_jax(J, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BF16_SCRIPT,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    # the reference's artifacts over the same panels (ml_dtypes bf16)
    K = J["K"]
    r = np.random.default_rng(0)
    bf = lambda rows: r.standard_normal((rows, 2, 16)).astype(
        np.float32).astype(J["jnp"].bfloat16)
    req = K.RequestArtifact([5, 9, 2, 7], [11, 3, 8], 9, "abc123", 4,
                            [(bf(6), bf(6)) for _ in range(2)],
                            klass="batch")
    pre = K.PrefixCacheArtifact("abc123", 4, [
        ((1, 2, 3, 4), [(bf(4), bf(4)) for _ in range(2)]),
        ((1, 2, 3, 4, 5, 6, 7, 8), [(bf(4), bf(4)) for _ in range(2)])])
    for name, art in (("req", req), ("pre", pre)):
        wire = art.to_bytes()
        assert hashlib.sha256(wire).hexdigest() == got[name]
        with open(tmp_path / (name + ".bin"), "rb") as fh:
            assert fh.read() == wire
    # and the reference reads the port's files
    back = K.RequestArtifact.load(str(tmp_path / "req"))
    assert back.to_bytes() == req.to_bytes()


# ---------------------------------------------------------------------------
# the reference's server pins (tests/test_kvstate.py), on the port
# ---------------------------------------------------------------------------
def _lm(seed=3):
    return TransformerLM(64, d_model=32, n_heads=2, n_layers=2,
                         max_len=64, seed=seed, device="cpu")


def _paged(lm, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("prompt_buckets", (8, 16))
    kw.setdefault("block_size", 4)
    kw.setdefault("n_blocks", 40)
    return ContinuousDecodeServer(lm, paged=True, **kw)


def _wait_preemptible(srv, fut, timeout=30.0):
    """Block until `fut`'s request decodes in a slot and may be preempted
    (`_PREEMPT_MIN_PROGRESS` tokens since its start)."""
    t0 = time.monotonic()
    while not any(r is not None and r.future is fut and r.pf_next is None
                  and len(r.generated) >= srv._PREEMPT_MIN_PROGRESS
                  for r in srv._slot_req):
        if time.monotonic() - t0 > timeout or fut.done():
            raise TimeoutError("the request never became preemptible")
        time.sleep(0.0005)


def _wait_tokens(srv, n, timeout=30.0):
    """Block until the server has emitted >= n tokens total."""
    t0 = time.monotonic()
    while srv.metrics.snapshot().get("tokens_out", 0) < n:
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {n} tokens after {timeout}s")
        time.sleep(0.003)


class TestPoolAdopt:
    def test_adopt_indexes_and_lru_evicts(self):
        pool = BlockPool(4, 4)
        b0 = pool.adopt((0, tuple(range(4))))
        b1 = pool.adopt((0, tuple(range(8))))
        assert b0 is not None and b1 is not None
        assert pool.restored == {b0, b1}
        pool.check()
        assert pool.match_prefix(list(range(8)), tag=0)[1] == 8
        assert pool.adopt((0, tuple(range(4)))) is None   # already there
        # a full pool evicts adopted blocks LRU like any cached block
        a = pool.admit(list(range(20, 36)), 16)
        assert a is not None
        pool.check()
        assert pool.restored == set()     # both evicted and unmarked
        pool.release(a)
        pool.check()

    def test_adopted_block_shared_by_admission(self):
        pool = BlockPool(8, 4)
        b0 = pool.adopt((0, tuple(range(1, 5))))
        a = pool.admit(list(range(1, 9)), 10, tag=0)
        assert a.shared_rows == 4 and a.ids[0] == b0
        pool.check()
        pool.release(a)
        pool.check()


# ---------------------------------------------------------------------------
# (c) preemption
# ---------------------------------------------------------------------------
class TestPreemption:
    def _brownout(self):
        return BrownoutPolicy(classes={"batch": (0.9, 1.01)})

    def test_preempt_verb_ranking(self):
        pol = self._brownout()
        assert pol.may_preempt("batch", "interactive")
        assert pol.may_preempt("batch", "default")
        assert not pol.may_preempt("interactive", "batch")
        assert not pol.may_preempt("batch", "batch")
        assert not pol.may_preempt("default", "default")

    def test_preempt_requires_paged_and_brownout(self):
        lm = _lm()
        with pytest.raises(ValueError, match="paged"):
            ContinuousDecodeServer(lm, preempt=True,
                                   brownout=self._brownout())
        with pytest.raises(ValueError, match="brownout"):
            _paged(lm, preempt=True)

    def test_preempted_stream_bit_identical_and_pool_clean(self):
        lm = _lm()
        srv = _paged(lm, slots=2, prompt_buckets=(8,), n_blocks=10,
                     brownout=self._brownout(), preempt=True).start()
        try:
            # batch reserves 8 of 10 blocks; after the second
            # interactive (3 blocks) only preemption can admit it
            bfut = srv.submit([1, 2, 3, 4, 5, 6], 26, klass="batch")
            _wait_tokens(srv, 2)
            i1 = srv.submit([7, 8, 9], 6, klass="interactive")
            i2 = srv.submit([9, 8, 7, 6], 8, klass="interactive")
            r2, r1, rb = i2.result(120), i1.result(120), bfut.result(240)
            snap = srv.metrics.snapshot()
            assert snap["preempted"] >= 1
            assert snap["resumed"] >= 1
            assert snap["spill_bytes"] > 0
        finally:
            srv.stop(timeout=120)
        srv._pool.check()
        assert srv._pool.blocks_in_use == 0
        with _paged(lm, slots=2, prompt_buckets=(8,)) as solo:
            assert rb == solo.generate([1, 2, 3, 4, 5, 6], 26,
                                       timeout=120)
            assert r1 == solo.generate([7, 8, 9], 6, timeout=120)
            assert r2 == solo.generate([9, 8, 7, 6], 8, timeout=120)

    def test_claimant_behind_blocked_batch_still_preempts(self):
        """Head-of-line inversion regression: a second BATCH request
        parks blocked on the memory gate; an interactive request
        arriving behind it must still reach its preemption chance (the
        preempting gate scans past blocked requests instead of walling
        the line)."""
        lm = _lm()
        srv = _paged(lm, slots=3, prompt_buckets=(8,), n_blocks=8,
                     brownout=self._brownout(), preempt=True).start()
        try:
            b1 = srv.submit([1, 2, 3, 4], 28, klass="batch")  # 8 blocks
            _wait_tokens(srv, 2)
            b2 = srv.submit([4, 3, 2, 1], 28, klass="batch")  # blocked
            time.sleep(0.02)
            i1 = srv.submit([5, 6, 7], 5, klass="interactive")
            r1 = i1.result(60)      # would hang without the gate scan
            snap = srv.metrics.snapshot()
            assert snap["preempted"] >= 1
            rb1, rb2 = b1.result(240), b2.result(240)
        finally:
            srv.stop(timeout=120)
        srv._pool.check()
        assert srv._pool.blocks_in_use == 0
        with _paged(lm, slots=2, prompt_buckets=(8,)) as solo:
            assert rb1 == solo.generate([1, 2, 3, 4], 28, timeout=120)
            assert rb2 == solo.generate([4, 3, 2, 1], 28, timeout=120)
            assert r1 == solo.generate([5, 6, 7], 5, timeout=120)

    def test_composes_with_chunked_prefill_and_speculation(self):
        lm = _lm()
        spec = Speculator(NGramDraft(n=3), k=4)
        srv = _paged(lm, slots=2, prompt_buckets=(16,), n_blocks=12,
                     chunked_prefill=4, speculate=spec,
                     brownout=self._brownout(), preempt=True).start()
        try:
            bfut = srv.submit([1, 2, 3, 1, 2, 3, 1, 2], 32,
                              klass="batch")   # 39 rows -> 10 blocks
            _wait_tokens(srv, 2)
            ifut = srv.submit([5, 6, 5, 6, 5], 8, klass="interactive")
            ri, rb = ifut.result(120), bfut.result(240)
            snap = srv.metrics.snapshot()
            assert snap["preempted"] >= 1 and snap["resumed"] >= 1
        finally:
            srv.stop(timeout=120)
        srv._pool.check()
        assert srv._pool.blocks_in_use == 0
        # spec + chunked preempted streams == plain greedy solo
        with _paged(lm, slots=2, prompt_buckets=(16,)) as solo:
            assert rb == solo.generate([1, 2, 3, 1, 2, 3, 1, 2], 32,
                                       timeout=120)
            assert ri == solo.generate([5, 6, 5, 6, 5], 8, timeout=120)

    def test_property_churn_admit_preempt_resume_release(self):
        """Satellite pin: random interleaving of admissions (both
        classes), preemptions (forced by interactive pressure),
        resumes, and releases — the pool's invariants hold at drain
        with ZERO leaked blocks and an empty pool."""
        lm = _lm()
        rng = np.random.default_rng(7)
        srv = _paged(lm, slots=3, prompt_buckets=(8,), n_blocks=14,
                     brownout=self._brownout(), preempt=True).start()
        futs = []
        try:
            for i in range(40):
                if rng.random() < 0.35:
                    p = rng.integers(1, 60, 4).tolist()
                    futs.append(srv.submit(p, int(rng.integers(16, 30)),
                                           klass="batch"))
                else:
                    p = rng.integers(1, 60, int(rng.integers(2, 6)))
                    futs.append(srv.submit(p.tolist(),
                                           int(rng.integers(2, 9)),
                                           klass="interactive"))
                if rng.random() < 0.3:
                    time.sleep(0.004)
            for f in futs:
                f.result(300)
            snap = srv.metrics.snapshot()
        finally:
            srv.stop(timeout=180)
        srv._pool.check()
        assert srv._pool.blocks_in_use == 0
        assert srv._pool.blocks_free == srv._pool.capacity
        assert snap["completed"] == len(futs)

    def test_preempted_request_survives_hot_swap(self):
        """A request preempted BEFORE a hot swap resumes under the
        params it started with (its version is pinned while parked —
        the artifact's rows are only valid there), bit-identical to a
        solo run on the OLD params, while post-swap requests get the
        new params."""
        lm, lm2 = _lm(seed=3), _lm(seed=11)
        srv = _paged(lm, slots=2, prompt_buckets=(8,), n_blocks=10,
                     brownout=self._brownout(), preempt=True).start()
        try:
            b = srv.submit([1, 2, 3, 4, 5, 6], 26, klass="batch")
            _wait_tokens(srv, 2)
            i = srv.submit([9, 8, 7, 6], 8, klass="interactive")
            i.result(120)
            assert srv.metrics.snapshot()["preempted"] >= 1
            srv.swap(lm2)
            post = srv.submit([7, 7, 7], 5)
            rb, rp = b.result(240), post.result(120)
        finally:
            srv.stop(timeout=120)
        srv._pool.check()
        with _paged(lm, slots=2, prompt_buckets=(8,)) as solo_old:
            assert rb == solo_old.generate([1, 2, 3, 4, 5, 6], 26,
                                           timeout=120)
        with _paged(lm2, slots=2, prompt_buckets=(8,)) as solo_new:
            assert rp == solo_new.generate([7, 7, 7], 5, timeout=120)

    def test_non_preempting_path_zero_added_dispatches(self):
        """Dispatch-counter A/B (acceptance pin): with preemption
        ENABLED but never triggered (ample blocks), the dispatch count
        for an identical workload equals the preempt=False server's —
        durable KV state costs zero device dispatches per token until
        a spill actually happens."""
        lm = _lm()
        work = [([1, 2, 3, 4], 6), ([5, 6, 7], 9), ([8, 9], 5)]
        counts = {}
        for name, kw in (("preempt_on",
                          dict(brownout=self._brownout(), preempt=True)),
                         ("preempt_off", {})):
            srv = _paged(lm, slots=4, n_blocks=40, **kw).start()
            try:
                srv.generate([1, 2], 2, timeout=120)    # warm compile
                base = srv.metrics.snapshot()["dispatches"]
                futs = [srv.submit(p, n, klass="interactive")
                        for p, n in work]
                for f in futs:
                    f.result(120)
                snap = srv.metrics.snapshot()
                counts[name] = snap["dispatches"] - base
                assert snap["preempted"] == 0
            finally:
                srv.stop(timeout=120)
            srv._pool.check()
        assert counts["preempt_on"] == counts["preempt_off"]

    def test_preempted_request_deadline_enforced(self):
        """A preempted request's deadline stays enforced: whether it
        expires while PARKED on the resume line (the resume-line sweep)
        or right after resuming (mid-decode eviction), the future fails
        loudly with DeadlineExceededError and every block is back in
        the pool. The interactive claimant reserves the WHOLE pool, so
        the batch request is guaranteed parked for the interactive's
        full runtime.

        The reference gives the batch request 60 ms and relies on its
        compiled steps being fast; the port's eager CPU steps under a
        loaded test run can take longer than that to reach the
        preemptible progress. So the budget here is 3 s, and once the
        batch request is preemptible every dispatch is paced by 0.1 s
        (delay-only faults), which keeps the 49-token claimant running
        ~5 s: far past the budget on any machine."""
        from deeplearning4j_tpu_torch.common.resilience import FaultInjector
        from deeplearning4j_tpu_torch.serving import DeadlineExceededError
        lm = _lm()
        inj = FaultInjector(seed=8)
        srv = _paged(lm, slots=2, prompt_buckets=(8,), n_blocks=13,
                     brownout=self._brownout(), preempt=True,
                     fault_injector=inj).start()
        try:
            srv.generate([9, 9], 2, timeout=120)    # warm-up off clock
            b = srv.submit([1, 2, 3, 4, 5, 6], 26, klass="batch",
                           deadline_ms=3000.0)
            _wait_preemptible(srv, b)
            inj.plan("serve.batch", times=10_000, delay=0.1, exc=None)
            # whole-pool interactive: 4 + 49 - 1 = 52 rows = 13 blocks
            i = srv.submit([7, 8, 9, 1], 49, klass="interactive")
            i.result(120)
            with pytest.raises(DeadlineExceededError):
                b.result(120)
            snap = srv.metrics.snapshot()
            assert snap["preempted"] >= 1
        finally:
            srv.stop(timeout=120)
        srv._pool.check()
        assert srv._pool.blocks_in_use == 0


# ---------------------------------------------------------------------------
# (d) migration
# ---------------------------------------------------------------------------
class TestMigration:
    def test_migrated_stream_bit_identical_to_solo(self):
        lm = _lm()
        a = _paged(lm).start()
        b = _paged(lm).start()
        try:
            with _paged(lm) as solo:
                ref = solo.generate([5, 9, 2, 7, 1, 3], 20, timeout=120)
            fut = a.submit([5, 9, 2, 7, 1, 3], 20)
            _wait_tokens(a, 4)
            art = a.migrate_out(fut)
            assert len(art.generated) >= 1
            with pytest.raises(RequestMigratedError):
                fut.result(10)
            out = b.migrate_in(art).result(120)
            assert out == ref
            assert b.metrics.snapshot()["migrated"] == 1
            assert a.metrics.snapshot()["spill_bytes"] > 0
        finally:
            a.stop(timeout=120)
            b.stop(timeout=120)
        a._pool.check()
        b._pool.check()
        assert a._pool.blocks_in_use == 0
        assert b._pool.blocks_in_use == 0

    def test_migration_composes_with_speculation_and_chunking(self):
        lm = _lm()
        kw = dict(slots=2, prompt_buckets=(16,), chunked_prefill=4,
                  speculate=Speculator(NGramDraft(n=3), k=4))
        a = _paged(lm, **kw).start()
        b = _paged(lm, **kw).start()
        try:
            prompt = [1, 2, 3, 1, 2, 3, 1, 2, 3]
            with _paged(lm, slots=2, prompt_buckets=(16,)) as solo:
                ref = solo.generate(prompt, 24, timeout=120)
            fut = a.submit(prompt, 24)
            _wait_tokens(a, 4)
            art = a.migrate_out(fut)
            out = b.migrate_in(art).result(120)
            assert out == ref
        finally:
            a.stop(timeout=120)
            b.stop(timeout=120)
        a._pool.check()
        b._pool.check()

    def test_cross_params_migration_refused_loudly(self):
        a = _paged(_lm(seed=3)).start()
        b = _paged(_lm(seed=9)).start()
        try:
            fut = a.submit([5, 9, 2, 7], 12)
            _wait_tokens(a, 2)
            art = a.migrate_out(fut)
            with pytest.raises(KVStateVersionError):
                b.migrate_in(art)
            assert b.metrics.snapshot()["migrated"] == 0
        finally:
            a.stop(timeout=120)
            b.stop(timeout=120)
        b._pool.check()
        assert b._pool.blocks_in_use == 0

    def test_unknown_request_export_fails_loudly(self):
        import concurrent.futures as cf
        srv = _paged(_lm()).start()
        try:
            with pytest.raises(KVStateError, match="not found"):
                srv.migrate_out(cf.Future())
        finally:
            srv.stop(timeout=120)

    def test_restore_onto_partial_block_ride_never_corrupts_owner(self):
        """Regression: a restored request whose prefix match rides the
        FIRST PART of a shared partial block must not install its rows
        into that block — rows [shared, pos) would overwrite the cached
        owner's tail (E,F,G,H of a block another prompt still matches).
        The restore materializes the reserved CoW spare FIRST and
        installs the whole block from the artifact. Detector: a later
        full-prefix hit on the owner's prompt must still be
        bit-identical to a cold run."""
        lm = _lm()
        P8 = [1, 2, 3, 4, 5, 6, 7, 8]       # 2 full blocks at bs=4
        P6 = P8[:6]                         # full block + 2-row partial
        with _paged(lm, slots=2, prompt_buckets=(8,)) as solo:
            ref8 = solo.generate(P8, 6, timeout=120)
            ref6 = solo.generate(P6, 24, timeout=120)
        srv = _paged(lm, slots=2, prompt_buckets=(8,)).start()
        try:
            assert srv.generate(P8, 6, timeout=120) == ref8   # indexed
            f2 = srv.submit(P6, 24)         # partial ride + CoW
            # wait on the SLOT STATE, not the shared token counter: a
            # counter threshold can be crossed arbitrarily close to
            # the request's own completion on a slow box, and a
            # completed request is (correctly) no longer exportable —
            # observed as a rare machine-weather flake. Decode-phase
            # occupancy plus a 24-token budget leaves ~20 tokens of
            # runway for the export command to land.
            t0 = time.monotonic()
            while not any(r is not None and r.future is f2
                          and r.pf_next is None
                          for r in srv._slot_req):
                assert time.monotonic() - t0 < 60, "never reached decode"
                time.sleep(0.002)
            art = srv.migrate_out(f2)
            out2 = srv.migrate_in(art).result(120)
            assert out2 == ref6
            # the owner's blocks must be intact: full-prefix re-hit
            assert srv.generate(P8, 6, timeout=120) == ref8
        finally:
            srv.stop(timeout=120)
        srv._pool.check()
        assert srv._pool.blocks_in_use == 0

    def test_artifact_survives_disk_round_trip(self, tmp_path):
        """The migration seam IS the serialization seam: an artifact
        saved to disk and re-loaded imports identically (the
        prefill/decode-disaggregation wire path)."""
        lm = _lm()
        a = _paged(lm).start()
        b = _paged(lm).start()
        try:
            with _paged(lm) as solo:
                ref = solo.generate([3, 1, 4, 1, 5], 16, timeout=120)
            fut = a.submit([3, 1, 4, 1, 5], 16)
            _wait_tokens(a, 3)
            art = a.migrate_out(fut)
            p = art.save(str(tmp_path / "wire"))
            out = b.migrate_in(RequestArtifact.load(p)).result(120)
            assert out == ref
        finally:
            a.stop(timeout=120)
            b.stop(timeout=120)
        a._pool.check()
        b._pool.check()


# ---------------------------------------------------------------------------
# (e) persistent prefix cache
# ---------------------------------------------------------------------------
class TestPersistentPrefixCache:
    SYS = list(range(1, 13))    # 3 full blocks at block_size 4

    def test_restart_warm_start_bit_identical(self, tmp_path):
        lm = _lm()
        pdir = str(tmp_path / "prefix")
        s1 = _paged(lm, slots=2, prompt_buckets=(16,),
                    prefix_cache_dir=pdir).start()
        cold = s1.generate(self.SYS + [20, 21], 8, timeout=120)
        s1.stop(timeout=120)
        assert artifact_kind(pdir) == "prefix_cache"
        s2 = _paged(lm, slots=2, prompt_buckets=(16,),
                    prefix_cache_dir=pdir).start()
        try:
            s2._pool.check()
            warm = s2.generate(self.SYS + [20, 21], 8, timeout=120)
            snap = s2.metrics.snapshot()
        finally:
            s2.stop(timeout=120)
        assert warm == cold
        assert snap["prefix_restore_hits"] > 0
        s2._pool.check()
        assert s2._pool.blocks_in_use == 0

    def test_version_mismatch_refused_loudly_zero_reuse(self, tmp_path):
        """Satellite pin: a snapshot saved under params v1 restored
        into a server running v2 refuses the blocks loudly — the
        constructor raises, and a direct restore attempt adopts ZERO
        blocks (the in-process hot-swap invalidation rule, across
        restarts)."""
        pdir = str(tmp_path / "prefix")
        s1 = _paged(_lm(seed=3), slots=2, prompt_buckets=(16,),
                    prefix_cache_dir=pdir).start()
        s1.generate(self.SYS + [20, 21], 8, timeout=120)
        s1.stop(timeout=120)
        with pytest.raises(KVStateVersionError):
            _paged(_lm(seed=9), slots=2, prompt_buckets=(16,),
                   prefix_cache_dir=pdir)
        # direct restore into a v2 server without the dir wiring: same
        # loud refusal, zero adopted blocks
        s2 = _paged(_lm(seed=9), slots=2, prompt_buckets=(16,))
        with pytest.raises(KVStateVersionError):
            s2.restore_prefix_cache(pdir)
        assert s2._pool.restored == set()
        assert s2._pool.blocks_free == s2._pool.capacity
        s2._pool.check()

    def test_small_pool_restores_prefix_of_snapshot(self, tmp_path):
        """A pool smaller than the snapshot adopts what fits (parent-
        first, so what it adopts is matchable) and never fails the
        server."""
        lm = _lm()
        pdir = str(tmp_path / "prefix")
        s1 = _paged(lm, slots=2, prompt_buckets=(16,), n_blocks=40,
                    prefix_cache_dir=pdir).start()
        s1.generate(self.SYS + [20, 21], 8, timeout=120)
        s1.generate(list(range(30, 42)) + [1], 8, timeout=120)
        s1.stop(timeout=120)
        art = PrefixCacheArtifact.load(pdir)
        assert len(art.entries) >= 4
        s2 = _paged(lm, slots=1, prompt_buckets=(16,), n_blocks=3,
                    max_blocks_per_slot=16)
        n = s2.restore_prefix_cache(pdir)
        assert 0 < n <= 3
        s2._pool.check()

    def test_stale_snapshot_removed_when_nothing_saveable(self, tmp_path):
        """Regression: a server that hot-swaps and then stops with no
        prefix entries under the NEWEST version must not leave the
        previous version's snapshot behind — a stale artifact would
        strand the next constructor on a version refusal the server's
        own lifecycle caused. The save removes it; the next start is a
        clean cold start."""
        lm, lm2 = _lm(seed=3), _lm(seed=11)
        pdir = str(tmp_path / "prefix")
        s1 = _paged(lm, slots=2, prompt_buckets=(16,),
                    prefix_cache_dir=pdir).start()
        s1.generate(self.SYS + [20, 21], 8, timeout=120)
        s1.stop(timeout=120)
        assert artifact_kind(pdir) == "prefix_cache"
        s2 = _paged(lm, slots=2, prompt_buckets=(16,),
                    prefix_cache_dir=pdir).start()     # warm restore OK
        s2.swap(lm2)            # newest version now has no entries
        s2.stop(timeout=120)    # save finds nothing: stale dir removed
        assert artifact_kind(pdir) is None
        # the new-params server boots cold instead of raising
        s3 = _paged(lm2, slots=2, prompt_buckets=(16,),
                    prefix_cache_dir=pdir).start()
        try:
            s3.generate(self.SYS + [20, 21], 8, timeout=120)
        finally:
            s3.stop(timeout=120)
        assert artifact_kind(pdir) == "prefix_cache"

    def test_explicit_foreign_path_never_deleted(self, tmp_path):
        """save_prefix_cache with nothing saveable removes only the
        server's OWN stale prefix_cache_dir; an explicitly passed path
        may be another server's valid snapshot and must survive."""
        lm = _lm()
        pdir = str(tmp_path / "prefix")
        s1 = _paged(lm, slots=2, prompt_buckets=(16,),
                    prefix_cache_dir=pdir).start()
        s1.generate(self.SYS + [20, 21], 8, timeout=120)
        s1.stop(timeout=120)
        assert artifact_kind(pdir) == "prefix_cache"
        s2 = _paged(lm)             # never started: nothing saveable
        assert s2.save_prefix_cache(pdir) is None
        assert artifact_kind(pdir) == "prefix_cache"    # intact

    def test_save_without_dir_and_on_running_server_refused(self):
        srv = _paged(_lm()).start()
        try:
            with pytest.raises(KVStateError, match="stopped"):
                srv.save_prefix_cache("/tmp/nope")
        finally:
            srv.stop(timeout=120)
        with pytest.raises(ValueError, match="path"):
            srv.save_prefix_cache()

    def test_prefix_dir_requires_paged_prefix_cache(self, tmp_path):
        with pytest.raises(ValueError, match="prefix_cache_dir"):
            ContinuousDecodeServer(_lm(),
                                   prefix_cache_dir=str(tmp_path / "x"))


# ---------------------------------------------------------------------------
# snapshot keys
# ---------------------------------------------------------------------------
class TestDurableMetricsKeys:
    def test_keys_always_present_and_zero_when_idle(self):
        from deeplearning4j_tpu_torch.serving import ServingMetrics
        snap = ServingMetrics().snapshot()
        for key in ("preempted", "resumed", "migrated", "migrated_out",
                    "spill_bytes", "prefix_restore_hits"):
            assert snap[key] == 0
