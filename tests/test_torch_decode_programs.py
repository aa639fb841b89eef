"""The port's serving programs (models/zoo/transformer.py: fixed-slot and
paged decode, prefill and install, chunked prefill, block copy, fused
windows) against the JAX package's, on the same numpy weights and inputs.

The JAX package draws the weights (`init_lm`, V=96, d=32, H=2, L=2,
max_len=64, f32) and `TransformerLM.from_jax_params` carries them over.
Outputs agree to 1e-5 and next tokens are equal. A port serving cache has
one spare row past its end (a spare slot for the fixed layout), where the
writes the reference drops land; the rows both packages hold are compared,
and the rows a program must not write are held bit-unchanged. Inside the
port, a fused window equals K sequential steps bit for bit.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.zoo import transformer as T

V, DM, NH, NL, MAXLEN, BS = 96, 32, 2, 2, 64, 8
HD = DM // NH
S = 4
ATOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The JAX transformer module, its weights as jnp and numpy, and the
    port model holding the same weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeplearning4j_tpu.models.zoo import transformer as J
    aux, blocks = J.init_lm(V, d_model=DM, n_heads=NH, n_layers=NL,
                            max_len=MAXLEN, seed=0, dtype=jnp.float32)
    np_aux, np_blocks = jax.tree.map(np.asarray, (aux, blocks))
    lm = T.TransformerLM.from_jax_params(np_aux, np_blocks, NH,
                                         device="cpu")
    return {"J": J, "jnp": jnp, "aux": aux, "blocks": blocks, "lm": lm}


def _port_params(ref):
    return ref["lm"].aux, list(ref["lm"].blocks)


def _rng(seed):
    return np.random.default_rng(seed)


def _fixed_cache(seed, slots=S):
    """A random fixed-layout cache as numpy [(k, v)] per layer."""
    r = _rng(seed)
    return [(r.standard_normal((slots, MAXLEN, NH, HD)).astype(np.float32),
             r.standard_normal((slots, MAXLEN, NH, HD)).astype(np.float32))
            for _ in range(NL)]


def _to_jax_cache(ref, cache):
    jnp = ref["jnp"]
    return [{"k": jnp.asarray(k), "v": jnp.asarray(v)} for k, v in cache]


def _with_spare(cache):
    """numpy cache -> port cache: each tensor with its spare slot or row
    (zeros) appended."""
    out = []
    for k, v in cache:
        spare = np.zeros((1,) + k.shape[1:], np.float32)
        out.append({"k": torch.from_numpy(np.concatenate([k, spare])),
                    "v": torch.from_numpy(np.concatenate([v, spare]))})
    return out


def _arena(seed, n_blocks):
    r = _rng(seed)
    rows = n_blocks * BS
    return [(r.standard_normal((rows, NH, HD)).astype(np.float32),
             r.standard_normal((rows, NH, HD)).astype(np.float32))
            for _ in range(NL)]


def _i64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def _b(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.bool)


def _compare_cache(port, jax_cache, n, what):
    for c, j in zip(port, jax_cache):
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name][:n].numpy(),
                                       np.asarray(j[name]), rtol=0,
                                       atol=ATOL, err_msg=f"{what} {name}")


def test_slot_decode_matches_jax_and_gates_inactive_slots(ref):
    J, jnp = ref["J"], ref["jnp"]
    cache = _fixed_cache(1)
    pos = np.array([5, 0, 63, 17])
    tok = np.array([3, 95, 40, 7])
    active = np.array([True, False, True, True])
    want = J.make_slot_decode_fn(NH)(
        ref["aux"], ref["blocks"], _to_jax_cache(ref, cache),
        jnp.asarray(pos, jnp.int32), jnp.asarray(tok, jnp.int32),
        jnp.asarray(active))
    port = _with_spare(cache)
    got = T.make_slot_decode_fn(NH)(*_port_params(ref), port, _i64(pos),
                                    _i64(tok), _b(active))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    _compare_cache(port, want[2], S, "slot decode")
    for c, (k, _) in zip(port, cache):   # inactive slot 1: bit-unchanged
        assert torch.equal(c["k"][1], torch.from_numpy(k[1]))
    for c, (k, _) in zip(port, cache):   # live rows: only at pos
        changed = (c["k"][:S] != torch.from_numpy(k)).any(-1).any(-1)
        assert changed.nonzero().tolist() == [[0, 5], [2, 63], [3, 17]]


def test_slot_decode_k_wide_block_drops_rows_past_the_cache(ref):
    """The fixed K-wide block through the chunked program: a chunk that
    runs past the cache's end writes only the rows that exist."""
    J, jnp = ref["J"], ref["jnp"]
    C = 8
    cache = _fixed_cache(2)
    pos = np.array([60, 3, 0, 20])
    toks = _rng(3).integers(0, V, (S, C))
    nrows = np.array([8, 8, 5, 8])
    active = np.array([True, True, True, False])
    want = J.make_chunked_prefill_fn(NH, C)(
        ref["aux"], ref["blocks"], _to_jax_cache(ref, cache),
        jnp.asarray(pos, jnp.int32), jnp.asarray(toks, jnp.int32),
        jnp.asarray(nrows, jnp.int32), jnp.asarray(active))
    port = _with_spare(cache)
    got = T.make_chunked_prefill_fn(NH, C)(
        *_port_params(ref), port, _i64(pos), _i64(toks), _i64(nrows),
        _b(active))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _compare_cache(port, want[1], S, "fixed chunk")
    for c, (k, _) in zip(port, cache):
        assert torch.equal(c["k"][3], torch.from_numpy(k[3]))   # inactive


def test_fixed_prefill_matches_jax(ref):
    J, jnp = ref["J"], ref["jnp"]
    prompt = _rng(4).integers(0, V, (1, 16))
    want = J.make_prefill_fn(NH, MAXLEN)(ref["aux"], ref["blocks"],
                                         jnp.asarray(prompt, jnp.int32),
                                         jnp.asarray(11, jnp.int32))
    got = T.make_prefill_fn(NH, MAXLEN)(*_port_params(ref), _i64(prompt), 11)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=ATOL)
    assert int(got[0].argmax()) == int(np.argmax(np.asarray(want[0])))
    _compare_cache(got[1], want[1], 1, "prefill rows")


def _tables():
    """Block tables of 4 slots over a 16-block arena (NB=4): slot 2 is
    free and its stale table aliases slot 0's blocks."""
    return np.array([[3, 7, 9, 0], [1, 2, 0, 0], [3, 7, 9, 0],
                     [12, 13, 14, 15]])


def test_paged_decode_matches_jax_and_stale_tables_write_nothing(ref):
    J, jnp = ref["J"], ref["jnp"]
    arena = _arena(5, 16)
    btabs = _tables()
    pos = np.array([19, 9, 19, 31])
    tok = np.array([1, 2, 3, 4])
    active = np.array([True, True, False, True])
    want = J.make_paged_decode_fn(NH, BS)(
        ref["aux"], ref["blocks"], _to_jax_cache(ref, arena),
        jnp.asarray(btabs, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(tok, jnp.int32), jnp.asarray(active))
    port = _with_spare(arena)
    got = T.make_paged_decode_fn(NH, BS)(*_port_params(ref), port,
                                         _i64(btabs), _i64(pos), _i64(tok),
                                         _b(active))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ATOL)
    n = 16 * BS
    _compare_cache(port, want[2], n, "paged decode")
    # exactly the three live frontier rows changed: the free slot's stale
    # table (aliasing slot 0's row 9*8+3) wrote nothing
    live = sorted([9 * BS + 3, 2 * BS + 1, 15 * BS + 7])
    for c, (k, _) in zip(port, arena):
        changed = (c["k"][:n] != torch.from_numpy(k)).any(-1).any(-1)
        assert changed.nonzero()[:, 0].tolist() == live


def test_paged_chunk_matches_jax_within_its_write_window(ref):
    J, jnp = ref["J"], ref["jnp"]
    C = 8
    arena = _arena(6, 16)
    btabs = _tables()
    pos = np.array([8, 0, 0, 28])
    toks = _rng(7).integers(0, V, (S, C))
    nrows = np.array([8, 8, 8, 4])
    active = np.array([True, True, False, True])
    wfrom = np.array([12, 0, 0, 0])     # slot 0: rows < 12 are resident
    wto = np.array([21, 14, 0, 32])
    want = J.make_chunked_prefill_fn(NH, C, BS)(
        ref["aux"], ref["blocks"], _to_jax_cache(ref, arena),
        *[jnp.asarray(a, jnp.int32) for a in (btabs, pos, toks, nrows)],
        jnp.asarray(active), jnp.asarray(wfrom, jnp.int32),
        jnp.asarray(wto, jnp.int32))
    port = _with_spare(arena)
    got = T.make_chunked_prefill_fn(NH, C, BS)(
        *_port_params(ref), port, _i64(btabs), _i64(pos), _i64(toks),
        _i64(nrows), _b(active), _i64(wfrom), _i64(wto))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    n = 16 * BS
    _compare_cache(port, want[1], n, "paged chunk")
    # written rows: slot 0 logical 12..15 (block 7), slot 1 0..7 (block
    # 1), slot 3 28..31 (block 15); nothing else
    live = sorted([7 * BS + i for i in range(4, 8)]
                  + [1 * BS + i for i in range(8)]
                  + [15 * BS + i for i in range(4, 8)])
    for c, (k, _) in zip(port, arena):
        changed = (c["k"][:n] != torch.from_numpy(k)).any(-1).any(-1)
        assert changed.nonzero()[:, 0].tolist() == live


def test_paged_prefill_and_install_match_jax(ref):
    J, jnp = ref["J"], ref["jnp"]
    prompt = _rng(8).integers(0, V, (1, 16))
    length, shared = 13, 8
    btab = np.array([5, 2, 11, 0])
    wl, wp = J.make_paged_prefill_fn(NH)(ref["aux"], ref["blocks"],
                                         jnp.asarray(prompt, jnp.int32),
                                         jnp.asarray(length, jnp.int32))
    gl, gp = T.make_paged_prefill_fn(NH)(*_port_params(ref), _i64(prompt),
                                         length)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=ATOL)
    for (gk, gv), (wk, wv) in zip(gp, wp):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0,
                                   atol=ATOL)
    arena = _arena(9, 16)
    want = J.make_paged_install_fn(BS)(
        _to_jax_cache(ref, arena), wp, jnp.asarray(btab, jnp.int32),
        jnp.asarray(length, jnp.int32), jnp.asarray(shared, jnp.int32))
    port = _with_spare(arena)
    T.make_paged_install_fn(BS)(port, gp, _i64(btab), length, shared)
    n = 16 * BS
    _compare_cache(port, want, n, "install")
    live = [2 * BS + i for i in range(5)]      # rows 8..12 only
    for c, (k, _) in zip(port, arena):
        changed = (c["k"][:n] != torch.from_numpy(k)).any(-1).any(-1)
        assert changed.nonzero()[:, 0].tolist() == live


def test_block_copy_matches_jax(ref):
    J, jnp = ref["J"], ref["jnp"]
    arena = _arena(10, 16)
    want = J.make_block_copy_fn(BS)(_to_jax_cache(ref, arena),
                                    jnp.asarray(3, jnp.int32),
                                    jnp.asarray(12, jnp.int32))
    port = _with_spare(arena)
    T.make_block_copy_fn(BS)(port, 3, 12)
    _compare_cache(port, want, 16 * BS, "block copy")


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_fused_window_matches_jax_and_equals_k_steps(ref, paged):
    """The window against JAX's scan; inside the port, against K plain
    steps under the same gates: tokens and cache bit-equal."""
    J, jnp = ref["J"], ref["jnp"]
    K = 4
    tok = np.array([5, 6, 7, 8])
    active = np.array([True, True, False, True])
    steps = np.array([4, 2, 4, 3])
    if paged:
        cache = _arena(11, 16)
        btabs = _tables()
        pos = np.array([16, 8, 5, 26])
        wto = np.array([24, 16, 0, 28])       # slot 3: 2 rows reserved
        want = J.make_paged_fused_decode_fn(NH, BS, K)(
            ref["aux"], ref["blocks"], _to_jax_cache(ref, cache),
            *[jnp.asarray(a, jnp.int32) for a in (btabs, pos, tok)],
            jnp.asarray(active), jnp.asarray(steps, jnp.int32),
            jnp.asarray(wto, jnp.int32))
        extra = (_i64(btabs),)
        n = 16 * BS
        fresh = lambda: _with_spare(cache)
        fn = T.make_paged_fused_decode_fn(NH, BS, K)
        step = T.make_paged_decode_fn(NH, BS)
        gates = lambda i, p: (_b(active) & (_i64(steps) > i)
                              & (p < _i64(wto)))
        args = lambda: (_i64(pos), _i64(tok), _b(active), _i64(steps),
                        _i64(wto))
    else:
        cache = _fixed_cache(12)
        pos = np.array([10, 0, 20, 60])
        want = J.make_fused_decode_fn(NH, K)(
            ref["aux"], ref["blocks"], _to_jax_cache(ref, cache),
            *[jnp.asarray(a, jnp.int32) for a in (pos, tok)],
            jnp.asarray(active), jnp.asarray(steps, jnp.int32))
        extra = ()
        n = S
        fresh = lambda: _with_spare(cache)
        fn = T.make_fused_decode_fn(NH, K)
        step = T.make_slot_decode_fn(NH)
        gates = lambda i, p: _b(active) & (_i64(steps) > i)
        args = lambda: (_i64(pos), _i64(tok), _b(active), _i64(steps))
    port = fresh()
    toks, _, new_pos = fn(*_port_params(ref), port, *extra, *args())
    np.testing.assert_array_equal(new_pos.numpy(), np.asarray(want[2]))
    live = np.asarray(want[0])
    for s in range(S):
        if active[s]:
            n_ok = int(new_pos[s] - pos[s])
            np.testing.assert_array_equal(toks[:n_ok, s].numpy(),
                                          live[:n_ok, s])
    _compare_cache(port, want[1], n, "window")
    # K sequential plain steps under the window's gates
    seq = fresh()
    p, t = _i64(pos), _i64(tok)
    outs = []
    for i in range(K):
        act = gates(i, p)
        nxt, _, _, p2 = step(*_port_params(ref), seq, *extra, p, t, act)
        outs.append(nxt)
        t = torch.where(act, nxt, t)
        p = p2
    assert torch.equal(toks, torch.stack(outs))
    assert torch.equal(new_pos, p)
    for a, b in zip(port, seq):
        assert torch.equal(a["k"][:n], b["k"][:n])
        assert torch.equal(a["v"][:n], b["v"][:n])


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_chunked_last_row_argmax_equals_one_shot(ref, paged):
    """A 21-token prompt in chunks of 8 (the last padded) gives the
    first token the one-shot prefill gives."""
    C, P = 8, 21
    prompt = _rng(13).integers(0, V, P)
    d = DM
    lm = ref["lm"]
    if paged:
        logits, _ = T.make_paged_prefill_fn(NH)(*_port_params(ref),
                                                _i64(prompt[None]), P)
        cache = T.init_paged_kv_cache(NL, 8, BS, d, NH, device="cpu")
        btabs = torch.zeros(1, 8, dtype=torch.int64)
        btabs[0, :3] = torch.tensor([4, 1, 6])
        step = T.make_chunked_prefill_fn(NH, C, BS)
    else:
        logits, _ = T.make_prefill_fn(NH, MAXLEN)(*_port_params(ref),
                                                  _i64(prompt[None]), P)
        cache = T.init_slot_kv_cache(NL, 1, MAXLEN, d, NH, device="cpu")
        step = T.make_chunked_prefill_fn(NH, C)
    pos = torch.zeros(1, dtype=torch.int64)
    one = torch.ones(1, dtype=torch.bool)
    for start in range(0, P, C):
        n = min(C, P - start)
        toks = torch.zeros(1, C, dtype=torch.int64)
        toks[0, :n] = torch.from_numpy(prompt[start:start + n])
        nrows = torch.tensor([n])
        if paged:
            nxt, _, pos = step(lm.aux, list(lm.blocks), cache, btabs, pos,
                               toks, nrows, one, torch.tensor([0]),
                               torch.tensor([P]))
        else:
            nxt, _, pos = step(lm.aux, list(lm.blocks), cache, pos, toks,
                               nrows, one)
    assert int(pos[0]) == P
    assert int(nxt[0, n - 1]) == int(logits[0].argmax())


def test_window_and_chunk_floors(ref):
    with pytest.raises(ValueError, match="k must be >= 2"):
        T.make_fused_decode_fn(NH, 1)
    with pytest.raises(ValueError, match="k must be >= 2"):
        T.make_paged_fused_decode_fn(NH, BS, 1)
    with pytest.raises(ValueError, match="chunk size must be >= 2"):
        T.make_chunked_prefill_fn(NH, 1)


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_card_captured_window_equals_k_steps(cuda, paged):
    """On the card: a fused window captured as a CUDA graph
    (serving.decode._CapturedWindow) against K eager plain steps on a copy
    of the same cache: tokens, positions and every cache row but the spare
    bit-equal; the step's f32 logits against the CPU's within 1e-4."""
    from deeplearning4j_tpu_torch.serving.decode import _CapturedWindow
    K = 4
    lm = T.TransformerLM(V, d_model=DM, n_heads=NH, n_layers=NL,
                         max_len=MAXLEN, seed=1, device="cuda")
    aux, blocks = lm.aux, list(lm.blocks)
    gen = torch.Generator().manual_seed(2)
    if paged:
        cache = _with_spare(_arena(14, 16))
        extra = {"btabs": _i64(_tables())}
        window = T.make_paged_fused_decode_fn(NH, BS, K)
        step = T.make_paged_decode_fn(NH, BS)
        pos = _i64([16, 8, 5, 24])
        tail = {"wto": pos + K}
    else:
        cache = _with_spare(_fixed_cache(15))
        extra, tail = {}, {}
        window = T.make_fused_decode_fn(NH, K)
        step = T.make_slot_decode_fn(NH)
        pos = _i64([10, 0, 20, 59])
    cpu_cache = [{n: c[n].clone() for n in c} for c in cache]
    cache_g = [{n: c[n].cuda() for n in c} for c in cache]
    cache_e = [{n: c[n].cuda() for n in c} for c in cache]
    values = {n: t.cuda() for n, t in dict(
        extra, pos=pos, tok=torch.randint(0, V, (S,), generator=gen),
        active=_b([True, True, False, True]),
        steps=_i64([4, 2, 4, 3]), **tail).items()}
    names = list(values)

    def run(st):
        toks, _, p = window(aux, blocks, cache_g, *[st[n] for n in names])
        return toks, p

    g = _CapturedWindow(run, {n: t.clone() for n, t in values.items()})
    toks_g, pos_g = g.replay(values)
    ex = (values["btabs"],) if paged else ()
    cpu_lm = T.TransformerLM(V, d_model=DM, n_heads=NH, n_layers=NL,
                             max_len=MAXLEN, seed=1, device="cpu")
    p, t, outs = values["pos"], values["tok"], []
    for i in range(K):
        act = values["active"] & (values["steps"] > i)
        if paged:
            act = act & (p < values["wto"])
        nxt, logits, _, p2 = step(aux, blocks, cache_e, *ex, p, t, act)
        if i == 0:
            _, want, _, _ = step(cpu_lm.aux, list(cpu_lm.blocks), cpu_cache,
                                 *[a.cpu() for a in ex], p.cpu(), t.cpu(),
                                 act.cpu())
            np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(),
                                       rtol=0, atol=1e-4)
        outs.append(nxt)
        t = torch.where(act, nxt, t)
        p = p2
    assert torch.equal(toks_g, torch.stack(outs))
    assert torch.equal(pos_g, p)
    for a, b in zip(cache_g, cache_e):
        assert torch.equal(a["k"][:-1], b["k"][:-1])
        assert torch.equal(a["v"][:-1], b["v"][:-1])
