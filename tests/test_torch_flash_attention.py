"""The port's flash attention, forward and backward, against the JAX
package's.

On the CPU the port's `flash_attention` runs its plain PyTorch versions (the
forward, the forward with logsumexp, the dQ pass and the dK/dV pass); the
JAX side runs the Pallas kernels in interpret mode, as its own tests do. The
same inputs, made with numpy from a seed, go to both. Tolerances: 1e-5 abs
in f32 (outputs, lse, gradients, each backward pass; the gradients of
mean(out**2) read within 3e-10); rel 2e-2 (abs floor 1e-2, about one bf16
step near 1) for the bf16 forward; bf16 gradients within 0.03 of the
largest f32 reference gradient, JAX's own bound
(tests/test_flash_attention.py; read: 0.0052).

The ring pieces: the plain K3 (`flash_attention_partial`) against JAX's
`flash_attention_partial` and the offset/f32 backward
(`flash_attention_bwd_partial`) against JAX's, on the hops of a causal ring
(diagonal, visible, wholly masked, part overlap) and non-causal: acc, m, l
and the f32 gradients at 1e-5 abs for f32 inputs; a row that sees no key of
the hop has exactly m = -1e30, l = 0, acc = 0 on both sides.

Tests marked `gpu` hold the CUDA kernels against their plain versions on
the card and skip without one. JAX is imported inside fixtures, so the card-only
tests also run where JAX is not installed:
    python -m pytest --noconftest tests/test_torch_flash_attention.py -m gpu
"""
import itertools

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as fa

B, H, D = 2, 4, 64


def _qkv_np(seed, t):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def jax_flash():
    """(flash_attention, jnp) of the JAX package, run on its CPU backend."""
    jnp = pytest.importorskip("jax.numpy")
    from deeplearning4j_tpu.ops.flash_attention import flash_attention
    return flash_attention, jnp


@pytest.fixture(scope="module")
def jax_flash_vjp():
    """The JAX package's custom-VJP pieces: jax, jnp, the training forward
    `_fwd`, the backward entry `_flash_bwd_bthd` and `flash_attention`."""
    jax = pytest.importorskip("jax")
    import importlib

    import jax.numpy as jnp
    # the module, not the function that deeplearning4j_tpu.ops exports
    jfa = importlib.import_module("deeplearning4j_tpu.ops.flash_attention")
    return jax, jnp, jfa


def _to_bhtd(a):
    """[B, T, H, D] -> JAX's [B*H, T, D]."""
    b, t, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _from_bhtd(a):
    """JAX's [B*H, T, D] -> [B, T, H, D]."""
    a = np.asarray(a)
    return a.reshape(B, H, a.shape[1], D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("t,causal,scale", [
    (256, True, None), (256, False, None), (96, True, None),
    (96, False, None), (256, True, 0.3), (96, False, 0.05)])
def test_matches_jax_f32(jax_flash, t, causal, scale):
    jflash, jnp = jax_flash
    qkv = _qkv_np(t + int(causal), t)
    want = jflash(*(jnp.asarray(a, jnp.float32) for a in qkv), causal, scale)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in qkv), causal,
                             scale)
    assert got.dtype == torch.float32 and got.shape == (B, t, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_matches_jax_bf16(jax_flash):
    jflash, jnp = jax_flash
    qkv = _qkv_np(7, 256)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in qkv), True, None)
    got = fa.flash_attention(*(torch.from_numpy(a).bfloat16() for a in qkv),
                             True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=1e-2)


def test_cpu_runs_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv_np(3, 40))
    before = dict(fa.launches)
    out = fa.flash_attention(q, k, v, False, 0.2)
    assert fa.launches == before
    torch.testing.assert_close(
        out, fa.flash_attention_reference(q, k, v, False, 0.2), rtol=0,
        atol=0)


_T_MASK = [(256, True), (256, False), (96, True), (96, False)]


@pytest.mark.parametrize("t,causal", _T_MASK)
def test_lse_matches_jax_f32(jax_flash_vjp, t, causal):
    """The plain forward-with-lse (K2's plain version) against the residuals
    of JAX's training forward `_fwd`: o, and lse [B*H, T, 1]."""
    _, jnp, jfa = jax_flash_vjp
    qkv = _qkv_np(10 + t + int(causal), t)
    want_o, (*_, want_lse) = jfa._fwd(*(jnp.asarray(a) for a in qkv),
                                      causal, None, 1024, 1024, True)
    o, lse = fa.flash_attention_fwd_lse(*(torch.from_numpy(a) for a in qkv),
                                        causal)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, t)
    np.testing.assert_allclose(lse.reshape(B * H, t, 1).numpy(),
                               np.asarray(want_lse), rtol=0, atol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=0,
                               atol=1e-5)


def _port_grads(qkv, causal, dtype=torch.float32):
    """Gradients of mean(out**2) (out in f32) through the port's
    `flash_attention` (on the CPU: the autograd Function over the plain
    versions)."""
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_()
               for a in qkv)
    out = fa.flash_attention(q, k, v, causal)
    return torch.autograd.grad((out.float() ** 2).mean(), (q, k, v))


def _jax_grads(jax_flash_vjp, qkv, causal):
    jax, jnp, jfa = jax_flash_vjp
    loss = lambda q, k, v: jnp.mean(
        jfa.flash_attention(q, k, v, causal, None, 1024, 1024, True) ** 2)
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in qkv))


@pytest.mark.parametrize("t,causal", _T_MASK)
def test_grads_match_jax_f32(jax_flash_vjp, t, causal):
    """autodiff through the port's flash_attention == jax.grad through the
    JAX custom VJP (fused Pallas backward, interpret mode)."""
    qkv = _qkv_np(20 + t + int(causal), t)
    for got, want in zip(_port_grads(qkv, causal),
                         _jax_grads(jax_flash_vjp, qkv, causal)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_grads_bf16_track_jax_f32(jax_flash_vjp):
    """bf16 inputs: the grads keep bf16 and every entry lies within 0.03 of
    the largest f32 reference gradient (JAX's own bound for its bf16
    backward)."""
    qkv = [a.astype(np.float32) for a in
           (torch.from_numpy(a).bfloat16().float().numpy()
            for a in _qkv_np(30, 256))]
    for got, want in zip(_port_grads(qkv, True, torch.bfloat16),
                         _jax_grads(jax_flash_vjp, qkv, True)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want)
        top = np.abs(want).max()
        assert top > 0
        np.testing.assert_allclose(got.float().numpy() / top, want / top,
                                   rtol=0, atol=0.03)


@pytest.mark.parametrize("t,causal", _T_MASK)
def test_plain_backward_passes_match_jax(jax_flash_vjp, t, causal):
    """The dQ pass (K4's plain version) and the dK/dV pass (K5's) against
    JAX's `_flash_bwd_bthd` on identical (q, k, v, o, lse, do): each pass
    held on its own, not only their sum through autograd."""
    _, jnp, jfa = jax_flash_vjp
    qkv = _qkv_np(40 + t + int(causal), t)
    do = np.random.default_rng(50 + t).standard_normal(
        (B, t, H, D)).astype(np.float32)
    o, (*_, lse) = jfa._fwd(*(jnp.asarray(a) for a in qkv), causal, None,
                            1024, 1024, True)
    o, lse = np.array(o), np.array(lse)
    want = jfa._flash_bwd_bthd(
        *(jnp.asarray(_to_bhtd(a)) for a in (*qkv, o)), jnp.asarray(lse),
        jnp.asarray(_to_bhtd(do)), causal, 1.0 / D ** 0.5, 512, 512, True)
    q, k, v, o_t, do_t = (torch.from_numpy(a) for a in (*qkv, o, do))
    lse_t = torch.from_numpy(lse).reshape(B, H, t)
    delta = fa.attention_delta(o_t, do_t)
    dq = fa.flash_attention_bwd_dq(q, k, v, do_t, lse_t, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do_t, lse_t, delta, causal)
    for name, got, ref in (("dq", dq, want[0]), ("dk", dk, want[1]),
                           ("dv", dv, want[2])):
        np.testing.assert_allclose(got.numpy(), _from_bhtd(ref), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_grad_route_on_cpu_counts_no_launch():
    """With grad: the autograd Function (forward with lse, backward passes);
    without: the single-output forward. Same output both ways, and on the
    CPU no kernel counter moves. An expanded dO (from out.sum()) is taken."""
    qkv = [torch.from_numpy(a) for a in _qkv_np(5, 33)]
    before = dict(fa.launches)
    leaves = [a.clone().requires_grad_() for a in qkv]
    out = fa.flash_attention(*leaves, True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    torch.testing.assert_close(out.detach(),
                               fa.flash_attention(*qkv, True), rtol=0, atol=0)
    out.sum().backward()
    o, lse = fa.flash_attention_fwd_lse(*qkv, True)
    want = fa.flash_attention_bwd_reference(*qkv, o, lse,
                                            torch.ones_like(o), True)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    assert fa.launches == before


# (q_off, k_off, causal) of a hop of T=32 chunks: diagonal, visible, wholly
# masked, the two part overlaps (rows 0-15 see nothing / every key), and
# non-causal
_HOPS = [(32, 32, True), (64, 0, True), (0, 32, True), (0, 16, True),
         (16, 0, True), (0, 32, False)]
_HOP_T = 32


def _hop_inputs(seed, dtype=np.float32):
    """q, k, v, do [B, T, H, D] as numpy f32 holding `dtype` values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, _HOP_T, H, D)).astype(np.float32)
            for _ in range(4)]
    if dtype is not np.float32:
        arrs = [torch.from_numpy(a).to(dtype).float().numpy() for a in arrs]
    return arrs


@pytest.fixture(scope="module")
def jax_hop(jax_flash_vjp):
    """JAX's ring-hop pieces on [B, T, H, D] numpy inputs, jitted once per
    (input dtype, causal) with the offsets traced, as the JAX ring passes
    them: the Pallas `flash_attention_partial` (interpret mode, 16-row
    blocks, so its online softmax folds two kv blocks), then
    `flash_attention_bwd_partial` on lse and delta from that partial (every
    row with a visible key gets its exact softmax). Returns numpy (acc, m,
    l, lse, delta, dq, dk, dv) in the port's layouts."""
    jax, jnp, jfa = jax_flash_vjp

    def hop(q, k, v, do, q_off, k_off, causal):
        acc, m, l = jfa.flash_attention_partial(q, k, v, q_off, k_off, causal,
                                                None, 16, 16, True)
        lc = jnp.maximum(l, 1e-30)
        lse = (m + jnp.log(lc))[..., None]
        o = (acc / lc[..., None]).astype(q.dtype)
        delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), -1,
                        keepdims=True)
        grads = jfa.flash_attention_bwd_partial(
            q, k, v, delta, do, lse, q_off, k_off, causal, None, 16, 16, True)
        return (acc, m, l, lse[..., 0], delta[..., 0], *grads)

    jitted = jax.jit(hop, static_argnames="causal")

    def run(arrays, dtype, q_off, k_off, causal):
        outs = jitted(*(jnp.asarray(_to_bhtd(a), dtype) for a in arrays),
                      q_off, k_off, causal=causal)
        acc, *stats, dq, dk, dv = (np.array(a) for a in outs)
        stats = [a.reshape(B, H, _HOP_T) for a in stats]
        return (_from_bhtd(acc), *stats,
                *(_from_bhtd(g) for g in (dq, dk, dv)))
    return jnp, run


@pytest.mark.parametrize("q_off,k_off,causal", _HOPS)
def test_partial_matches_jax(jax_hop, q_off, k_off, causal):
    """K3's plain version against JAX's Pallas `flash_attention_partial`:
    acc, m, l at 1e-5; masked rows exactly (acc 0, m -1e30, l 0)."""
    jnp, run = jax_hop
    q, k, v, do = _hop_inputs(60 + q_off + k_off)
    w_acc, w_m, w_l = run((q, k, v, do), jnp.float32, q_off, k_off,
                          causal)[:3]
    acc, m, l = fa.flash_attention_partial(
        *(torch.from_numpy(a) for a in (q, k, v)), q_off, k_off, causal)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert acc.shape == (B, _HOP_T, H, D) and m.shape == (B, H, _HOP_T)
    np.testing.assert_allclose(acc.numpy(), w_acc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), w_m, rtol=0, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), w_l, rtol=0, atol=1e-5)
    rows = np.arange(_HOP_T)
    unseen = (q_off + rows < k_off) if causal else np.zeros(_HOP_T, bool)
    for got_m, got_l, got_acc in ((m.numpy(), l.numpy(), acc.numpy()),
                                  (w_m, w_l, w_acc)):
        assert (got_m[..., unseen] == np.float32(fa.FINITE_NEG)).all()
        assert (got_l[..., unseen] == 0).all()
        assert (got_acc[:, unseen] == 0).all()
        assert (got_l[..., ~unseen] > 0).all()


@pytest.mark.parametrize("q_off,k_off,causal", _HOPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_partial_matches_jax(jax_hop, q_off, k_off, causal, dtype):
    """The offset/f32 backward (K4's and K5's plain versions, through
    `flash_attention_bwd_partial`) against JAX's on the same lse and delta:
    f32 gradients; 1e-5 abs for f32 inputs. bf16 inputs: ds and p are
    rounded to bf16 from f32 values that the two sides sum in another
    order, so a rounding may flip; the bound is 1e-2 of the largest
    gradient."""
    jnp, run = jax_hop
    q, k, v, do = _hop_inputs(70 + q_off + k_off, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    *_, lse, delta, dq, dk, dv = run((q, k, v, do), jdt, q_off, k_off, causal)
    before = dict(fa.launches)
    got = fa.flash_attention_bwd_partial(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
        torch.from_numpy(delta), torch.from_numpy(do).to(dtype),
        torch.from_numpy(lse), q_off, k_off, causal)
    assert fa.launches == before
    for name, g, w in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert g.dtype == torch.float32, name
        atol = 1e-5 if dtype == torch.float32 else 1e-2 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                   err_msg=name)
    if causal and k_off >= q_off + _HOP_T:       # wholly masked: no gradient
        assert all(not g.any() for g in got)


def test_offset_backward_defaults_are_the_plain_backward():
    """Offsets 0 and the default output type give the single-device passes
    bit for bit; an f32 output is the unrounded accumulator."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _hop_inputs(5))
    o, lse = fa.flash_attention_lse_reference(q, k, v, True)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, True)
    dq = fa.flash_attention_bwd_dq(*args, None, 0, 0, None)
    assert dq.dtype == torch.bfloat16
    assert torch.equal(dq, fa.flash_attention_bwd_dq_reference(*args))
    dq32 = fa.flash_attention_bwd_dq(*args, out_dtype=torch.float32)
    assert dq32.dtype == torch.float32 and torch.equal(dq32.bfloat16(), dq)
    dk, dv = fa.flash_attention_bwd_dkv(*args, out_dtype=torch.float32)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(*args)
    assert torch.equal(dk.bfloat16(), want_dk)
    assert torch.equal(dv.bfloat16(), want_dv)
    with pytest.raises(TypeError, match="out_dtype"):
        fa.flash_attention_bwd_dq(*args, out_dtype=torch.float16)


def test_partial_rejects_unequal_chunks_and_bad_offsets():
    q, k, v, _ = (torch.from_numpy(a) for a in _hop_inputs(6))
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_attention_partial(q, k[:, :16], v[:, :16], 0, 0)
    with pytest.raises(ValueError, match="offsets"):
        fa.flash_attention_partial(q, k, v, -1, 0)


def test_rejects_mismatched_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv_np(4, 8))
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_attention(q, k[:, :4], v)
    with pytest.raises(TypeError, match="share a dtype"):
        fa.flash_attention(q, k.double(), v)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (atol, rtol): last-bit flips of the output; row_rtol: the kernel rounds
# p against its running max, the plain version against the row max
_TOL = {torch.float32: (1e-5, 1e-5), torch.float16: (2e-3, 2e-3),
        torch.bfloat16: (1e-2, 1e-2)}
_ROW_RTOL = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 1e-2}


def _assert_close_on_card(out, want):
    """Element-wise, and per output row (one query, one head) relative to
    the row's norm: the row check sees an error of a few percent in outputs
    far smaller than 1, such as padded keys of a ragged tile let in."""
    atol, rtol = _TOL[out.dtype]
    torch.testing.assert_close(out, want, atol=atol, rtol=rtol)
    assert _row_rel_err(out, want).max().item() <= _ROW_RTOL[out.dtype]


def _row_rel_err(out, want):
    diff = (out.float() - want.float()).norm(dim=-1)
    return diff / want.float().norm(dim=-1).clamp_min(1e-30)


@pytest.mark.parametrize("t,scale", [(1025, None), (1000, 0.05)])
def test_row_check_sees_padded_keys_let_in(t, scale):
    """A kernel that let the zero-padded keys of a ragged last tile into
    the softmax passes the element-wise bf16 check but moves every row by
    well over the row tolerance (about 2-5% at these shapes)."""
    q, k, v = _strided_qkv(t, 64, torch.bfloat16, "cpu", seed=6, h=8)
    want = fa.flash_attention_reference(q, k, v, False, scale)
    zeros = torch.zeros(2, (-t) % 64, 8, 64, dtype=torch.bfloat16)
    padded = [torch.cat([a, zeros], 1) for a in (q, k, v)]
    leak = fa.flash_attention_reference(*padded, False, scale)[:, :t]
    atol, rtol = _TOL[torch.bfloat16]
    torch.testing.assert_close(leak, want, atol=atol, rtol=rtol)
    assert _row_rel_err(leak, want).min().item() > 1.5 * _ROW_RTOL[
        torch.bfloat16]


def _strided_qkv(t, d, dtype, device, seed=0, b=2, h=3):
    """q, k, v as the model makes them: [B, T, H, d] views into one
    [B, T, 3*H*d] projection (row stride 3*H*d, not contiguous)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=device,
                      dtype=torch.float32).to(dtype)
    return [a.reshape(b, t, h, d) for a in qkv.split(h * d, -1)]


# (b, h, t) of the forward sweeps on the card: B=2, H=3 at ragged and exact
# 64-row tiles; B=1, H=1 around the tiles of the Hopper kernel, 128 keys
# and 192 query rows at D <= 64 (128 at D = 128): one row, half a tile, a
# key tile and one row either side of it, a query tile and one, two key
# tiles and one
_FWD_SHAPES = [(2, 3, t) for t in (1, 63, 64, 200, 257)] + [
    (1, 1, t) for t in (1, 64, 127, 128, 129, 192, 193, 257)]
# every shape as the model's strided views; the tile edges also contiguous
_FWD_CASES = [("qkv", shape) for shape in _FWD_SHAPES] + [
    ("contiguous", shape) for shape in _FWD_SHAPES if shape[0] == 1]


def _card_inputs(layout, b, h, t, d, dtype, device, seed=None):
    """q, k, v as `flash_causal_attention` passes them ("qkv": [B, T, H, d]
    views split out of one [B, T, 3*H*d] projection, row stride 3*H*d), or
    as contiguous copies; the seed defaults to t."""
    q, k, v = _strided_qkv(t, d, dtype, device, seed=t if seed is None
                           else seed, b=b, h=h)
    if layout == "contiguous":
        q, k, v = (a.contiguous() for a in (q, k, v))
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_matches_plain_on_card(cuda, dtype, d):
    for layout, (b, h, t) in _FWD_CASES:
        for causal in (True, False):
            q, k, v = _card_inputs(layout, b, h, t, d, dtype, cuda)
            before = fa.launches["fwd"]
            out = fa.flash_attention(q, k, v, causal)
            assert fa.launches["fwd"] == before + 1
            want = fa.flash_attention_reference(q, k, v, causal)
            torch.cuda.synchronize()
            assert out.dtype == dtype and out.shape == q.shape
            _assert_close_on_card(out, want)


@pytest.mark.gpu
def test_kernel_scale_override_on_card(cuda):
    q, k, v = _strided_qkv(300, 64, torch.bfloat16, cuda, seed=5)
    out = fa.flash_attention(q, k, v, False, 0.05)
    _assert_close_on_card(out,
                          fa.flash_attention_reference(q, k, v, False, 0.05))


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v = _strided_qkv(16, 48, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _strided_qkv(16, 64, torch.float64, cuda)
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        fa.flash_attention(q, k, v)
    q, k, v = _strided_qkv(16, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q.transpose(1, 3), k.transpose(1, 3),
                           v.transpose(1, 3))
    # the tensor maps take rows that start 16 bytes apart and a 16-byte
    # aligned base: a head stride of 68 elements (136 bytes) and a
    # contiguous view starting 4 elements (8 bytes) in break that, in K1
    # and in K2
    wide = torch.randn(1, 16, 2, 68, device=cuda).to(torch.bfloat16)
    flat = torch.randn(16 * 2 * 64 + 4, device=cuda).to(torch.bfloat16)
    for bad in (wide[..., :64], flat[4:].view(1, 16, 2, 64)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention(bad, bad, bad)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_fwd_lse(bad, bad, bad)
    # and in K4 and K5, whose tensor maps take q, k, v as they are: a q that
    # breaks the rule raises; a do that breaks it (autograd hands dO over as
    # it comes) is copied to a fresh contiguous tensor and the kernels run
    good = _strided_qkv(16, 64, torch.bfloat16, cuda, b=1, h=2)
    do = torch.randn(1, 16, 2, 64, device=cuda).to(torch.bfloat16)
    o, lse = fa.flash_attention_lse_reference(*good, True)
    delta = fa.attention_delta(o, do)
    for bad in (wide[..., :64], flat[4:].view(1, 16, 2, 64)):
        for kernel in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
            with pytest.raises(ValueError, match="16-byte aligned"):
                kernel(bad, *good[1:], do, lse, delta, True)
        bad.copy_(do)
        args = (*good, bad, lse, delta)
        before = dict(fa.launches)
        got = (fa.flash_attention_bwd_dq(*args, True),
               *fa.flash_attention_bwd_dkv(*args, True))
        assert fa.launches["bwd_dq"] == before["bwd_dq"] + 1
        assert fa.launches["bwd_dkv"] == before["bwd_dkv"] + 1
        want = (fa.flash_attention_bwd_dq_reference(*args, True),
                *fa.flash_attention_bwd_dkv_reference(*args, True))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _assert_grad_close_on_card(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fwd_lse_kernel_matches_plain_on_card(cuda, dtype, d):
    """K2 against its plain version: o as K1 is held, lse (f32) to 1e-5
    (the kernel's running max and sum against the row's, both in f32)."""
    for layout, (b, h, t) in _FWD_CASES:
        for causal in (True, False):
            q, k, v = _card_inputs(layout, b, h, t, d, dtype, cuda)
            before = fa.launches["fwd_lse"]
            out, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
            assert fa.launches["fwd_lse"] == before + 1
            want, want_lse = fa.flash_attention_lse_reference(q, k, v,
                                                              causal)
            torch.cuda.synchronize()
            _assert_close_on_card(out, want)
            torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


def _assert_grad_close_on_card(got, want):
    """As `_assert_close_on_card`, with the row bound floored at the
    element-wise atol: a gradient row can be ~0 (at T=1, dS = p(dP - delta)
    is a difference of two equal sums), and a relative bound on it would
    measure rounding noise."""
    atol, rtol = _TOL[got.dtype]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    diff = (got.float() - want.float()).norm(dim=-1)
    bound = _ROW_RTOL[got.dtype] * want.float().norm(dim=-1) + atol
    assert (diff <= bound).all(), (diff - bound).max().item()


# T of the backward sweeps on the card (B=2, H=3): one row, ragged and exact
# 64-row tiles, and the edges of the Hopper kernels' tiles: 64-query (K5)
# and 128-row (K4's queries and keys, K5's keys) tiles, one row either side
# of one and of two 128-row tiles and of three 64-query tiles
_BWD_T = (1, 63, 64, 127, 128, 129, 191, 192, 193, 200, 257)
_LAYOUTS = ("qkv", "contiguous")


def _bwd_inputs(t, d, dtype, device, causal, seed, layout="qkv"):
    q, k, v = _card_inputs(layout, 2, 3, t, d, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    o, lse = fa.flash_attention_lse_reference(q, k, v, causal)
    return q, k, v, do, lse, fa.attention_delta(o, do)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bwd_kernels_match_plain_on_card(cuda, dtype, d):
    """K4 (dq) and K5 (dk, dv) against their plain versions on the same
    (q, k, v, dO, lse, delta), as the model's qkv views and contiguous;
    ragged T leaves padded keys and padded queries in the last tiles."""
    for layout, t, causal in itertools.product(_LAYOUTS, _BWD_T,
                                               (True, False)):
        args = _bwd_inputs(t, d, dtype, cuda, causal, seed=t, layout=layout)
        before = dict(fa.launches)
        dq = fa.flash_attention_bwd_dq(*args, causal)
        dk, dv = fa.flash_attention_bwd_dkv(*args, causal)
        assert fa.launches["bwd_dq"] == before["bwd_dq"] + 1
        assert fa.launches["bwd_dkv"] == before["bwd_dkv"] + 1
        want_dq = fa.flash_attention_bwd_dq_reference(*args, causal)
        want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(*args, causal)
        torch.cuda.synchronize()
        for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
            assert got.dtype == dtype and got.shape == args[0].shape
            _assert_grad_close_on_card(got, want)


@pytest.mark.gpu
def test_autograd_on_card_takes_expanded_grad(cuda):
    """out.sum().backward() hands the backward an expanded dO (stride 0);
    the wrapper copies it and the kernels run: K2 once, K4 and K5 once
    each, no K1, and the grads match the plain backward."""
    q, k, v = (a.detach().requires_grad_() for a in
               _strided_qkv(130, 64, torch.bfloat16, cuda, seed=9))
    before = dict(fa.launches)
    out = fa.flash_attention(q, k, v, True)
    out.sum().backward()
    counts = {n: fa.launches[n] - before[n] for n in before}
    assert counts == {"fwd": 0, "fwd_lse": 1, "partial": 0, "bwd_dq": 1,
                      "bwd_dkv": 1}
    o, lse = fa.flash_attention_lse_reference(q.detach(), k.detach(),
                                              v.detach(), True)
    want = fa.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), o, lse, torch.ones_like(o), True)
    torch.cuda.synchronize()
    for leaf, w in zip((q, k, v), want):
        _assert_grad_close_on_card(leaf.grad, w)


def _hops_for(t):
    """(q_off, k_off, causal) for chunks of t rows: diagonal, visible,
    wholly masked, the two part overlaps, non-causal."""
    return [(t, t, True), (2 * t, 0, True), (0, t, True),
            (0, t // 2, True), (t // 2, 0, True), (0, t, False)]


def _assert_partial_close_on_card(got, want, dtype):
    """acc element-wise and per row after dividing both by the plain l,
    which puts it on the output's scale, where K1's bounds for the input
    type apply; a row that sees no key has l = 0 and its acc must be
    exactly 0. m: 1e-5 abs (the same f32 scores, maxed in another order;
    masked rows exactly -1e30). l: 1e-5 relative, 1e-6 abs: f32 sums of
    the same p in another order, rescaled once per kv tile."""
    acc, m, l = got
    w_acc, w_m, w_l = want
    norm = w_l.clamp_min(1e-30).transpose(1, 2)[..., None]
    atol, rtol = _TOL[dtype]
    torch.testing.assert_close(acc / norm, w_acc / norm, atol=atol,
                               rtol=rtol)
    assert _row_rel_err(acc / norm, w_acc / norm).max() <= _ROW_RTOL[dtype]
    torch.testing.assert_close(m, w_m, atol=1e-5, rtol=0)
    torch.testing.assert_close(l, w_l, atol=1e-6, rtol=1e-5)
    unseen = w_l == 0
    assert (m[unseen] == fa.FINITE_NEG).all() and (l[unseen] == 0).all()
    assert not acc.transpose(1, 2)[unseen].any()


# K3's shapes on the card: one head of 64 rows (one consumer warpgroup's
# rows and one 64-key tile) and of 128 rows first, then the Hopper kernel's
# tile edges (its kv tiles are 64 keys, its query tiles 192 rows at D <= 64
# and 128 at D = 128): one row, 64 and 128 rows less and at, 128 and 192
# rows less, at and past, a ragged 200, and 4 and 6 kv tiles and one.
_PARTIAL_SINGLE_T = (64, 128)
_PARTIAL_T = (1, 63, 64, 127, 128, 129, 191, 192, 193, 200, 257, 385)


def _partial_hops_for(t):
    """`_hops_for(t)` and offsets off the tile edges, so the causal mask
    falls inside a tile: keys 37 rows later or earlier, a kv chunk whose
    first key only the last row sees, and a non-causal hop at (100, 0)."""
    return _hops_for(t) + [(0, 37, True), (37, 0, True), (0, t - 1, True),
                           (100, 0, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_partial_kernel_matches_plain_on_card(cuda, dtype, d):
    """K3 against its plain version on every kind of hop and on offsets
    that put the causal edge inside a tile: single tiles of one head
    first, then the tile edges with ragged T."""
    shapes = ([(t, 1, 1) for t in _PARTIAL_SINGLE_T]
              + [(t, 2, 3) for t in _PARTIAL_T])
    for t, b, h in shapes:
        q, k, v = _strided_qkv(t, d, dtype, cuda, seed=t, b=b, h=h)
        for q_off, k_off, causal in _partial_hops_for(t):
            before = fa.launches["partial"]
            got = fa.flash_attention_partial(q, k, v, q_off, k_off, causal)
            assert fa.launches["partial"] == before + 1
            want = fa.flash_attention_partial_reference(q, k, v, q_off,
                                                        k_off, causal)
            torch.cuda.synchronize()
            _assert_partial_close_on_card(got, want, dtype)


def _hop_bwd_inputs(t, d, dtype, device, q_off, k_off, causal, seed,
                    layout="qkv"):
    """As `_bwd_inputs`, with lse and delta from the plain partial of the
    same hop, so every row with a visible key has its exact softmax."""
    q, k, v = _card_inputs(layout, 2, 3, t, d, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    acc, m, l = fa.flash_attention_partial_reference(q, k, v, q_off, k_off,
                                                     causal)
    l = l.clamp_min(1e-30)
    o = (acc / l.transpose(1, 2)[..., None]).to(dtype)
    return q, k, v, do, m + torch.log(l), fa.attention_delta(o, do)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bwd_kernels_with_offsets_on_card(cuda, dtype, d):
    """K4 and K5 with a hop's offsets, f32 outputs and the input type,
    against their plain versions, as the model's qkv views and contiguous;
    a wholly masked hop gives exact zeros."""
    for layout, t in itertools.product(_LAYOUTS, _BWD_T):
        for q_off, k_off, causal in _hops_for(t):
            args = _hop_bwd_inputs(t, d, dtype, cuda, q_off, k_off, causal,
                                   seed=t, layout=layout)
            for out_dtype in (torch.float32, dtype):
                kw = dict(q_off=q_off, k_off=k_off, out_dtype=out_dtype)
                dq = fa.flash_attention_bwd_dq(*args, causal, **kw)
                dk, dv = fa.flash_attention_bwd_dkv(*args, causal, **kw)
                want_dq = fa.flash_attention_bwd_dq_reference(*args, causal,
                                                              **kw)
                want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
                    *args, causal, **kw)
                torch.cuda.synchronize()
                for got, want in ((dq, want_dq), (dk, want_dk),
                                  (dv, want_dv)):
                    assert got.dtype == out_dtype
                    if got.dtype != dtype:   # f32 outputs: input-type bounds
                        got, want = got.to(dtype), want.to(dtype)
                    _assert_grad_close_on_card(got, want)
                    if causal and k_off >= q_off + t:
                        assert not got.any()
