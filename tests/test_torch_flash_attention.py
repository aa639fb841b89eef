"""The port's flash-attention forward against the JAX package's.

On the CPU the port's `flash_attention` runs its plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode, as its own tests do. The
same inputs, made with numpy from a seed, go to both. Tolerances: 1e-5 abs
in f32; rel 2e-2 (abs floor 1e-2, about one bf16 step near 1) in bf16.

Tests marked `gpu` hold the CUDA kernel against the plain version on the
card and skip without one. JAX is imported inside fixtures, so the card-only
tests also run where JAX is not installed:
    python -m pytest --noconftest tests/test_torch_flash_attention.py -m gpu
"""
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
    before = fa.launches
    out = fa.flash_attention(q, k, v, False, 0.2)
    assert fa.launches == before
    torch.testing.assert_close(
        out, fa.flash_attention_reference(q, k, v, False, 0.2), rtol=0,
        atol=0)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_matches_plain_on_card(cuda, dtype, d):
    for t in (1, 63, 64, 200, 257):
        for causal in (True, False):
            q, k, v = _strided_qkv(t, d, dtype, cuda, seed=t)
            before = fa.launches
            out = fa.flash_attention(q, k, v, causal)
            assert fa.launches == before + 1
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
