"""The port's TransformerLM inference against the JAX package's (training:
tests/test_torch_training.py).

The JAX package draws the weights (`init_lm`, V=64, d=64, H=4, L=2,
max_len=64, f32); the bridge `TransformerLM.from_jax_params` carries them
over, and the same numpy tokens go to both. Logits agree to 1e-5 (f32, both
attention modes); greedy token streams are equal. JAX's flash path runs the
Pallas kernel in interpret mode (seconds per call), so it runs once per
module and long token streams are held against JAX's dense
`generate_batch`, which the JAX package pins equal to its other paths.

Tests marked `gpu` run the model on the card and skip without one.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.zoo.transformer import (
    TransformerLM, init_block, init_kv_cache, init_lm)
from deeplearning4j_tpu_torch.ops import flash_attention as fa

V, DM, NH, NL, MAXLEN = 64, 64, 4, 2, 64
N_NEW = 12


def _prompts(seed=0, b=2, p=8):
    return np.random.default_rng(seed).integers(0, V, (b, p))


@pytest.fixture(scope="module")
def ref():
    """JAX models (dense and flash, one set of weights) and those weights as
    numpy, plus the JAX dense greedy streams of `_prompts()`."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeplearning4j_tpu.models.zoo.transformer import TransformerLM as J
    dense = J(V, d_model=DM, n_heads=NH, n_layers=NL, max_len=MAXLEN,
              seed=0, dtype=jnp.float32)
    flash = J(V, d_model=DM, n_heads=NH, n_layers=NL, max_len=MAXLEN,
              seed=0, dtype=jnp.float32, attention="flash")
    flash.aux, flash.blocks = dense.aux, dense.blocks
    aux, blocks = jax.tree.map(np.asarray, (dense.aux, dense.blocks))
    streams = dense.generate_batch(_prompts(), N_NEW)
    return {"dense": dense, "flash": flash, "aux": aux, "blocks": blocks,
            "streams": np.asarray(streams)}


def _port(ref, attention, device="cpu"):
    return TransformerLM.from_jax_params(ref["aux"], ref["blocks"], NH,
                                         attention=attention, device=device)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_match_jax(ref, attention):
    x = np.random.default_rng(1).integers(0, V, (2, 24))
    want = np.asarray(ref[attention].logits(x))
    got = _port(ref, attention).logits(x)
    assert got.dtype == torch.float32 and got.shape == (2, 24, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bridge_copies_every_weight(ref):
    lm = _port(ref, "dense")
    sd = lm.state_dict()
    assert len(sd) == 5 + 10 * NL
    np.testing.assert_array_equal(sd["aux.tok"].numpy(), ref["aux"]["tok"])
    np.testing.assert_array_equal(sd["blocks.1.mlp.w2"].numpy(),
                                  ref["blocks"][1]["mlp"]["w2"])
    np.testing.assert_array_equal(sd["blocks.0.attn.wqkv"].numpy(),
                                  ref["blocks"][0]["attn"]["wqkv"])


def _tree_map(f, x):
    if isinstance(x, dict):
        return {k: _tree_map(f, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_map(f, v) for v in x]
    return f(x)


def test_bridge_takes_bf16_through_f32(ref):
    import ml_dtypes
    bf = lambda a: np.asarray(a).astype(ml_dtypes.bfloat16)
    aux, blocks = _tree_map(bf, ref["aux"]), _tree_map(bf, ref["blocks"])
    lm = TransformerLM.from_jax_params(aux, blocks, NH, device="cpu")
    assert {t.dtype for t in lm.state_dict().values()} == {torch.bfloat16}
    np.testing.assert_array_equal(lm.aux.tok.detach().float().numpy(),
                                  aux["tok"].astype(np.float32))
    np.testing.assert_array_equal(
        lm.blocks[1].attn.wo.detach().float().numpy(),
        blocks[1]["attn"]["wo"].astype(np.float32))


@pytest.mark.parametrize("attention,use_cache", [
    ("flash", False), ("dense", False), ("dense", True), ("flash", True)])
def test_greedy_generate_matches_jax_streams(ref, attention, use_cache):
    lm = _port(ref, attention)
    for row, prompt in enumerate(_prompts()):
        got = lm.generate(prompt, N_NEW, use_cache=use_cache)
        np.testing.assert_array_equal(got, ref["streams"][row])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_greedy_generate_batch_matches_jax(ref, attention):
    got = _port(ref, attention).generate_batch(_prompts(), N_NEW)
    np.testing.assert_array_equal(got, ref["streams"])


@pytest.mark.parametrize("seed", [0, 5])
def test_sampled_generate_matches_jax(ref, seed):
    """Both packages sample on the host with np.random.default_rng(seed)
    from f32 logits that agree to 1e-5, so the draws agree."""
    prompt = _prompts(seed)[0]
    want = ref["dense"].generate(prompt, N_NEW, temperature=0.8, seed=seed,
                                 use_cache=True)
    lm = _port(ref, "flash")
    for use_cache in (True, False):
        got = lm.generate(prompt, N_NEW, temperature=0.8, seed=seed,
                          use_cache=use_cache)
        assert got == [int(t) for t in want]


def test_sampled_generate_batch_is_deterministic_per_seed(ref):
    lm = _port(ref, "dense")
    a = lm.generate_batch(_prompts(), N_NEW, temperature=1.0, seed=3)
    b = lm.generate_batch(_prompts(), N_NEW, temperature=1.0, seed=3)
    c = lm.generate_batch(_prompts(), N_NEW, temperature=1.0, seed=4)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 8 + N_NEW) and (a >= 0).all() and (a < V).all()
    np.testing.assert_array_equal(a[:, :8], _prompts())
    assert (a != c).any()


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(V, d_model=DM, n_heads=NH, n_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(V, d_model=DM, n_heads=NH, n_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_block(torch.Generator(), DM, NH, 4 * DM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(1, 1, MAXLEN, DM, NH)
    aux, blocks = init_lm(V, d_model=DM, n_heads=NH, n_layers=1,
                          device="cpu")
    assert aux.tok.device.type == blocks[0].attn.wqkv.device.type == "cpu"
    np_ = lambda t: t.detach().numpy()
    as_np = {"tok": np_(aux.tok), "pos": np_(aux.pos),
             "head": np_(aux.head),
             "lnf": {"g": np_(aux.lnf.g), "b": np_(aux.lnf.b)}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM.from_jax_params(as_np, [], NH)
    lm = TransformerLM(V, d_model=DM, n_heads=NH, n_layers=1, device="cpu")
    assert lm.device.type == "cpu"
    assert lm.logits([[1, 2, 3]]).shape == (1, 3, V)


def test_same_seed_same_weights_and_flash_equals_dense():
    a = TransformerLM(V, d_model=DM, n_heads=NH, n_layers=NL, seed=2,
                      max_len=MAXLEN, attention="flash", device="cpu")
    b = TransformerLM(V, d_model=DM, n_heads=NH, n_layers=NL, seed=2,
                      max_len=MAXLEN, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    x = _prompts(3, p=20)
    torch.testing.assert_close(a.logits(x), b.logits(x), rtol=0, atol=1e-5)


def test_unported_paths_and_limits_raise():
    lm = TransformerLM(V, d_model=DM, n_heads=NH, n_layers=1,
                       max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        lm.generate([1] * 10, 7, use_cache=True)
    with pytest.raises(ValueError, match="max_len"):
        lm.generate_batch([[1] * 10], 7)
    with pytest.raises(ValueError, match="attention"):
        TransformerLM(V, d_model=DM, n_heads=NH, n_layers=1,
                      attention="sparse", device="cpu")
    # without a cache the context slides: the last max_len tokens
    assert len(lm.generate([1] * 15, 3)) == 18


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 compared in f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_flash_model_on_card_matches_cpu(cuda):
    """Same seed, f32: logits through the kernel on the card agree with the
    plain versions on the CPU (1e-4: cuBLAS and the CPU sum in another
    order across 2 layers of width 256), and the flash re-encode path gives
    the dense KV-cache path's greedy tokens."""
    kw = dict(vocab_size=128, d_model=256, n_heads=4, n_layers=2,
              max_len=256, seed=1, attention="flash")
    gpu = TransformerLM(**kw, device=cuda)
    cpu = TransformerLM(**kw, device="cpu")
    x = _prompts(2, b=2, p=200) % 128
    fa.reset_launches()
    got = gpu.logits(x)
    assert fa.launches == {"fwd": 2, "fwd_lse": 0, "partial": 0, "bwd_dq": 0,
                           "bwd_dkv": 0}
    torch.testing.assert_close(got.cpu(), cpu.logits(x), rtol=0, atol=1e-4)
    prompt = x[0, :50]
    assert (gpu.generate(prompt, 6, use_cache=False)
            == gpu.generate(prompt, 6, use_cache=True))
