"""The port's TransformerLM training (`fit_batch`) against the JAX package's.

The JAX package draws the weights (`init_lm`, V=64, d=64, H=4, L=2,
max_len=T=32, f32, seed 0) and the bridge `TransformerLM.from_jax_params`
carries them over; the same numpy batch (B=2, T=32, the shift task
y = (x + 1) % V) goes to both. With attention "dense" and "flash" (JAX: the
Pallas kernels in interpret mode; the port on the CPU: the plain versions
behind the autograd Function):
  - the first loss and every parameter gradient agree to 1e-5 (read on
    the CPU: 9.5e-7 for the loss, 6.6e-7 for the gradients, both modes);
  - three fit_batch steps (SGD, lr 0.1, momentum 0.9): the losses and the
    final parameters agree to 1e-4 (read: losses 4.523 -> 3.521 -> 2.943,
    equal to 2.4e-7; parameters to 1.9e-7).
JAX runs once per module, in one fixture.

Tests marked `gpu` train on the card and skip without one.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.zoo.transformer import TransformerLM
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.parallel.pipeline import sgd_momentum_update

V, DM, NH, NL, T, B = 64, 64, 4, 2, 32, 2
STEPS = 3


def _batch(seed=0):
    x = np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)
    return x, (x + 1) % V


def _named(aux, blocks):
    """The JAX package's (aux, blocks) tree as {state-dict name: array}."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key, val in node.items():
                walk(f"{prefix}.{key}", val)
        elif isinstance(node, (list, tuple)):
            for i, val in enumerate(node):
                walk(f"{prefix}.{i}", val)
        else:
            out[prefix] = np.array(node)

    walk("aux", aux)
    walk("blocks", blocks)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Per attention mode: the initial weights, the first loss and its
    gradients, the losses of STEPS fit_batch steps and the final weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeplearning4j_tpu.models.zoo.transformer import TransformerLM as J
    x, y = _batch()
    runs = {}
    for attention in ("dense", "flash"):
        lm = J(V, d_model=DM, n_heads=NH, n_layers=NL, max_len=T, seed=0,
               dtype=jnp.float32, attention=attention)
        # copies: fit_batch donates the weights' buffers
        aux, blocks = jax.tree.map(np.array, (lm.aux, lm.blocks))
        loss, grads = jax.value_and_grad(lm._loss, argnums=(0, 1))(
            lm.aux, lm.blocks, jnp.asarray(x), jnp.asarray(y))
        first = {"loss": float(loss), "grads": _named(*grads)}
        losses = [lm.fit_batch(x, y) for _ in range(STEPS)]
        runs[attention] = dict(first, aux=aux, blocks=blocks, losses=losses,
                               final=_named(lm.aux, lm.blocks))
    return runs


def _port(run, attention, device="cpu"):
    return TransformerLM.from_jax_params(run["aux"], run["blocks"], NH,
                                         attention=attention, device=device)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_first_loss_and_grads_match_jax(jax_runs, attention):
    run = jax_runs[attention]
    lm = _port(run, attention)
    names, params = zip(*lm.named_parameters())
    x, y = (torch.from_numpy(a).long() for a in _batch())
    loss = lm._loss(x, y)
    grads = torch.autograd.grad(loss, params)
    assert abs(loss.item() - run["loss"]) <= 1e-5
    assert sorted(names) == sorted(run["grads"])
    for name, grad in zip(names, grads):
        np.testing.assert_allclose(grad.numpy(), run["grads"][name], rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_three_steps_match_jax(jax_runs, attention):
    run = jax_runs[attention]
    lm = _port(run, attention)
    losses = [lm.fit_batch(*_batch()) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, run["losses"], rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
    for name, p in lm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), run["final"][name],
                                   rtol=0, atol=1e-4, err_msg=name)


def test_sgd_momentum_update_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    from deeplearning4j_tpu.parallel.pipeline import (
        sgd_momentum_update as jax_update)
    rng = np.random.default_rng(3)
    p, v, g = (rng.standard_normal((4, 5)).astype(np.float32)
               for _ in range(3))
    (want_p,), (want_v,) = jax_update([jnp.asarray(p)], [jnp.asarray(v)],
                                      [jnp.asarray(g)], 0.1, 0.9)
    params, vel = [torch.from_numpy(p.copy())], [torch.from_numpy(v.copy())]
    out = sgd_momentum_update(params, vel, [torch.from_numpy(g)], 0.1, 0.9)
    assert out[0] is params and out[1] is vel   # updated in place
    np.testing.assert_allclose(vel[0].numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(params[0].numpy(), np.asarray(want_p),
                               rtol=0, atol=1e-6)


def _within_half_ulp(got, exact):
    """|got - exact| <= half a bf16 step of got (8 significant bits), with
    slack for the f32 intermediate: `got` is `exact` rounded once."""
    _, exp = torch.frexp(got.double())
    half_ulp = torch.ldexp(torch.ones_like(exact), exp - 9)
    return ((got.double() - exact).abs() <= half_ulp * (1 + 2**-12)).all()


def test_sgd_momentum_update_rounds_bf16_once():
    """v <- mu*v + g and p <- p - lr*v each round once to bf16, with mu and
    lr as given: bf16 arithmetic (two roundings, or alpha rounded to bf16)
    misses the exact values by more than half a step."""
    gen = torch.Generator().manual_seed(4)
    p, v, g = (torch.randn(4096, generator=gen).bfloat16() for _ in range(3))
    params, vel = [p.clone()], [v.clone()]
    sgd_momentum_update(params, vel, [g], 0.1, 0.9)
    assert vel[0].dtype == params[0].dtype == torch.bfloat16
    assert _within_half_ulp(vel[0], g.double() + 0.9 * v.double())
    assert _within_half_ulp(params[0],
                            p.double() - 0.1 * vel[0].double())
    assert not _within_half_ulp((0.9 * v) + g, g.double() + 0.9 * v.double())
    assert not _within_half_ulp(torch.add(g, v, alpha=0.9),
                                g.double() + 0.9 * v.double())


def test_fit_batch_bf16_keeps_dtypes_and_learns():
    """bf16 on the CPU: velocities in the parameter dtype (as JAX's
    zeros_like), finite falling losses on the shift task, and no kernel
    launch counted off the card."""
    lm = TransformerLM(V, d_model=DM, n_heads=NH, n_layers=1, max_len=T,
                       dtype=torch.bfloat16, attention="flash", device="cpu")
    before = dict(fa.launches)
    losses = [lm.fit_batch(*_batch(1)) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert [v.dtype for v in lm._vel] == [torch.bfloat16] * len(lm._vel)
    assert all(p.dtype == torch.bfloat16 for p in lm.parameters())
    assert fa.launches == before


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 compared in f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_flash_training_on_card_matches_cpu(cuda):
    """Same seed, f32, three fit_batch steps: through the kernels on the
    card (per step n_layers launches each of K2, K4 and K5, none of K1)
    and through the plain versions on the CPU. Losses and parameters agree
    to 1e-4 (cuBLAS and the CPU sum the products in another order, and the
    updates carry the difference on)."""
    kw = dict(vocab_size=128, d_model=256, n_heads=4, n_layers=2,
              max_len=256, seed=1, attention="flash")
    gpu = TransformerLM(**kw, device=cuda)
    cpu = TransformerLM(**kw, device="cpu")
    x = np.random.default_rng(2).integers(0, 128, (2, 200))
    y = (x + 1) % 128
    fa.reset_launches()
    got = [gpu.fit_batch(x, y) for _ in range(STEPS)]
    assert fa.launches == {"fwd": 0, "fwd_lse": 2 * STEPS, "partial": 0,
                           "bwd_dq": 2 * STEPS, "bwd_dkv": 2 * STEPS}
    want = [cpu.fit_batch(x, y) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[-1] < got[0]
    for (name, a), (_, b) in zip(gpu.named_parameters(),
                                 cpu.named_parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)
