"""The port's layers, activations, losses, weight init and updaters
(`deeplearning4j_tpu_torch.nn`) against the JAX package's.

The same inputs, made with numpy from a seed, go to both packages: the
reference runs on JAX's CPU backend, the port on torch's CPU. Images go to
the reference as NHWC and to the port as its NCHW view of the same bytes
(channels_last), kernels as HWIO and OIHW (`from_reference`). Each check
compares the forward and the gradients of sum(y · ct) for a random
cotangent ct (x and each parameter).

Tolerances, f32: 1e-5 absolute plus 1e-5 relative (outputs and gradients
are O(1); the two backends sum conv windows and reductions in other
orders, which moves the last bit or two). Updaters: 1e-6 relative on the
update and each state. Weight init cannot match the JAX PRNG's draws, so
it is held to shapes, means and variances (6 standard errors).

Tests marked `gpu` compare the port on the card with the port on the CPU
and skip without a card:
    python -m pytest --noconftest tests/test_torch_nn_layers.py -m gpu
"""
import math
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import activations as TA
from deeplearning4j_tpu_torch.nn import losses as TL
from deeplearning4j_tpu_torch.nn import weights as TW
from deeplearning4j_tpu_torch.nn.conf import layers as TLy
from deeplearning4j_tpu_torch.nn.conf.layers import convolution as TConv
from deeplearning4j_tpu_torch.nn.conf.preprocessors import from_nhwc, to_nhwc
from deeplearning4j_tpu_torch.nn.updater import updaters as TU

ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules under test, on its CPU backend."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn import activations, losses
    from deeplearning4j_tpu.nn.conf import layers
    from deeplearning4j_tpu.nn.updater import updaters
    return types.SimpleNamespace(jax=jax, jnp=jnp, activations=activations,
                                 losses=losses, layers=layers,
                                 updaters=updaters)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _port_t(a):
    """numpy (reference layout: NHWC for 4-D) -> the port's tensor."""
    t = torch.tensor(a)
    return from_nhwc(t) if t.ndim == 4 else t


def _ref_np(t):
    """The port's tensor -> numpy in the reference's layout."""
    t = t.detach()
    return (to_nhwc(t) if t.ndim == 4 else t).numpy()


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


def _vjp_both(J, jfn, tfn, x, params, seed=99, port_params=None):
    """Forward and gradients of sum(y·ct) of the reference's `jfn(params,
    x)` and the port's `tfn(params, x)`. Returns ((y, dx, dparams) of JAX,
    the same of the port), all numpy in the reference's layout."""
    jax, jnp = J.jax, J.jnp
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    y_shape = jax.eval_shape(jfn, jp, jnp.asarray(x)).shape
    ct = _rand(seed, y_shape)

    def loss(p, xx):
        return jnp.sum(jfn(p, xx) * ct)

    y_j = np.asarray(jax.jit(jfn)(jp, jnp.asarray(x)))
    dp_j, dx_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = port_params if port_params is not None else {
        k: torch.tensor(v) for k, v in params.items()}
    tp = {k: v.detach().requires_grad_() for k, v in tp.items()}
    tx = _port_t(x).requires_grad_()
    y_t = tfn(tp, tx)
    grads = torch.autograd.grad(y_t, [tx] + list(tp.values()), _port_t(ct))
    dp_t = dict(zip(tp, grads[1:]))
    return ((y_j, np.asarray(dx_j), {k: np.asarray(v) for k, v in dp_j.items()}),
            (_ref_np(y_t), _ref_np(grads[0]), dp_t))


# ---------------------------------------------------------------------------
# Activations and losses
# ---------------------------------------------------------------------------

ACTS = ["identity", "sigmoid", "tanh", "relu", "leakyrelu", "elu", "selu",
        "gelu", "softplus", "softsign", "hardtanh", "hardsigmoid", "relu6",
        "cube", "rationaltanh", "rectifiedtanh", "softmax", "swish", "mish"]


def test_activation_table_is_the_reference_table(J):
    assert sorted(TA.ACTIVATIONS) == sorted(J.activations.ACTIVATIONS)
    assert sorted(ACTS + ["linear"]) == sorted(TA.ACTIVATIONS)


@pytest.mark.parametrize("name", ACTS)
def test_activation_matches_jax(J, name):
    x = _rand(1, (6, 9), 3.0)
    (y_j, dx_j, _), (y_t, dx_t, _) = _vjp_both(
        J, lambda p, xx: J.activations.get(name)(xx),
        lambda p, xx: TA.get(name)(xx), x, {})
    _close(y_t, y_j, msg=name)
    _close(dx_t, dx_j, msg=name)


def test_softmax_normalises_the_channel_axis_of_images(J):
    x = _rand(2, (2, 3, 4, 5))
    y_j = np.asarray(J.activations.softmax(J.jnp.asarray(x)))
    _close(_ref_np(TA.softmax(_port_t(x))), y_j)


LOSSES = sorted(["mcxent", "negativeloglikelihood", "xent", "mse", "l2",
                 "mae", "l1", "hinge", "squared_hinge", "squaredhinge",
                 "kl_divergence", "kld", "mape", "msle",
                 "reconstruction_crossentropy", "poisson",
                 "cosine_proximity", "cosineproximity"])
_LOSS_ACT = {"mcxent": "softmax", "negativeloglikelihood": "softmax",
             "kl_divergence": "softmax", "kld": "softmax", "xent": "sigmoid",
             "reconstruction_crossentropy": "sigmoid", "poisson": "softplus",
             "msle": "relu"}


def test_loss_table_is_the_reference_table(J):
    assert sorted(TL.LOSSES) == sorted(J.losses.LOSSES) == LOSSES


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(J, name, masked):
    rng = np.random.default_rng(3)
    pre = _rand(4, (5, 7), 2.0)
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence", "kld"):
        labels = np.eye(7, dtype=np.float32)[rng.integers(0, 7, 5)]
    elif name in ("xent", "reconstruction_crossentropy"):
        labels = (rng.random((5, 7)) > 0.5).astype(np.float32)
    elif name in ("hinge", "squared_hinge", "squaredhinge"):
        labels = np.sign(rng.standard_normal((5, 7))).astype(np.float32)
    else:
        labels = rng.random((5, 7)).astype(np.float32)
    mask = ((rng.random((5, 1)) > 0.3).astype(np.float32) if masked
            else None)
    act = _LOSS_ACT.get(name, "identity")
    jm = None if mask is None else J.jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    (y_j, dx_j, _), (y_t, dx_t, _) = _vjp_both(
        J, lambda p, xx: J.losses.get(name)(J.jnp.asarray(labels), xx, act, jm),
        lambda p, xx: TL.get(name)(torch.tensor(labels), xx, act, tm),
        pre, {})
    _close(y_t, y_j, msg=name)
    if masked and name.startswith("cosine"):
        # a masked-out row has norm 0: the reference's gradient of
        # jnp.linalg.norm there is NaN, torch's vector_norm gives 0
        assert np.isfinite(dx_t).all()
        finite = np.isfinite(dx_j).all(axis=1)
        assert not finite.all()
        dx_t, dx_j = dx_t[finite], dx_j[finite]
    _close(dx_t, dx_j, msg=name)


# ---------------------------------------------------------------------------
# Weight init: shapes and variances only (the PRNGs differ)
# ---------------------------------------------------------------------------

_VARIANCES = {  # scheme -> (mean, variance) at fan_in 50, fan_out 30
    "xavier": (0.0, 2.0 / 80), "xavier_uniform": (0.0, 6.0 / 80 / 3),
    "xavier_fan_in": (0.0, 1.0 / 50), "xavier_legacy": (0.0, 1.0 / 80),
    "relu": (0.0, 2.0 / 50), "relu_uniform": (0.0, 6.0 / 50 / 3),
    "sigmoid_uniform": (0.0, 16 * 6.0 / 80 / 3),
    "lecun_normal": (0.0, 1.0 / 50), "lecun_uniform": (0.0, 3.0 / 50 / 3),
    "uniform": (0.0, 1.0 / 50 / 3), "normal": (0.0, 1.0 / 50),
    "var_scaling_normal_fan_in": (0.0, 1.0 / 50),
}


@pytest.mark.parametrize("scheme", sorted(_VARIANCES))
def test_weight_init_shape_and_variance(scheme):
    gen = torch.Generator().manual_seed(0)
    w = TW.init(gen, (200, 300), 50, 30, scheme)
    assert w.shape == (200, 300) and w.dtype == torch.float32
    mean, var = _VARIANCES[scheme]
    n = w.numel()
    assert abs(w.mean().item() - mean) < 6 * math.sqrt(var / n)
    # the variance of a sample variance is at most 2 var² (normal) for
    # these distributions
    assert abs(w.var().item() - var) < 6 * var * math.sqrt(2.0 / n)


def test_weight_init_constants_and_distributions():
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(TW.init(gen, (3, 4), 1, 1, "zero"), torch.zeros(3, 4))
    assert torch.equal(TW.init(gen, (3, 4), 1, 1, "ones"), torch.ones(3, 4))
    assert torch.equal(TW.init(gen, (3, 3), 1, 1, "identity"), torch.eye(3))
    w = TW.init(gen, (400, 400), 1, 1, "distribution",
                {"type": "uniform", "lower": -0.5, "upper": 0.25})
    assert w.min() >= -0.5 and w.max() <= 0.25
    assert abs(w.mean().item() + 0.125) < 6 * 0.75 / math.sqrt(12 * w.numel())
    w = TW.init(gen, (400, 400), 1, 1, "distribution",
                {"type": "normal", "mean": 2.0, "std": 0.5})
    assert abs(w.mean().item() - 2.0) < 6 * 0.5 / 400
    w = TW.init(gen, (100, 100), 1, 1, "distribution",
                {"type": "binomial", "n": 4, "p": 0.25})
    assert set(w.unique().tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    with pytest.raises(ValueError):
        TW.init(gen, (2, 2), 1, 1, "nope")


def test_weight_init_is_seeded():
    a = TW.init(torch.Generator().manual_seed(5), (8, 8), 4, 4, "xavier")
    b = TW.init(torch.Generator().manual_seed(5), (8, 8), 4, 4, "xavier")
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _both(J, name, **kw):
    return getattr(J.layers, name)(**kw), getattr(TLy, name)(**kw)


def _layer_check(J, jl, tl, x, params, atol=ATOL, rtol=RTOL, train=False):
    """Forward and gradients of one layer's `forward`."""
    port_params = {k: tl.from_reference(k, torch.tensor(v))
                   for k, v in params.items()}
    (y_j, dx_j, dp_j), (y_t, dx_t, dp_t) = _vjp_both(
        J, lambda p, xx: jl.forward(p, xx, train=train),
        lambda p, xx: tl.forward(p, xx, train=train), x, params,
        port_params=port_params)
    assert y_t.shape == y_j.shape
    _close(y_t, y_j, atol, rtol, "y")
    _close(dx_t, dx_j, atol, rtol, "dx")
    for k in params:
        _close(tl.to_reference(k, dp_t[k]).numpy(), dp_j[k], atol, rtol, k)


CONV_CASES = [  # (mode, kernel, stride, padding, height, width)
    ("truncate", (5, 5), (1, 1), (0, 0), 12, 12),
    ("truncate", (3, 3), (2, 2), (1, 1), 11, 10),
    ("truncate", (3, 2), (1, 2), (2, 1), 9, 8),
    ("same", (3, 3), (1, 1), (0, 0), 9, 8),
    ("same", (3, 3), (2, 2), (0, 0), 9, 9),
    ("same", (3, 3), (2, 2), (0, 0), 8, 8),
    ("same", (7, 7), (2, 2), (0, 0), 16, 15),
    ("same", (1, 1), (2, 2), (0, 0), 9, 8),
    ("same", (4, 4), (3, 3), (0, 0), 10, 11),
]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_convolution_matches_jax(J, case, bias):
    mode, k, s, p, h, w = case
    kw = dict(n_in=3, n_out=4, kernel_size=k, stride=s, padding=p,
              convolution_mode=mode, activation="identity", has_bias=bias)
    jl, tl = _both(J, "ConvolutionLayer", **kw)
    params = {"W": _rand(1, k + (3, 4), 0.3)}
    if bias:
        params["b"] = _rand(2, (4,))
    _layer_check(J, jl, tl, _rand(3, (2, h, w, 3)), params)


def test_convolution_same_pads_as_xla():
    # the ResNet stem: 7x7/2 conv on 224 pads (2, 3); 3x3/2 pool on 112
    # pads (0, 1)
    assert TConv.same_pads(224, 7, 2) == (2, 3)
    assert TConv.same_pads(112, 3, 2) == (0, 1)
    assert TConv.same_pads(56, 1, 2) == (0, 0)
    assert TConv.same_pads(8, 3, 1) == (1, 1)


POOL_CASES = [  # (mode, kernel, stride, padding, height, width)
    ("truncate", (2, 2), (2, 2), (0, 0), 8, 8),
    ("truncate", (3, 3), (2, 2), (1, 1), 9, 10),
    ("same", (3, 3), (2, 2), (0, 0), 8, 8),
    ("same", (3, 3), (2, 2), (0, 0), 9, 7),
    ("same", (2, 2), (1, 1), (0, 0), 5, 6),
]


@pytest.mark.parametrize("pool", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_subsampling_matches_jax(J, case, pool):
    mode, k, s, p, h, w = case
    jl, tl = _both(J, "SubsamplingLayer", pooling_type=pool, kernel_size=k,
                   stride=s, padding=p, convolution_mode=mode, pnorm=3)
    _layer_check(J, jl, tl, _rand(4, (2, h, w, 3)), {})


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_argmax_gather_matches_jax_on_continuous_inputs(J, case):
    mode, k, s, p, h, w = case
    jl, tl = _both(J, "SubsamplingLayer", pooling_type="max", kernel_size=k,
                   stride=s, padding=p, convolution_mode=mode,
                   pool_backprop="argmax_gather")
    _layer_check(J, jl, tl, _rand(5, (2, h, w, 3)), {})


def test_argmax_gather_gives_every_tied_max_the_window_gradient():
    """Inside the port: in a window with two equal maxima each gets the
    whole window gradient; torch's max-pool backward (select_scatter)
    gives it to one of them."""
    x = torch.tensor([[1.0, 3.0, 0.0, 2.0],
                      [3.0, 2.0, 2.0, 1.0]]).reshape(1, 1, 2, 4)
    grads = {}
    for backprop in ("argmax_gather", "select_scatter"):
        layer = TLy.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                     pool_backprop=backprop)
        xx = x.clone().requires_grad_()
        y = layer.forward({}, xx)
        assert y.flatten().tolist() == [3.0, 2.0]
        (grads[backprop],) = torch.autograd.grad(
            y, xx, torch.tensor([10.0, 7.0]).reshape(1, 1, 1, 2))
    assert grads["argmax_gather"].flatten().tolist() == [
        0, 10, 0, 7, 10, 0, 7, 0]
    sel = grads["select_scatter"].flatten()
    assert sel.sum().item() == 17.0 and (sel != 0).sum().item() == 2


@pytest.mark.parametrize("pool", ["max", "avg", "sum"])
def test_global_pooling_matches_jax(J, pool):
    jl, tl = _both(J, "GlobalPoolingLayer", pooling_type=pool)
    _layer_check(J, jl, tl, _rand(6, (3, 5, 4, 6)), {})


@pytest.mark.parametrize("pool", ["max", "avg", "sum"])
def test_global_pooling_masked_time_series_matches_jax(J, pool):
    jl, tl = _both(J, "GlobalPoolingLayer", pooling_type=pool)
    x = _rand(7, (3, 5, 4))
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                    np.float32)
    y_j = np.asarray(jl.forward({}, J.jnp.asarray(x), mask=J.jnp.asarray(mask)))
    y_t = tl.forward({}, torch.tensor(x), mask=torch.tensor(mask))
    _close(y_t.numpy(), y_j)


def test_zero_padding_matches_jax(J):
    jl, tl = _both(J, "ZeroPaddingLayer", pad=(2, 1))
    _layer_check(J, jl, tl, _rand(8, (2, 4, 5, 3)), {})


def test_lrn_matches_jax(J):
    jl, tl = _both(J, "LocalResponseNormalization", k=1.5, n=5, alpha=0.1,
                   beta=0.75)
    _layer_check(J, jl, tl, _rand(9, (2, 4, 3, 7)), {})


@pytest.mark.parametrize("act", ["relu", "tanh", "identity"])
def test_dense_matches_jax(J, act):
    jl, tl = _both(J, "DenseLayer", n_in=6, n_out=5, activation=act)
    _layer_check(J, jl, tl, _rand(10, (4, 6)),
                 {"W": _rand(11, (6, 5), 0.5), "b": _rand(12, (5,))})


@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"),
                                      ("mse", "identity"),
                                      ("xent", "sigmoid")])
def test_output_layer_score_matches_jax(J, loss, act):
    jl, tl = _both(J, "OutputLayer", n_in=6, n_out=5, activation=act,
                   loss_function=loss)
    params = {"W": _rand(13, (6, 5), 0.5), "b": _rand(14, (5,))}
    labels = np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]
    _layer_check(J, jl, tl, _rand(15, (4, 6)), params)
    (y_j, dx_j, dp_j), (y_t, dx_t, dp_t) = _vjp_both(
        J, lambda p, xx: jl.compute_score_per_example(
            p, xx, J.jnp.asarray(labels)),
        lambda p, xx: tl.compute_score_per_example(p, xx, torch.tensor(labels)),
        _rand(15, (4, 6)), params)
    _close(y_t, y_j)
    _close(dx_t, dx_j)
    for k in params:
        _close(dp_t[k].numpy(), dp_j[k], msg=k)


def test_embedding_matches_jax(J):
    jl, tl = _both(J, "EmbeddingLayer", n_in=7, n_out=3, activation="tanh")
    params = {"W": _rand(16, (7, 3)), "b": _rand(17, (3,))}
    idx = np.array([[0], [6], [3], [3]], np.float32)
    y_j = np.asarray(jl.forward({k: J.jnp.asarray(v)
                                 for k, v in params.items()},
                                J.jnp.asarray(idx)))
    y_t = tl.forward({k: torch.tensor(v) for k, v in params.items()},
                     torch.tensor(idx))
    _close(y_t.numpy(), y_j)


def test_activation_and_dropout_layers_at_inference(J):
    jl, tl = _both(J, "ActivationLayer", activation="elu")
    _layer_check(J, jl, tl, _rand(18, (2, 3, 4, 5)), {})
    x = _rand(19, (4, 6))
    drop = TLy.DropoutLayer(dropout=0.5)
    assert torch.equal(drop.forward({}, torch.tensor(x)), torch.tensor(x))
    gen = torch.Generator().manual_seed(0)
    y = drop.forward({}, torch.tensor(x), train=True, rng=gen)
    kept = y != 0
    assert 0 < kept.sum() < y.numel()
    torch.testing.assert_close(y[kept], torch.tensor(x)[kept] / 0.5)


# -- BatchNormalization -----------------------------------------------------

def _bn_both(J, fast, fused):
    return _both(J, "BatchNormalization", n_out=6, decay=0.8,
                 use_fast_variance=fast, fused_backward=fused)


@pytest.mark.parametrize("shape", [(4, 5, 3, 6), (9, 6)],
                         ids=["image", "features"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "autodiff"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast_var", "two_pass"])
def test_batchnorm_train_matches_jax(J, fast, fused, shape):
    """y, dx, dgamma, dbeta through the training forward, and the running
    statistics it returns."""
    jl, tl = _bn_both(J, fast, fused)
    x = _rand(20, shape, 2.0) + 0.5
    params = {"gamma": _rand(21, (6,)) + 1.0, "beta": _rand(22, (6,))}
    state = {"mean": _rand(23, (6,)), "var": np.abs(_rand(24, (6,))) + 0.5}
    jstate = {k: J.jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.tensor(v) for k, v in state.items()}
    (y_j, dx_j, dp_j), (y_t, dx_t, dp_t) = _vjp_both(
        J, lambda p, xx: jl.forward_with_state(p, xx, jstate, train=True)[0],
        lambda p, xx: tl.forward_with_state(p, xx, tstate, train=True)[0],
        x, params)
    _close(y_t, y_j)
    _close(dx_t, dx_j)
    for k in params:
        _close(dp_t[k].numpy(), dp_j[k], msg=k)
    _, new_j = jl.forward_with_state({k: J.jnp.asarray(v)
                                      for k, v in params.items()},
                                     J.jnp.asarray(x), jstate, train=True)
    _, new_t = tl.forward_with_state({k: torch.tensor(v)
                                      for k, v in params.items()},
                                     _port_t(x), tstate, train=True)
    for k in ("mean", "var"):
        assert new_t[k].dtype == torch.float32
        _close(new_t[k].numpy(), np.asarray(new_j[k]), msg=k)


def test_batchnorm_fused_backward_equals_autodiff_in_the_port():
    """The closed-form backward against torch autograd through the same
    one-pass statistics, in float64."""
    x = torch.tensor(_rand(25, (4, 6, 3, 5)), dtype=torch.float64)
    g = torch.tensor(_rand(26, (6,)) + 1, dtype=torch.float64)
    b = torch.tensor(_rand(27, (6,)), dtype=torch.float64)
    ct = torch.tensor(_rand(28, (4, 6, 3, 5)), dtype=torch.float64)
    state = {"mean": torch.zeros(6), "var": torch.ones(6)}
    out = []
    for fused in (True, False):
        layer = TLy.BatchNormalization(n_out=6, fused_backward=fused)
        inputs = [t.clone().requires_grad_() for t in (x, g, b)]
        y, _ = layer.forward_with_state(
            {"gamma": inputs[1], "beta": inputs[2]}, inputs[0], state,
            train=True)
        out.append([y] + list(torch.autograd.grad(y, inputs, ct)))
    for a, b_ in zip(*out):
        torch.testing.assert_close(a, b_, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 5, 3, 6), (9, 6)],
                         ids=["image", "features"])
def test_batchnorm_inference_matches_jax(J, shape):
    jl, tl = _bn_both(J, True, True)
    x = _rand(29, shape)
    params = {"gamma": _rand(30, (6,)) + 1.0, "beta": _rand(31, (6,))}
    state = {"mean": _rand(32, (6,)), "var": np.abs(_rand(33, (6,))) + 0.5}
    jstate = {k: J.jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.tensor(v) for k, v in state.items()}
    (y_j, dx_j, dp_j), (y_t, dx_t, dp_t) = _vjp_both(
        J, lambda p, xx: jl.forward_with_state(p, xx, jstate)[0],
        lambda p, xx: tl.forward_with_state(p, xx, tstate)[0], x, params)
    _close(y_t, y_j)
    _close(dx_t, dx_j)
    for k in params:
        _close(dp_t[k].numpy(), dp_j[k], msg=k)


def test_batchnorm_bf16_statistics_accumulate_in_f32(J):
    """bf16 input: the statistics are f32 (the running state stays f32),
    y is bf16 and within one bf16 step of the reference's."""
    jl, tl = _bn_both(J, True, True)
    x = _rand(34, (8, 4, 4, 6), 3.0) + 2.0
    params = {"gamma": np.ones(6, np.float32), "beta": np.zeros(6, np.float32)}
    state = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    jnp = J.jnp
    y_j, st_j = jl.forward_with_state(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()},
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v) for k, v in state.items()}, train=True)
    y_t, st_t = tl.forward_with_state(
        {k: torch.tensor(v).bfloat16() for k, v in params.items()},
        _port_t(x).bfloat16(), {k: torch.tensor(v) for k, v in state.items()},
        train=True)
    assert y_t.dtype == torch.bfloat16 and st_t["mean"].dtype == torch.float32
    _close(_ref_np(y_t.float()), np.asarray(y_j, np.float32), atol=2 ** -7,
           rtol=2 ** -7)
    for k in ("mean", "var"):
        _close(st_t[k].numpy(), np.asarray(st_j[k]), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Updaters and learning-rate schedules
# ---------------------------------------------------------------------------

UPDATER_HP = {"momentum": 0.8, "epsilon": 1e-6, "rmsDecay": 0.9,
              "rho": 0.9, "adamMeanDecay": 0.85, "adamVarDecay": 0.99}


def test_updater_table_is_the_reference_table(J):
    assert sorted(TU.UPDATERS) == sorted(J.updaters.UPDATERS)


@pytest.mark.parametrize("name", sorted(["sgd", "nesterovs", "adagrad",
                                         "rmsprop", "adadelta", "adam",
                                         "adamax", "nadam", "none"]))
def test_updater_matches_jax(J, name):
    """Two steps of each updater (the second reads the first's state),
    with the learning rate of an exponential schedule."""
    jnp = J.jnp
    p = _rand(40, (5, 4))
    j_init, j_apply = J.updaters.get(name)
    t_init, t_apply = TU.get(name)
    js, ts = j_init(jnp.asarray(p)), t_init(torch.tensor(p))
    assert sorted(js) == sorted(ts)
    for it in range(2):
        g = _rand(41 + it, (5, 4))
        lr_j = J.updaters.schedule_lr(0.05, "exponential",
                                      jnp.asarray(it, jnp.float32),
                                      decay_rate=0.9)
        lr_t = TU.schedule_lr(0.05, "exponential", it, decay_rate=0.9)
        assert abs(lr_t - float(lr_j)) <= 1e-8
        up_j, js = j_apply(js, jnp.asarray(g), lr_j, UPDATER_HP)
        up_t, ts = t_apply(ts, torch.tensor(g), lr_t, UPDATER_HP)
        _close(up_t.numpy(), np.asarray(up_j), atol=1e-7, rtol=1e-6,
               msg=name)
        for k in js:
            assert ts[k].dtype == torch.float32
            _close(ts[k].numpy(), np.asarray(js[k]), atol=1e-7, rtol=1e-6,
                   msg=f"{name}.{k}")


SCHEDULES = [("none", {}), ("exponential", {"decay_rate": 0.97}),
             ("inverse", {"decay_rate": 0.1, "power": 0.75}),
             ("step", {"decay_rate": 0.5, "steps": 3}),
             ("torchstep", {"decay_rate": 0.5, "steps": 2}),
             ("poly", {"power": 2.0, "max_iterations": 10}),
             ("sigmoid", {"decay_rate": 0.4, "steps": 5}),
             ("schedule", {"schedule_map": {"0": 0.3, "4": 0.1, "7": 0.01}})]


@pytest.mark.parametrize("policy,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_lr_matches_jax(J, policy, kw):
    for it in range(12):
        want = J.updaters.schedule_lr(0.2, policy,
                                      J.jnp.asarray(it, J.jnp.float32), **kw)
        got = TU.schedule_lr(0.2, policy, it, **kw)
        assert abs(got - float(want)) <= 1e-6 * abs(float(want)) + 1e-9, it


@pytest.mark.parametrize("mode", ["RenormalizeL2PerLayer",
                                  "RenormalizeL2PerParamType",
                                  "ClipElementWiseAbsoluteValue",
                                  "ClipL2PerLayer", "ClipL2PerParamType",
                                  None])
def test_normalize_gradients_matches_jax(J, mode):
    grads = {"W": _rand(50, (4, 3), 2.0), "b": _rand(51, (3,), 2.0)}
    want = J.updaters.normalize_gradients(
        {k: J.jnp.asarray(v) for k, v in grads.items()}, mode, 0.7)
    got = TU.normalize_gradients({k: torch.tensor(v)
                                  for k, v in grads.items()}, mode, 0.7)
    for k in grads:
        _close(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=1e-6)


def test_apply_layer_runs_bf16_state_in_f32():
    """A bf16 updater state is widened for the arithmetic and rounded once
    when stored: the momentum is used as given, not as bf16's 0.8984375."""
    layer = TLy.DenseLayer(n_in=64, n_out=64, updater="nesterovs",
                           momentum=0.9, learning_rate=0.5,
                           lr_policy="none")
    gen = torch.Generator().manual_seed(3)
    p = torch.randn(64, 64, generator=gen)
    v = torch.randn(64, 64, generator=gen).bfloat16()
    g = torch.randn(64, 64, generator=gen)
    params = {"W": p.clone()}
    new = TU.apply_layer(layer, params, {"W": g}, {"W": {"v": v}}, 0)
    v_exact = 0.9 * v.double() - 0.5 * g.double()
    upd = 0.9 * v.double() - 1.9 * v_exact
    assert new["W"]["v"].dtype == torch.bfloat16
    torch.testing.assert_close(new["W"]["v"], v_exact.bfloat16(), rtol=0,
                               atol=0)
    torch.testing.assert_close(params["W"].double(), p.double() - upd,
                               rtol=1e-6, atol=1e-6)


def test_cast_updater_state_keeps_scalars():
    st = TU.adam_init(torch.zeros(3, 2))
    cast = TU.cast_updater_state(st, "bfloat16")
    assert cast["m"].dtype == cast["v"].dtype == torch.bfloat16
    assert cast["t"].dtype == torch.float32
    assert TU.cast_updater_state(st, None) is st


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CONV_CASES[:1] + CONV_CASES[4:7],
                         ids=lambda c: "-".join(map(str, c)))
def test_conv_and_pool_on_card_match_cpu_in_f32(cuda, case):
    """f32 on the card with TF32 off (the port's `card_numerics`) agrees
    with the CPU to 1e-5 of each tensor's largest entry: only the order of
    the sums differs (an entry near 0 can be a sum of large terms)."""
    from deeplearning4j_tpu_torch.common.device import card_numerics
    mode, k, s, p, h, w = case
    conv = TLy.ConvolutionLayer(n_in=8, n_out=16, kernel_size=k, stride=s,
                                padding=p, convolution_mode=mode,
                                activation="relu")
    pool = TLy.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                convolution_mode="same",
                                pool_backprop="argmax_gather")
    x = _port_t(_rand(60, (4, h, w, 8)))
    wt = conv.from_reference("W", torch.tensor(_rand(61, k + (8, 16), 0.2)))
    outs = []
    for dev in ("cpu", cuda):
        xx = x.to(dev).requires_grad_()
        ww = wt.to(dev).requires_grad_()
        with card_numerics(torch.device(dev), torch.float32):
            y = pool.forward({}, conv.forward({"W": ww}, xx))
            grads = torch.autograd.grad(y.square().sum(), (xx, ww))
        outs.append([t.cpu() for t in (y,) + grads])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())
