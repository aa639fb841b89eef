"""The port's pretrain layers (`nn/conf/layers/rbm.py`, `variational.py`,
`AutoEncoder` in `feedforward.py`) against the JAX package's.

The reference's weights go to both (torch cannot redraw them), and so do
its random draws: the port's layers take their samples' draws as tensors
(`draws=`), and each test hands them the uniforms and normals that the
reference takes from its key (`fold_in(rng, 0)`, `fold_in(rng, 2s + 1)`,
`fold_in(rng, 2s + 2)` for CD-k; `fold_in(rng, s)` for the VAE's eps; the
key itself for AutoEncoder's corruption, whose Python-float probability
draws float64 uniforms under the tests' x64). Held:
  - propup, propdown and the reconstruction loss, the AutoEncoder's
    encode, decode and corrupted loss, the VAE's latent means: f32 1e-5,
    f64 1e-12;
  - CD-k statistics (binary and gaussian units, k = 1 and 2) in f64 to
    1e-9: a binary sample u < p flips when p moves by one ulp between the
    backends, and a flip moves dW by 1/B, which f64 makes a ~1e-16 event;
  - each reconstruction distribution's neg_log_prob and sample_mean, and
    `reconstruction_probability`, f32 1e-5 and f64 1e-12;
  - the negative ELBO and its gradients by autograd against jax.grad, for
    each distribution, f32 1e-5 and f64 1e-9; AutoEncoder's the same;
  - the property pins of tests/test_vae_rbm.py and
    tests/test_losses_variational_tail.py, run on the port (the gradient
    checks by central differences in f64, as there).
"""
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (RBM, AutoEncoder,
                                                     OutputLayer,
                                                     VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.conf.layers.variational import (
    BernoulliReconstructionDistribution, CompositeReconstructionDistribution,
    ExponentialReconstructionDistribution, GaussianReconstructionDistribution,
    LossFunctionWrapper, _dist_from_dict)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = {"float32": 1e-5, "float64": 1e-12}
B = 6

DISTS = {
    "gaussian": {"type": "gaussian", "activation": "tanh"},
    "bernoulli": {"type": "bernoulli"},
    "exponential": {"type": "exponential", "activation": "identity"},
    "composite": {"type": "composite", "components": [
        [5, {"type": "gaussian", "activation": "identity"}],
        [3, {"type": "bernoulli"}]]},
    "loss_wrapper": {"type": "loss_wrapper", "loss": "mse",
                     "activation": "sigmoid"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many tiny ops: one intra-op thread, so that a worker among several
    does not wait on a pool of all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.nn.conf import layers
    from deeplearning4j_tpu.nn.conf.layers import variational
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, layers=layers,
                                 variational=variational)


def _x(shape, seed, kind="unit", dtype="float64"):
    r = np.random.default_rng(seed)
    if kind == "binary":
        x = (r.random(shape) > 0.5).astype(np.float64)
    elif kind == "exponential":
        x = r.exponential(1.0, shape)
    else:
        x = r.random(shape)
    if kind == "mixed":       # the composite's 5 gaussian, 3 binary features
        x[:, 5:] = (x[:, 5:] > 0.5).astype(np.float64)
    return x.astype(dtype)


def _pair(J, kind, dtype="float64", seed=0, **kw):
    """(reference layer, port layer, params as numpy, as port tensors) of
    one configuration. The weights are drawn here with numpy, in the
    parameters' names and shapes (the reference's; pinned by
    test_parameter_names_and_shapes_are_the_reference_s), biases non-zero
    so that each one reaches the math."""
    jl = J.layers.LAYER_REGISTRY[kind](**kw).apply_global_defaults({})
    tl = _PORT[kind](**kw).apply_global_defaults({})
    r = np.random.default_rng(seed + 100)
    pn = {k: ((0.1 if k.endswith("b") else 0.5)
              * r.standard_normal(tuple(v.shape))).astype(dtype)
          for k, v in tl.init_params(torch.Generator().manual_seed(0)).items()}
    return jl, tl, pn, {k: torch.tensor(v) for k, v in pn.items()}


_PORT = {"rbm": RBM, "autoencoder": AutoEncoder,
         "vae": VariationalAutoencoder}


def _jp(J, pn):
    return {k: J.jnp.asarray(v) for k, v in pn.items()}


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), (what, err)


def _ref_draw(J, key, i, shape, dtype, gaussian):
    k = J.jax.random.fold_in(key, i)
    dt = getattr(J.jnp, dtype)
    return (J.jax.random.normal(k, shape, dt) if gaussian
            else J.jax.random.uniform(k, shape, dt))


def _torch(draws):
    return [torch.tensor(np.asarray(d)) for d in draws]


# The reference's draws, as JAX arrays: made inside the jit of the
# reference's own call (one compile a test), then handed to the port.

def rbm_draws(J, layer, key, B, dtype):
    """The reference's CD-k draws of one batch, in the port's order."""
    hid, vis = layer.hidden_unit == "gaussian", layer.visible_unit == "gaussian"
    draws = [_ref_draw(J, key, 0, (B, layer.n_out), dtype, hid)]
    for s in range(layer.k):
        draws.append(_ref_draw(J, key, 2 * s + 1, (B, layer.n_in), dtype,
                               vis))
        draws.append(_ref_draw(J, key, 2 * s + 2, (B, layer.n_out), dtype,
                               hid))
    return draws


def vae_draws(J, layer, key, B, dtype, n=None):
    return [_ref_draw(J, key, s, (B, layer.n_out), dtype, True)
            for s in range(layer.num_samples if n is None else n)]


def ae_draws(J, key, shape):
    """jax.random.bernoulli(key, p, shape) with a Python-float p draws
    uniform(key, shape, float64) under x64 and keeps u < p."""
    return J.jax.random.uniform(key, shape, J.jnp.float64)


# ---------------------------------------------------------------------------
# RBM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("units", [("binary", "binary"),
                                   ("gaussian", "gaussian")])
def test_rbm_propup_propdown_and_loss(J, dtype, units):
    hid, vis = units
    jl, tl, pn, tp = _pair(J, "rbm", dtype, n_in=8, n_out=5, hidden_unit=hid,
                           visible_unit=vis)
    x = _x((B, 8), 1, dtype=dtype)
    jp, jx, tx = _jp(J, pn), J.jnp.asarray(x), torch.tensor(x)
    tol = TOL[dtype]
    h = _x((B, 5), 2, dtype=dtype)
    want = J.jax.jit(lambda p, v, hh: (
        jl.forward(p, v), jl._prop_down(p, hh), jl.pretrain_loss(p, v)))(
            jp, jx, J.jnp.asarray(h))
    _close(tl.forward(tp, tx), want[0], tol, "propup")
    _close(tl._prop_down(tp, torch.tensor(h)), want[1], tol, "propdown")
    _close(tl.pretrain_loss(tp, tx), want[2], tol, "loss")


@pytest.mark.parametrize("units,k", [(("binary", "binary"), 1),
                                     (("gaussian", "binary"), 2),
                                     (("binary", "gaussian"), 1),
                                     (("binary", "binary"), 2),
                                     (("gaussian", "gaussian"), 2)])
def test_rbm_cd_statistics_with_the_reference_s_draws(J, k, units):
    hid, vis = units
    jl, tl, pn, tp = _pair(J, "rbm", "float64", seed=k, n_in=8, n_out=5,
                           hidden_unit=hid, visible_unit=vis, k=k)
    x = _x((B, 8), 3, "binary" if vis == "binary" else "unit")
    key = J.jax.random.PRNGKey(10 + k)
    want, draws = J.jax.jit(lambda p, v: (
        jl.pretrain_grads(p, v, rng=key),
        rbm_draws(J, tl, key, B, "float64")))(_jp(J, pn), J.jnp.asarray(x))
    got = tl.pretrain_grads(tp, torch.tensor(x), draws=_torch(draws))
    assert sorted(got) == sorted(want) == ["W", "b", "vb"]
    for name in want:
        _close(got[name], want[name], 1e-9, name)


def test_rbm_draws_from_a_generator():
    """The port's own draws: 2k + 1 tensors of the sample shapes, the same
    for the same seed, uniforms for binary units and normals for gaussian
    ones."""
    tl = RBM(n_in=8, n_out=5, hidden_unit="gaussian", k=2)
    x = torch.zeros(B, 8, dtype=torch.float64)
    d = tl.pretrain_draws(x, torch.Generator().manual_seed(1))
    assert [tuple(t.shape) for t in d] == [(B, 5), (B, 8), (B, 5), (B, 8),
                                          (B, 5)]
    assert all(t.dtype == torch.float64 for t in d)
    assert (d[1] >= 0).all() and (d[1] < 1).all() and (d[0] < 0).any()
    again = tl.pretrain_draws(x, torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    # no generator: seeded 0, as the reference's PRNGKey(0)
    assert torch.equal(tl.pretrain_draws(x, None)[0],
                       tl.pretrain_draws(x, None)[0])


# ---------------------------------------------------------------------------
# AutoEncoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("loss", ["mse", "xent"])
def test_autoencoder_forward_loss_and_gradients(J, dtype, loss):
    jl, tl, pn, tp = _pair(J, "autoencoder", dtype, n_in=8, n_out=5,
                           corruption_level=0.3, loss_function=loss)
    x = _x((B, 8), 4, dtype=dtype)
    jp, jx = _jp(J, pn), J.jnp.asarray(x)
    tx = torch.tensor(x)
    tol = TOL[dtype]
    enc, dec, clean = J.jax.jit(lambda p, v: (
        jl.forward(p, v), jl.decode(p, jl.encode(p, v)),
        jl.pretrain_loss(p, v)))(jp, jx)
    _close(tl.forward(tp, tx), enc, tol, "encode")
    _close(tl.decode(tp, tl.encode(tp, tx)), dec, tol, "decode")
    key = J.jax.random.PRNGKey(5)
    (want, jg), draws = J.jax.jit(lambda p: (J.jax.value_and_grad(
        lambda q: jl.pretrain_loss(q, jx, rng=key))(p),
        ae_draws(J, key, (B, 8))))(jp)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    got = tl.pretrain_loss(leaves, tx, draws=_torch([draws])[0])
    grads = torch.autograd.grad(got, list(leaves.values()))
    _close(got, want, tol, "loss")
    gtol = 1e-9 if dtype == "float64" else 1e-5
    for (name, _), g in zip(leaves.items(), grads):
        _close(g, jg[name], gtol, name)
    # no key, no corruption (the reference corrupts only given a key)
    _close(tl.pretrain_loss(tp, tx), clean, tol, "clean")


# ---------------------------------------------------------------------------
# Reconstruction distributions and the VAE
# ---------------------------------------------------------------------------

def _ref_dist(J, name):
    return J.variational._dist_from_dict(DISTS[name])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution_neg_log_prob_and_mean(J, name, dtype):
    jd, td = _ref_dist(J, name), _dist_from_dict(DISTS[name])
    assert td.to_dict() == jd.to_dict() == DISTS[name]
    assert type(_dist_from_dict(td.to_dict())) is type(td)
    n = 8
    npar = td.total_params(n)
    assert npar == jd.total_params(n)
    kind = {"bernoulli": "binary", "exponential": "exponential",
            "composite": "mixed"}.get(name, "unit")
    x = _x((B, n), 6, kind, dtype)
    params = (np.random.default_rng(7).standard_normal((B, npar))
              .astype(dtype))
    tol = TOL[dtype]
    nlp, mean = J.jax.jit(lambda v, q: (jd.neg_log_prob(v, q),
                                        jd.sample_mean(q, n)))(
        J.jnp.asarray(x), J.jnp.asarray(params))
    _close(td.neg_log_prob(torch.tensor(x), torch.tensor(params)), nlp, tol,
           "neg_log_prob")
    _close(td.sample_mean(torch.tensor(params), n), mean, tol, "sample_mean")


def _vae_pair(J, name, dtype, num_samples=2, seed=0):
    return _pair(J, "vae", dtype, seed=seed, n_in=8, n_out=3,
                 encoder_layer_sizes=(7, 6), decoder_layer_sizes=(6,),
                 activation="tanh", num_samples=num_samples,
                 reconstruction_distribution=DISTS[name])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(DISTS))
def test_vae_elbo_and_its_gradients_against_jax_grad(J, name, dtype):
    jl, tl, pn, tp = _vae_pair(J, name, dtype)
    assert sorted(tp) == sorted(pn)
    kind = {"bernoulli": "binary", "exponential": "exponential",
            "composite": "mixed"}.get(name, "unit")
    x = _x((B, 8), 8, kind, dtype)
    jp, jx, tx = _jp(J, pn), J.jnp.asarray(x), torch.tensor(x)
    key = J.jax.random.PRNGKey(9)
    (want, jg), latent, draws = J.jax.jit(lambda p: (J.jax.value_and_grad(
        lambda q: jl.pretrain_loss(q, jx, rng=key))(p), jl.forward(p, jx),
        vae_draws(J, tl, key, B, dtype)))(jp)
    _close(tl.forward(tp, tx), latent, TOL[dtype], "latent mean")
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    got = tl.pretrain_loss(leaves, tx, draws=_torch(draws))
    grads = torch.autograd.grad(got, list(leaves.values()))
    tol = 1e-9 if dtype == "float64" else 1e-5
    _close(got, want, tol, "elbo")
    for (k, _), g in zip(leaves.items(), grads):
        _close(g, jg[k], tol, k)


@pytest.mark.parametrize("name,dtype", [
    ("gaussian", "float32"), ("bernoulli", "float64"),
    ("exponential", "float32"), ("composite", "float64")])
def test_reconstruction_probability_and_generate(J, name, dtype):
    jl, tl, pn, tp = _vae_pair(J, name, dtype, seed=3)
    kind = {"bernoulli": "binary", "exponential": "exponential",
            "composite": "mixed"}.get(name, "unit")
    x = _x((B, 8), 10, kind, dtype)
    jp, jx, tx = _jp(J, pn), J.jnp.asarray(x), torch.tensor(x)
    key = J.jax.random.PRNGKey(11)
    z = _x((4, 3), 12, dtype=dtype) * 2 - 1
    want, gen, draws = J.jax.jit(lambda p, v, zz: (
        jl.reconstruction_probability(p, v, num_samples=4, rng=key),
        jl.generate_at_mean_given_z(p, zz),
        vae_draws(J, tl, key, B, dtype, n=4)))(jp, jx, J.jnp.asarray(z))
    got = tl.reconstructionLogProbability(tp, tx, num_samples=4,
                                          draws=_torch(draws))
    _close(got, want, 1e-5 if dtype == "float32" else 1e-12, "log p(x)")
    _close(tl.generateAtMeanGivenZ(tp, torch.tensor(z)), gen, TOL[dtype],
           "generate")


def test_reconstruction_probability_refuses_a_loss_wrapper(J):
    jl, tl, pn, tp = _vae_pair(J, "loss_wrapper", "float64")
    x = torch.tensor(_x((B, 8), 13))
    with pytest.raises(ValueError, match="LossFunctionWrapper"):
        tl.reconstruction_probability(tp, x, num_samples=2)
    with pytest.raises(ValueError, match="LossFunctionWrapper"):
        jl.reconstruction_probability(_jp(J, pn), J.jnp.asarray(x.numpy()),
                                      num_samples=2)


@pytest.mark.parametrize("kind,kw", [
    ("rbm", dict(n_in=8, n_out=5)),
    ("autoencoder", dict(n_in=8, n_out=5)),
    ("vae", dict(n_in=8, n_out=3, encoder_layer_sizes=(7, 6),
                 decoder_layer_sizes=(6,),
                 reconstruction_distribution=DISTS["composite"]))])
def test_parameter_names_and_shapes_are_the_reference_s(J, kind, kw):
    """The port's init: the reference's names and shapes (by
    jax.eval_shape, nothing drawn there), zero biases."""
    jl = J.layers.LAYER_REGISTRY[kind](**kw).apply_global_defaults({})
    want = J.jax.eval_shape(lambda k: jl.init_params(k, J.jnp.float32),
                            J.jax.random.PRNGKey(0))
    mine = _PORT[kind](**kw).apply_global_defaults({}).init_params(
        torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in mine.values())
    assert all(not mine[k].any() for k in mine if k.endswith("b"))


# ---------------------------------------------------------------------------
# The reference's property pins (tests/test_vae_rbm.py,
# tests/test_losses_variational_tail.py), on the port
# ---------------------------------------------------------------------------

def _numeric_grad_check(f, params, n_probe=25, eps=1e-6, tol=1e-4, seed=0):
    """Central differences against autograd at `params` (f64 tensors)."""
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(f(leaves),
                                                 list(leaves.values()))))
    flat = [(k, i) for k, v in params.items() for i in range(v.numel())]
    rs = np.random.default_rng(seed)
    for j in rs.choice(len(flat), min(n_probe, len(flat)), replace=False):
        k, i = flat[j]
        plus = {n: v.clone() for n, v in params.items()}
        plus[k].view(-1)[i] += eps
        minus = {n: v.clone() for n, v in params.items()}
        minus[k].view(-1)[i] -= eps
        num = (float(f(plus)) - float(f(minus))) / (2 * eps)
        g = float(grads[k].view(-1)[i])
        denom = abs(g) + abs(num)
        assert denom == 0 or abs(g - num) / denom < tol, (k, i, g, num)


def _vae(dist=None, hidden=12, **kw):
    return VariationalAutoencoder(
        n_in=8, n_out=3, encoder_layer_sizes=(hidden,),
        decoder_layer_sizes=(hidden,), activation="tanh",
        reconstruction_distribution=dist, **kw
    ).apply_global_defaults({"weight_init": "xavier"})


def _f64_params(layer, seed=0):
    return layer.init_params(torch.Generator().manual_seed(seed),
                             torch.float64)


@pytest.mark.parametrize("dist,kind", [
    (None, "unit"), ({"type": "exponential"}, "exponential"),
    (DISTS["composite"], "mixed"), (DISTS["loss_wrapper"], "unit")])
def test_elbo_gradient_check(dist, kind):
    """test_vae_rbm.py::test_elbo_gradcheck_gaussian and the tail's
    exponential / composite / loss-wrapper checks."""
    vae = _vae(dist, hidden=12 if dist is None else 10)
    x = torch.tensor(_x((12, 8), 2, kind))
    eps = vae.pretrain_draws(x, torch.Generator().manual_seed(3))
    _numeric_grad_check(lambda p: vae.pretrain_loss(p, x, draws=eps),
                        _f64_params(vae), n_probe=40 if dist is None else 12)


def test_pretrain_reduces_elbo_and_recon_prob_orders():
    conf = (NeuralNetConfiguration.Builder().seed(5)
            .updater("adam").learning_rate(5e-3).list()
            .layer(0, VariationalAutoencoder(
                n_out=4, encoder_layer_sizes=(16,),
                decoder_layer_sizes=(16,), activation="tanh"))
            .set_input_type(InputType.feed_forward(8))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    ds = DataSet(_x((64, 8), 2, dtype="float32"),
                 np.zeros((64, 1), np.float32))
    vae = net.layers[0]
    x = torch.tensor(ds.features)
    with torch.no_grad():
        l0 = float(vae.pretrain_loss(net._params[0], x))
    net.pretrain_layer(0, ListDataSetIterator([ds]), num_epochs=60)
    with torch.no_grad():
        p1 = net._params[0]
        l1 = float(vae.pretrain_loss(p1, x))
        assert l1 < l0
        logp_data = vae.reconstruction_probability(p1, x, num_samples=8)
        noise = np.random.default_rng(9).random((64, 8)) * 10 - 5
        logp_noise = vae.reconstruction_probability(
            p1, torch.tensor(noise.astype(np.float32)), num_samples=8)
    assert float(logp_data.mean()) > float(logp_noise.mean())


def test_forward_is_latent_mean_and_supervised_stack():
    conf = (NeuralNetConfiguration.Builder().seed(1)
            .updater("adam").learning_rate(1e-2).list()
            .layer(0, VariationalAutoencoder(
                n_out=4, encoder_layer_sizes=(8,),
                decoder_layer_sizes=(8,), activation="tanh"))
            .layer(1, OutputLayer(n_out=2, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(8))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = _x((8, 8), 0, dtype="float32")
    assert net.output(x).shape == (8, 2)
    with torch.no_grad():
        mean = net.layers[0].forward(net._params[0], torch.tensor(x))
    np.testing.assert_array_equal(net.feed_forward(x)[1], mean.numpy())
    y = np.eye(2, dtype=np.float32)[
        np.random.default_rng(0).integers(0, 2, 8)]
    net.fit(DataSet(x, y))
    assert np.isfinite(net.score())


def test_bernoulli_distribution_and_generate():
    vae = _vae({"type": "bernoulli"})
    assert isinstance(vae._dist(), BernoulliReconstructionDistribution)
    params = vae.init_params(torch.Generator().manual_seed(0))
    x = torch.tensor(_x((16, 8), 0, "binary", "float32"))
    loss = float(vae.pretrain_loss(params, x,
                                   rng=torch.Generator().manual_seed(1)))
    assert np.isfinite(loss)
    recon = vae.generate_at_mean_given_z(params, torch.zeros(4, 3)).detach()
    assert recon.shape == (4, 8)
    assert (recon >= 0).all() and (recon <= 1).all()


def test_cd_pretraining_reduces_reconstruction_error():
    conf = (NeuralNetConfiguration.Builder().seed(3)
            .updater("sgd").learning_rate(0.1).list()
            .layer(0, RBM(n_out=12))
            .set_input_type(InputType.feed_forward(8))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = _x((32, 8), 4, "binary", "float32")
    ds = DataSet(x, np.zeros((32, 1), np.float32))
    rbm = net.layers[0]
    with torch.no_grad():
        e0 = float(rbm.pretrain_loss(net._params[0], torch.tensor(x)))
    net.pretrain_layer(0, ListDataSetIterator([ds]), num_epochs=80)
    with torch.no_grad():
        e1 = float(rbm.pretrain_loss(net._params[0], torch.tensor(x)))
    assert e1 < e0


def test_propup_forward_shape():
    rbm = RBM(n_in=8, n_out=5).apply_global_defaults({})
    params = rbm.init_params(torch.Generator().manual_seed(0))
    out = rbm.forward(params, torch.tensor(_x((4, 8), 0, dtype="float32")))
    assert out.shape == (4, 5)
    assert (out >= 0).all() and (out <= 1).all()      # binary units


def test_stacked_pretrain_then_finetune():
    """DBN-style: RBM + RBM + softmax, greedy pretrain then backprop."""
    conf = (NeuralNetConfiguration.Builder().seed(7)
            .updater("sgd").learning_rate(0.05).list()
            .layer(0, RBM(n_out=16))
            .layer(1, RBM(n_out=8))
            .layer(2, OutputLayer(n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(8))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = _x((48, 8), 5, "binary", "float32")
    y = np.eye(3, dtype=np.float32)[
        np.random.default_rng(0).integers(0, 3, 48)]
    ds = DataSet(x, y)
    net.pretrain(ListDataSetIterator([ds]), num_epochs=10)
    s0 = net.score(ds)
    for _ in range(20):
        net.fit(ds)
    assert net.score(ds) < s0


def test_exponential_mean_is_inverse_rate():
    d = ExponentialReconstructionDistribution()
    gamma = torch.tensor([[0.0, 1.0, -1.0]], dtype=torch.float64)
    np.testing.assert_allclose(d.sample_mean(gamma, 3).numpy(),
                               np.exp([[0.0, -1.0, 1.0]]), rtol=1e-6)
    x = torch.tensor([[0.5, 2.0, 1.0]], dtype=torch.float64)
    nlp = float(d.neg_log_prob(x, torch.zeros(1, 3, dtype=torch.float64))[0])
    assert nlp == pytest.approx(3.5)       # -log p for λ = 1 is x


def test_composite_slices_and_sums():
    g = GaussianReconstructionDistribution()
    b = BernoulliReconstructionDistribution()
    comp = CompositeReconstructionDistribution([(5, g), (3, b)])
    assert comp.total_params(8) == 5 * 2 + 3
    r = np.random.default_rng(3)
    x = torch.tensor(r.random((6, 8)))
    params = torch.tensor(r.standard_normal((6, 13)))
    want = (g.neg_log_prob(x[:, :5], params[:, :10])
            + b.neg_log_prob(x[:, 5:], params[:, 10:]))
    np.testing.assert_allclose(comp.neg_log_prob(x, params).numpy(),
                               want.numpy(), rtol=1e-9)
    assert comp.sample_mean(params, 8).shape == (6, 8)
    with pytest.raises(ValueError):
        comp.total_params(9)            # the components cover 8 features
    d2 = _dist_from_dict(comp.to_dict())
    assert isinstance(d2, CompositeReconstructionDistribution)
    assert d2.total_params(8) == 13


def test_loss_wrapper_normalises_to_its_dict_and_refuses_log_p():
    vae = _vae(LossFunctionWrapper("mse", "sigmoid"))
    assert vae.reconstruction_distribution["type"] == "loss_wrapper"
    assert isinstance(vae._dist(), LossFunctionWrapper)
    with pytest.raises(ValueError):
        vae.reconstruction_probability(_f64_params(vae),
                                       torch.tensor(_x((4, 8), 5)),
                                       num_samples=2)
