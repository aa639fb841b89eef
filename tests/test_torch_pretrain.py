"""The port's layerwise pretraining (`MultiLayerNetwork.pretrain`,
`pretrain_layer`) and the pretrain layers in the containers, against the
JAX package's.

Each case builds the same configuration in both packages (float64), the
reference draws the weights and `from_jax_params` carries them over. The
reference's `pretrain_layer` splits its key once a batch
(`self._rng, rng = split(self._rng)`) and draws every sample from `rng`;
the port draws from its generator once a batch through the layer's
`pretrain_draws`, which the test replaces with the reference's draws from
the same key sequence. After `pretrain` over three batches of 8 rows, the
parameters and `score()` (the last batch's loss) agree to 1e-9: RBM stacks
with CD-1 and CD-2 (binary, and gaussian hidden units), an AutoEncoder
stack (corruption 0.3, nesterovs), a VAE (adam, two samples) and a stack
holding all three. `fit` never pretrains, whatever `conf.pretrain` says.

A model zip of a network holding an RBM, an AutoEncoder and a VAE, written
by either package after one fit step, restores in the other: parameters
and updater state equal, outputs within 1e-6. `from_jax_params` loads the
three layers' parameters in the reference's layout (W [n_in, n_out]):
`params()` equal, `output` within 1e-12 in f64.
"""
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import layers as TLy
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as TS

N_IN, ROWS, BATCHES = 8, 8, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.nn.conf import layers
    from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
        MultiLayerConfiguration as JConf, NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.util import model_serializer as ser
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, layers=layers, DataSet=JDataSet, List=JList,
        InputType=JInputType, Conf=JConf, NNC=JNNC, Net=JNet, ser=ser)


# the stacks: (updater, learning rate, [(layer type, kwargs)])
STACKS = {
    "rbm_cd1": ("sgd", 0.1, [("rbm", dict(n_out=6)),
                             ("rbm", dict(n_out=4))]),
    "rbm_cd2_gaussian": ("sgd", 0.05, [
        ("rbm", dict(n_out=6, k=2, hidden_unit="gaussian")),
        ("rbm", dict(n_out=4, k=2))]),
    "autoencoder": ("nesterovs", 0.1, [
        ("autoencoder", dict(n_out=6, corruption_level=0.3)),
        ("autoencoder", dict(n_out=4, corruption_level=0.3,
                             loss_function="xent"))]),
    "vae": ("adam", 0.01, [
        ("vae", dict(n_out=3, encoder_layer_sizes=(6,),
                     decoder_layer_sizes=(5,), num_samples=2,
                     reconstruction_distribution={"type": "bernoulli"}))]),
    "all_three": ("adam", 0.01, [
        ("rbm", dict(n_out=7, k=2)),
        ("autoencoder", dict(n_out=6, corruption_level=0.3)),
        ("vae", dict(n_out=3, encoder_layer_sizes=(5,),
                     decoder_layer_sizes=(5,)))]),
}


def _conf(pkg, name, data_type="float64"):
    """The stack `name` and a softmax head, in package `pkg` (the port:
    None; else the J namespace)."""
    updater, lr, specs = STACKS[name]
    if pkg is None:
        registry, nnc, it, out = (TLy.LAYER_REGISTRY, NeuralNetConfiguration,
                                  InputType, TLy.OutputLayer)
    else:
        registry, nnc, it, out = (pkg.layers.LAYER_REGISTRY, pkg.NNC,
                                  pkg.InputType, pkg.layers.OutputLayer)
    b = (nnc.Builder().seed(17).updater(updater).learning_rate(lr)
         .activation("sigmoid").data_type(data_type).list())
    for i, (kind, kw) in enumerate(specs):
        b = b.layer(i, registry[kind](**kw))
    b = b.layer(len(specs), out(n_out=2, activation="softmax",
                                loss_function="mcxent"))
    return b.set_input_type(it.feed_forward(N_IN)).build()


def _data(seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(BATCHES):
        x = (r.random((ROWS, N_IN)) > 0.5).astype(np.float64)
        y = np.eye(2)[r.integers(0, 2, ROWS)]
        out.append((x, y))
    return out


def _pair(J, name):
    ref = J.Net(_conf(J, name)).init()
    net = MultiLayerNetwork(_conf(None, name), device="cpu").init()
    net.from_jax_params(J.jax.tree.map(np.asarray, ref._params))
    np.testing.assert_array_equal(net.params(), np.asarray(ref.params()))
    return ref, net


def _reference_draws(J, layer, rng, h):
    """The draws the reference's layer takes from the batch key `rng` for
    the batch `h`, as the port's `draws`."""
    jax, jnp = J.jax, J.jnp
    dt = getattr(jnp, str(h.dtype).split(".")[-1])
    B = h.shape[0]

    def draw(i, shape, gaussian):
        k = jax.random.fold_in(rng, i)
        d = (jax.random.normal(k, shape, dt) if gaussian
             else jax.random.uniform(k, shape, dt))
        return torch.tensor(np.asarray(d))

    if isinstance(layer, TLy.RBM):
        hid = layer.hidden_unit == "gaussian"
        vis = layer.visible_unit == "gaussian"
        out = [draw(0, (B, layer.n_out), hid)]
        for s in range(layer.k):
            out += [draw(2 * s + 1, (B, layer.n_in), vis),
                    draw(2 * s + 2, (B, layer.n_out), hid)]
        return out
    if isinstance(layer, TLy.VariationalAutoencoder):
        return [draw(s, (B, layer.n_out), True)
                for s in range(layer.num_samples)]
    # AutoEncoder: bernoulli(rng, 1 - level, shape) with a Python-float
    # probability draws float64 uniforms under the tests' x64
    return torch.tensor(np.asarray(jax.random.uniform(rng, tuple(h.shape),
                                                      jnp.float64)))


def _draw_as_the_reference(J, net, rng0):
    """Make each of the port's pretrain layers take the reference's draws:
    one split of the key a batch, in the order the port asks."""
    key = [rng0]

    def patched(layer):
        def pretrain_draws(h, gen):
            key[0], rng = J.jax.random.split(key[0])
            return _reference_draws(J, layer, rng, h)
        return pretrain_draws

    for layer in net.layers:
        if hasattr(layer, "pretrain_draws"):
            layer.pretrain_draws = patched(layer)
    return key


@pytest.mark.parametrize("name", sorted(STACKS))
def test_pretrain_matches_the_reference(J, name):
    ref, net = _pair(J, name)
    data = _data()
    key = _draw_as_the_reference(J, net, ref._rng)
    before = net.params().copy()
    ref.pretrain(J.List([J.DataSet(x, y) for x, y in data]), num_epochs=1)
    assert net.pretrain(ListDataSetIterator([DataSet(x, y)
                                            for x, y in data])) is net
    assert bool((key[0] == ref._rng).all())     # as many splits
    want = np.asarray(ref.params())
    got = net.params()
    assert np.max(np.abs(got - want)) <= 1e-9 * max(1.0, np.abs(want).max())
    assert not np.array_equal(got, before)
    assert net.score() == pytest.approx(float(ref._score), rel=1e-9,
                                        abs=1e-12)


def test_pretrain_layer_epochs_and_a_dataset(J):
    """pretrain_layer over two epochs of one DataSet (a one-batch
    iterator), on the second layer of a stack: the first layer's and the
    head's parameters stay, as in the reference."""
    ref, net = _pair(J, "rbm_cd2_gaussian")
    x, y = _data(1)[0]
    _draw_as_the_reference(J, net, ref._rng)
    ref.pretrain_layer(1, J.DataSet(x, y), num_epochs=2)
    before = net.params().copy()
    net.pretrainLayer(1, DataSet(x, y), num_epochs=2)
    want, got = np.asarray(ref.params()), net.params()
    assert np.max(np.abs(got - want)) <= 1e-9
    n0 = 8 * 6 + 6 + 8                         # layer 0: W, b, vb
    np.testing.assert_array_equal(got[:n0], before[:n0])
    np.testing.assert_array_equal(got[-(4 * 2 + 2):], before[-(4 * 2 + 2):])
    with pytest.raises(ValueError, match="not pretrainable"):
        net.pretrain_layer(2, DataSet(x, y))


def test_pretrain_draws_from_the_network_s_generator():
    """Unpatched, the port draws from its own generator: two networks of
    one seed pretrain alike, and the draws differ batch to batch."""
    nets = [MultiLayerNetwork(_conf(None, "all_three"), device="cpu").init()
            for _ in range(2)]
    data = ListDataSetIterator([DataSet(x, y) for x, y in _data(2)])
    for net in nets:
        net.pretrain(data)
    np.testing.assert_array_equal(nets[0].params(), nets[1].params())
    assert np.isfinite(nets[0].score())


def test_fit_never_pretrains(J):
    """`conf.pretrain = True` changes nothing in fit, in either package."""
    conf = _conf(None, "all_three")
    conf.pretrain = True
    assert MultiLayerConfiguration.from_json(conf.to_json()).pretrain
    ref, net = _pair(J, "all_three")
    ref.conf.pretrain = True
    calls = []
    net.pretrain = lambda *a, **k: calls.append(a)
    net.pretrain_layer = lambda *a, **k: calls.append(a)
    x, y = _data(3)[0]
    ref.fit(J.DataSet(x, y))
    net.fit(DataSet(x, y))
    assert calls == []
    np.testing.assert_allclose(net.params(), np.asarray(ref.params()),
                               rtol=1e-9, atol=1e-12)


def test_json_with_all_three_layers_round_trips(J):
    ref_text = _conf(J, "all_three").to_json()
    conf = MultiLayerConfiguration.from_json(ref_text)
    assert [type(l).__name__ for l in conf.layers] == [
        "RBM", "AutoEncoder", "VariationalAutoencoder", "OutputLayer"]
    assert conf.to_json() == ref_text == _conf(None, "all_three").to_json()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_model_zip_restores_in_the_other_package(J, writer, tmp_path):
    ref, net = _pair(J, "all_three")
    x, y = _data(4)[0]
    path = str(tmp_path / "pretrain.zip")
    if writer == "reference":
        ref.fit(J.DataSet(x, y))
        J.ser.write_model(ref, path)
        back = TS.restore_multi_layer_network(path, device="cpu")
        src_params, src_out = np.asarray(ref.params()), np.asarray(
            ref.output(x))
        np.testing.assert_array_equal(back.params(), src_params)
        want_u = J.jax.tree.map(np.asarray, ref._updater_state)
        got_u = back.reference_updater_state()
        for i, layer in enumerate(want_u):
            for k, st in layer.items():
                for s, a in st.items():
                    np.testing.assert_array_equal(got_u[i][k][s], a)
        np.testing.assert_allclose(back.output(x), src_out, atol=1e-6)
    else:
        net.fit(DataSet(x, y))
        TS.write_model(net, path)
        back = J.ser.restore_multi_layer_network(path)
        np.testing.assert_array_equal(np.asarray(back.params()),
                                      net.params())
        got_u = J.jax.tree.map(np.asarray, back._updater_state)
        for i, layer in enumerate(net.reference_updater_state()):
            for k, st in layer.items():
                for s, a in st.items():
                    np.testing.assert_array_equal(got_u[i][k][s], a)
        np.testing.assert_allclose(np.asarray(back.output(x)),
                                   net.output(x), atol=1e-6)


def test_from_jax_params_loads_the_three_layers(J):
    ref, net = _pair(J, "all_three")
    for i, layer in enumerate(net.layers[:3]):
        for k, p in net._params[i].items():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(ref._params[i][k]))
    assert net.layers[0].to_reference("W", net._params[0]["W"]) is \
        net._params[0]["W"]
    x = _data(5)[0][0]
    np.testing.assert_allclose(net.output(x), np.asarray(ref.output(x)),
                               rtol=1e-12, atol=1e-12)
    tree = net.reference_params()
    assert sorted(tree[2]) == sorted(ref._params[2])
