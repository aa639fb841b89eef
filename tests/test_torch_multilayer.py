"""The port's MultiLayerNetwork (`deeplearning4j_tpu_torch.nn.multilayer`),
its configuration JSON and its model zips, against the JAX package's.

LeNet (28x28x1, batch 4, 10 classes): the JAX package draws the weights and
`MultiLayerNetwork.from_jax_params` carries them over (HWIO kernels become
OIHW); the same numpy batch goes to both. Held, in f32 on the CPU:
  - `output` to 1e-5 (read: 1.5e-8), `score` and the first loss to 1e-5,
    the flat gradient (`flatten_gradients`, the reference's layout) to 1e-5
    (read: 6.3e-8);
  - three `fit` steps with Nesterov (momentum 0.9): each step's loss and
    the parameters after it to 1e-5 (read: 0 and 1.5e-8).
Adam's three steps (lr 1e-3) run in float64. In f32 they cannot agree to 1e-5: for
a weight whose gradient is ~1e-9 (LeNet's dense layer has many), Adam's
step lr·m/(sqrt(v) + eps) turns the last bits of the gradient, where the
two backends' sums differ, into a change of lr-size (read: 6.6e-5 after
one step). In float64 the same steps agree to 1e-9.

Configurations: the JSON of `lenet_conf` loads in the other package and
writes back the same document, both ways; a golden zip's JSON comes back
from the port as from the reference (which adds the fields that are newer
than the zip, e.g. `has_bias`).

Golden zips (`tests/fixtures/golden/{mlp,lenet}.zip`, written by the JAX
package): the port restores params bit-equal to `io["params"]`, outputs
within 1e-6 of `io["y"]`, the updater state of the reference, and keeps
training from it as the JAX package does (one step, 1e-5). A zip that the
port writes restores in the JAX package with identical params, the same
updater state, and outputs within 1e-6 of the port's.

Tests marked `gpu` run on the card and skip without one:
    python -m pytest --noconftest tests/test_torch_multilayer.py -m gpu
"""
import json
import os
import types
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.zoo.lenet import lenet, lenet_conf
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import layers as TLy
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as TS

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden")
TOL = 1e-5
STEPS = 3


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784), dtype=np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import importlib

    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
        MultiLayerConfiguration as JConf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.util import model_serializer as jser
    # the module: the zoo package exports a function of the same name
    jlenet = importlib.import_module("deeplearning4j_tpu.models.zoo.lenet")
    return types.SimpleNamespace(jax=jax, lenet_conf=jlenet.lenet_conf,
                                 Conf=JConf, Net=JNet, DataSet=JDataSet,
                                 ser=jser)


def _numpy_tree(J, tree):
    return J.jax.tree.map(np.array, tree)


def jax_score_and_grad(J, net, feats, labels):
    """The reference's `score(DataSet)` (train=False) and
    `compute_gradient_and_score` (train=True, PRNGKey(0)), through its own
    `_loss_fn` under jit: the same function, compiled once instead of
    dispatched op by op."""
    jax, jnp = J.jax, J.jax.numpy
    key = jax.random.PRNGKey(0)

    def loss(p, train):
        return net._loss_fn(p, net._model_state, feats, labels, None, None,
                            key, train)[0]

    score = jax.jit(lambda p: loss(p, False))(net._params)
    grad_score, grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, True)))(net._params)
    return float(score), float(grad_score), grads


def retyped(J, net, conf):
    """A reference network of `conf` holding `net`'s weights (cast to
    conf's parameter type), without drawing new ones."""
    jnp = J.jax.numpy
    other = type(net)(conf)
    # copies: fit donates its arguments' buffers
    other._params = J.jax.tree.map(
        lambda a: jnp.array(a, other.param_dtype, copy=True), net._params)
    other._model_state = J.jax.tree.map(jnp.copy, net._model_state)
    other._init_updater_state()
    return other


@pytest.fixture(scope="module")
def lenet_runs(J):
    """Per updater (Nesterov in f32; Adam, lr 1e-3, in f64): the
    reference's initial weights and updater state, its output, score, flat
    gradient, and the losses and parameters of three fit steps."""
    x, y = _batch()
    jnp = J.jax.numpy
    base = J.Net(J.lenet_conf()).init()
    runs = {}
    for updater, kw in (("nesterovs", {}),
                        ("adam", {"learning_rate": 1e-3,
                                  "data_type": "float64"})):
        conf = J.lenet_conf(updater=updater, **kw)
        net = retyped(J, base, conf)
        run = {"conf": conf.to_json(),
               "params": _numpy_tree(J, net._params),
               "ustate": _numpy_tree(J, net._updater_state),
               "output": np.asarray(net.output(x))}
        run["score"], run["grad_score"], grads = jax_score_and_grad(
            J, net, jnp.asarray(x), jnp.asarray(y))
        run["grad"] = net.flatten_gradients(grads)
        run["losses"], run["steps"] = [], []
        for _ in range(STEPS):
            net.fit(x, y)
            run["losses"].append(float(net.score()))
            run["steps"].append(net.params())
        runs[updater] = run
    return runs


def _port_lenet(run, device="cpu"):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(run["conf"]),
                            device=device).init()
    return net.from_jax_params(run["params"], updater_state=run["ustate"])


@pytest.mark.parametrize("updater", ["nesterovs", "adam"])
def test_lenet_forward_score_and_gradient_match_jax(lenet_runs, updater):
    run = lenet_runs[updater]
    net = _port_lenet(run)
    x, y = _batch()
    np.testing.assert_allclose(net.output(x), run["output"], rtol=0,
                               atol=TOL)
    assert abs(net.score((x, y)) - run["score"]) <= TOL
    assert abs(net.score(DataSet(x, y)) - run["score"]) <= TOL
    grads, score = net.compute_gradient_and_score(x, y)
    assert abs(score - run["grad_score"]) <= TOL
    np.testing.assert_allclose(net.flatten_gradients(grads), run["grad"],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("updater", ["nesterovs", "adam"])
def test_lenet_three_fit_steps_match_jax(lenet_runs, updater):
    run = lenet_runs[updater]
    net = _port_lenet(run)
    x, y = _batch()
    tol = TOL if updater == "nesterovs" else 1e-9
    for step in range(STEPS):
        net.fit(DataSet(x, y))
        assert abs(net.score() - run["losses"][step]) <= tol, step
        np.testing.assert_allclose(net.params(), run["steps"][step], rtol=0,
                                   atol=tol, err_msg=f"step {step}")
    assert net.conf.iteration_count == STEPS
    assert run["losses"][-1] < run["losses"][0]


def test_lenet_params_round_trip_and_layout(lenet_runs, J):
    run = lenet_runs["nesterovs"]
    net = _port_lenet(run)
    ref = J.Net(J.Conf.from_json(run["conf"])).init()
    ref._params = J.jax.tree.map(J.jax.numpy.asarray, run["params"])
    np.testing.assert_array_equal(net.params(), ref.params())
    assert net.num_params() == ref.num_params() == 431080
    # the port holds conv kernels OIHW, the reference HWIO
    assert tuple(net.slots[0].params["W"].shape) == (20, 1, 5, 5)
    assert run["params"][0]["W"].shape == (5, 5, 1, 20)
    other = MultiLayerNetwork(MultiLayerConfiguration.from_json(run["conf"]),
                              device="cpu").init()
    other.set_params(net.params())
    np.testing.assert_array_equal(other.params(), net.params())
    x, _ = _batch(1)
    np.testing.assert_array_equal(other.output(x), net.output(x))
    with pytest.raises(ValueError):
        other.set_params(net.params()[:-1])


def test_lenet_feed_forward_and_clone(lenet_runs):
    net = _port_lenet(lenet_runs["nesterovs"])
    x, y = _batch(2)
    acts = net.feed_forward(x)
    assert [a.shape for a in acts] == [
        (4, 784), (4, 24, 24, 20), (4, 12, 12, 20), (4, 8, 8, 50),
        (4, 4, 4, 50), (4, 500), (4, 10)]
    np.testing.assert_array_equal(acts[-1], net.output(x))
    twin = net.clone()
    net.fit(x, y)
    twin.fit(x, y)
    np.testing.assert_array_equal(twin.params(), net.params())
    assert twin.score() == net.score()


def test_gradient_normalization_and_l2_in_a_conv_net_match_jax(J):
    """Per-layer gradient renormalization (a pooling layer has no
    gradients to renormalize), L2 on weights and biases and a
    bias learning rate, through two Adam steps in float64."""
    import importlib
    jconf = importlib.import_module(
        "deeplearning4j_tpu.nn.conf.neural_net_configuration")
    jinput = importlib.import_module("deeplearning4j_tpu.nn.conf.input_type")
    jlayers = importlib.import_module("deeplearning4j_tpu.nn.conf.layers")
    conf = (jconf.NeuralNetConfiguration.Builder().seed(3).updater("adam")
            .learning_rate(0.01).bias_learning_rate(0.02).l2(1e-3)
            .data_type("float64")
            .gradient_normalization("RenormalizeL2PerLayer").list()
            .layer(jlayers.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                            activation="relu", l2_bias=5e-4))
            .layer(jlayers.SubsamplingLayer(pooling_type="avg"))
            .layer(jlayers.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(jinput.InputType.convolutional(8, 8, 2)).build())
    ref = J.Net(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                            device="cpu").init()
    net.from_jax_params(_numpy_tree(J, ref._params))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 8, 8, 2))
    y = np.eye(3)[rng.integers(0, 3, 5)]
    for _ in range(2):
        ref.fit(x, y)
        net.fit(x, y)
        assert abs(net.score() - float(ref.score())) <= 1e-9
    np.testing.assert_allclose(net.params(), ref.params(), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# Configuration JSON, both ways
# ---------------------------------------------------------------------------

def test_lenet_conf_json_is_the_reference_json(J):
    for kw in ({}, {"updater": "adam", "data_type": "bfloat16"}):
        ref = J.lenet_conf(**kw).to_json()
        mine = lenet_conf(**kw).to_json()
        assert mine == ref
        assert MultiLayerConfiguration.from_json(ref).to_json() == ref
        assert J.Conf.from_json(mine).to_json() == mine


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_golden_conf_json_round_trips(J, name):
    with zipfile.ZipFile(os.path.join(GOLDEN, f"{name}.zip")) as zf:
        text = zf.read("configuration.json").decode("utf-8")
    want = J.Conf.from_json(text).to_json()
    assert MultiLayerConfiguration.from_json(text).to_json() == want
    assert MultiLayerConfiguration.from_json(text).clone().to_json() == want
    assert J.Conf.from_json(want).to_json() == want
    if name == "mlp":           # written by the current reference
        assert want == text


def test_conf_naming_an_unported_layer_raises_with_its_roadmap_item():
    with zipfile.ZipFile(os.path.join(GOLDEN, "lstm.zip")) as zf:
        text = zf.read("configuration.json").decode("utf-8")
    with pytest.raises(NotImplementedError, match="graveslstm.*item 18"):
        MultiLayerConfiguration.from_json(text)
    with pytest.raises(NotImplementedError, match="vae.*item 18"):
        TLy.VariationalAutoencoder(n_out=3)


def test_builder_dsl_infers_preprocessors_and_n_in():
    conf = lenet_conf()
    assert [l.n_in for l in conf.layers if hasattr(l, "n_in")] == [
        1, 20, 800, 500]
    assert sorted(conf.preprocessors) == [0, 4]
    conf = (NeuralNetConfiguration.Builder().seed(1).list()
            .layer(TLy.DenseLayer(n_in=3, n_out=4))
            .layer(TLy.OutputLayer(n_out=2)).build())
    assert conf.layers[1].n_in is None and conf.layers[0].activation == "sigmoid"


# ---------------------------------------------------------------------------
# Model zips
# ---------------------------------------------------------------------------

def _golden(name):
    return (os.path.join(GOLDEN, f"{name}.zip"),
            np.load(os.path.join(GOLDEN, f"{name}_io.npz")))


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_golden_zip_restores_exactly(J, name):
    path, io = _golden(name)
    net = TS.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_array_equal(net.params(), io["params"])
    np.testing.assert_allclose(net.output(io["x"]), io["y"], rtol=1e-6,
                               atol=1e-6)
    ref = J.ser.restore_multi_layer_network(path)
    want = J.jax.tree_util.tree_leaves(ref._updater_state)
    got = TS.tree_leaves(net.reference_updater_state())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert net.conf.iteration_count == ref.conf.iteration_count


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_golden_zip_keeps_training_as_jax(J, name):
    path, io = _golden(name)
    n_out = io["y"].shape[1]
    rng = np.random.default_rng(0)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out,
                                                     io["x"].shape[0])]
    ref = J.ser.restore_multi_layer_network(path)
    net = TS.restore_multi_layer_network(path, device="cpu")
    it0 = net.conf.iteration_count
    ref.fit(io["x"], y)
    net.fit(io["x"], y)
    assert net.conf.iteration_count == it0 + 1
    assert abs(net.score() - float(ref.score())) <= TOL
    np.testing.assert_allclose(net.params(), ref.params(), rtol=0, atol=TOL)


def test_port_written_zip_restores_in_jax(J, tmp_path, lenet_runs):
    net = _port_lenet(lenet_runs["nesterovs"])
    x, y = _batch(3)
    net.fit(x, y)
    path = str(tmp_path / "port_lenet.zip")
    TS.write_model(net, path)
    with zipfile.ZipFile(path) as zf:
        assert set(zf.namelist()) == {"configuration.json", "coefficients.bin",
                                      "updaterState.bin", "modelState.bin"}
        assert json.loads(zf.read("configuration.json"))["iterationCount"] == 1
    ref = J.ser.restore_multi_layer_network(path)
    np.testing.assert_array_equal(ref.params(), net.params())
    np.testing.assert_allclose(np.asarray(ref.output(x)), net.output(x),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(J.jax.tree_util.tree_leaves(ref._updater_state),
                    TS.tree_leaves(net.reference_updater_state()),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = TS.restore_multi_layer_network(path, device="cpu")
    for a, b in zip(TS.tree_leaves(again.reference_updater_state()),
                    TS.tree_leaves(net.reference_updater_state())):
        np.testing.assert_array_equal(a, b)


def test_tree_leaves_follow_jax_order(J):
    tree = [{"b": {"v": 1, "m": 2}, "W": {"t": 3}}, {}, {"gamma": {"x": 4},
                                                          "beta": {"x": 5}}]
    assert TS.tree_leaves(tree) == J.jax.tree_util.tree_leaves(tree)
    assert TS.tree_unflatten(tree, TS.tree_leaves(tree)) == tree


# ---------------------------------------------------------------------------
# Entry points and what is not ported yet
# ---------------------------------------------------------------------------

def test_entry_points_run_on_the_card_or_raise():
    if torch.cuda.is_available():
        assert lenet().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lenet()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MultiLayerNetwork(lenet_conf())


def test_unported_paths_raise_with_their_roadmap_items():
    net = lenet(device="cpu")
    for call, item in ((lambda: net.fused_steps(4), "item 17"),
                       (lambda: net.training_health(), "item 17"),
                       (lambda: net.set_listeners(object()), "item 16"),
                       (lambda: net.evaluate(None), "item 16"),
                       (lambda: net.rnn_time_step(None), "item 18"),
                       (lambda: net.pretrain(None), "item 18"),
                       (lambda: net.fit(iter([])), "item 14")):
        with pytest.raises(NotImplementedError, match=item):
            call()


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_lenet_f32_on_card_matches_cpu(cuda):
    """Same weights (seeded), f32, batch 64: three Nesterov steps on the
    card (cuDNN with TF32 off, inside the port's own calls) and on the
    CPU; losses and parameters agree to 1e-5. TF32 stays on globally, as
    PyTorch's default, to show the port scopes it off itself."""
    torch.backends.cudnn.allow_tf32 = True
    x, y = _batch(5, 64)
    nets = [lenet(device=d, seed=9) for d in (cuda, "cpu")]
    np.testing.assert_array_equal(nets[0].params(), nets[1].params())
    np.testing.assert_allclose(nets[0].output(x), nets[1].output(x), rtol=0,
                               atol=1e-5)
    for _ in range(STEPS):
        for net in nets:
            net.fit(x, y)
        assert abs(nets[0].score() - nets[1].score()) <= 1e-5
    np.testing.assert_allclose(nets[0].params(), nets[1].params(), rtol=0,
                               atol=1e-5)
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_golden_zip_on_card(cuda, name):
    path, io = _golden(name)
    net = TS.restore_multi_layer_network(path)
    assert net.device.type == "cuda"
    np.testing.assert_array_equal(net.params(), io["params"])
    np.testing.assert_allclose(net.output(io["x"]), io["y"], rtol=1e-5,
                               atol=1e-5)
