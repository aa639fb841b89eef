"""The port's ComputationGraph (`deeplearning4j_tpu_torch.nn.graph`), the
ResNet-50 zoo configuration and the graph's model zips, against the JAX
package's.

The residual graph is built in each package from its own `resnet.py`
helpers (`_conv_bn`, `_bottleneck`): the stem (7x7/2 conv, BN, ReLU, 3x3/2
SAME max pool), one projection bottleneck at stride 2, one identity
bottleneck, global average pool and a softmax head; 16x16x3 inputs, batch
4, width 8 (bottleneck width 4), 5 classes. The JAX package draws the
weights, `ComputationGraph.from_jax_params` carries them over, and the
same numpy batch goes to both. Held on the CPU:
  - f32, Nesterov: `output`, `score` and the first loss to 1e-5, the flat
    gradient to 1e-5 (read: 3.7e-6 of gradients up to 0.79); three `fit`
    steps: losses and parameters to 1e-5 (read: 3e-7 and 5.2e-7), the
    BatchNorm running statistics to 1e-5 (read: 1.8e-6);
  - f64, Adam: the same at 1e-9 (Adam turns the last bits of a tiny f32
    gradient into an lr-size step: see tests/test_torch_multilayer.py);
  - bf16, Nesterov: the port's bf16 run is held to the f32 result as
    the reference's own bf16 run is: its largest error against the
    reference's f32 output, score, flat gradient, three losses and final
    parameters is at most twice the reference's bf16 error against the
    same, or one bf16 step (2^-8) of the largest value where that is more
    (read: 0.50x, 1.9x of the score's 4.0e-4 but 0.07 of a step, 1.60x,
    1.55x, 0.67x). The two round at other
    places (XLA fuses an elementwise chain into one rounding, eager torch
    rounds after each op), so neither is the other's reference.

ResNet-50 at full depth is built, not trained: its JSON is the reference's,
both ways; its parameter count is in 25.4e6-25.8e6 (as tests/test_zoo.py);
its flat parameters have the reference's shapes, in order.

Tests marked `gpu` run on the card and skip without one:
    python -m pytest --noconftest tests/test_torch_computation_graph.py -m gpu
"""
import importlib
import os
import types
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.zoo import resnet as TR
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf import layers as TLy
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util import model_serializer as TS

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden")
TOL = 1e-5
BF16_REL = 2.0 ** -5   # card vs CPU, both bf16 through the port
STEPS = 3
CASES = {"nesterovs-f32": ("nesterovs", "float32"),
         "adam-f64": ("adam", "float64"),
         "nesterovs-bf16": ("nesterovs", "bfloat16")}


def residual_conf(resnet, builder, input_type, layers, updater="nesterovs",
                  data_type="float32"):
    """The residual graph, from package `resnet`'s own helpers."""
    b = (builder().seed(7).updater(updater).momentum(0.9)
         .learning_rate(0.05 if updater == "nesterovs" else 1e-3)
         .weight_init("relu").data_type(data_type))
    gb = b.graph_builder().add_inputs("input")
    x = resnet._conv_bn(gb, "stem", "input", 8, (7, 7), (2, 2), "relu")
    gb.add_layer("stem_pool", layers.SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), x)
    x = resnet._bottleneck(gb, "s2b0", "stem_pool", 4, 2, True)
    x = resnet._bottleneck(gb, "s2b1", x, 4, 1, False)
    gb.add_layer("avgpool", layers.GlobalPoolingLayer(pooling_type="avg"), x)
    gb.add_layer("fc", layers.OutputLayer(n_out=5, activation="softmax",
                                          loss_function="mcxent"), "avgpool")
    return (gb.set_outputs("fc")
            .set_input_types(input_type.convolutional(16, 16, 3)).build())


def port_residual_conf(updater="nesterovs", data_type="float32"):
    return residual_conf(TR, NeuralNetConfiguration.Builder, InputType, TLy,
                         updater, data_type)


def _batch(seed=0, n=4, hw=16, classes=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.nn.conf import layers
    from deeplearning4j_tpu.nn.conf.computation_graph_configuration import \
        ComputationGraphConfiguration as JConf
    from deeplearning4j_tpu.nn.conf.input_type import InputType as JInput
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.util import model_serializer as jser
    # the module: the zoo package exports a function of the same name
    jresnet = importlib.import_module("deeplearning4j_tpu.models.zoo.resnet")
    return types.SimpleNamespace(
        jax=jax, resnet=jresnet, Conf=JConf, Graph=JGraph, ser=jser,
        conf=lambda *a: residual_conf(jresnet, JNNC.Builder, JInput, layers,
                                      *a))


def _jax_score_and_grad(J, net, x, y):
    """The reference's `score` (train=False) and
    `compute_gradient_and_score` (train=True, PRNGKey(0)) through its own
    `_loss_fn`, under jit (compiled once, not dispatched op by op)."""
    jax, jnp = J.jax, J.jax.numpy
    key = jax.random.PRNGKey(0)
    feats, labels = {"input": jnp.asarray(x)}, [jnp.asarray(y)]

    def loss(p, train):
        return net._loss_fn(p, net._model_state, feats, labels, None, None,
                            key, train)[0]

    score = jax.jit(lambda p: loss(p, False))(net._params)
    grad_score, grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, True)))(net._params)
    return float(score), float(grad_score), net.flatten_gradients(grads)


@pytest.fixture(scope="module")
def graph_runs(J):
    """Per case: the reference's weights, output, score, gradient, and
    three fit steps (losses, parameters, BN running statistics)."""
    jax, jnp = J.jax, J.jax.numpy
    x, y = _batch()
    base = J.Graph(J.conf()).init()
    runs = {}
    for name, (updater, dt) in CASES.items():
        conf = J.conf(updater, dt)
        net = J.Graph(conf)
        # the base weights, cast (copies: fit donates its buffers)
        net._params = jax.tree.map(
            lambda a: jnp.array(a, net.param_dtype, copy=True), base._params)
        net._model_state = jax.tree.map(jnp.copy, base._model_state)
        net._init_updater_state()
        run = {"conf": conf.to_json(),
               "params": jax.tree.map(np.array, net._params),
               "state": jax.tree.map(np.array, net._model_state),
               "output": np.asarray(net.output(x)[0]).astype(np.float64)}
        run["score"], run["grad_score"], run["grad"] = _jax_score_and_grad(
            J, net, x, y)
        run["losses"], run["steps"] = [], []
        for _ in range(STEPS):
            net.fit(x, y)
            run["losses"].append(float(net.score()))
            run["steps"].append(net.params())
        run["final_state"] = jax.tree.map(np.array, net._model_state)
        runs[name] = run
    return runs


def _within_bf16_limit(port_bf16, ref_bf16, ref_f32, what):
    """The port's bf16 error against the reference's f32 result is at most
    twice the reference's own bf16 error, and never held below one bf16
    step (2^-8 relative) of the largest value."""
    ref_f32 = np.asarray(ref_f32, np.float64)
    limit = max(2 * np.abs(np.asarray(ref_bf16, np.float64) - ref_f32).max(),
                2.0 ** -8 * np.abs(ref_f32).max())
    err = np.abs(np.asarray(port_bf16, np.float64) - ref_f32).max()
    assert err <= limit, f"{what}: bf16 error {err} over {limit}"


def _port_graph(run, device="cpu"):
    conf = ComputationGraphConfiguration.from_json(run["conf"])
    net = ComputationGraph(conf, device=device).init()
    return net.from_jax_params(run["params"], run["state"])


def test_residual_conf_from_each_package_is_the_same_json(J):
    for updater, dt in CASES.values():
        ref = J.conf(updater, dt).to_json()
        assert port_residual_conf(updater, dt).to_json() == ref
        assert ComputationGraphConfiguration.from_json(ref).to_json() == ref
        assert J.Conf.from_json(port_residual_conf(updater, dt).to_json()
                                ).to_json() == ref


@pytest.mark.parametrize("case", list(CASES))
def test_residual_forward_score_and_gradient_match_jax(graph_runs, case):
    run = graph_runs[case]
    net = _port_graph(run)
    x, y = _batch()
    out = net.output(x)[0]
    got = [net.score(DataSet(x, y))]
    grads, grad_score = net.compute_gradient_and_score(x, y)
    got.append(grad_score)
    flat = net.flatten_gradients(grads)
    if case.endswith("bf16"):
        f32 = graph_runs["nesterovs-f32"]
        for key, mine in (("output", out), ("grad", flat),
                          ("score", got[0]), ("grad_score", got[1])):
            _within_bf16_limit(mine, run[key], f32[key], key)
        return
    tol = TOL if case.endswith("f32") else 1e-9
    np.testing.assert_allclose(out, run["output"], rtol=0, atol=tol)
    np.testing.assert_allclose(got, [run["score"], run["grad_score"]],
                               rtol=0, atol=tol)
    np.testing.assert_allclose(flat, run["grad"], rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_residual_three_fit_steps_match_jax(graph_runs, case):
    run = graph_runs[case]
    net = _port_graph(run)
    x, y = _batch()
    losses = []
    for step in range(STEPS):
        net.fit(MultiDataSet([x], [y]))
        losses.append(net.score())
        if not case.endswith("bf16"):
            tol = TOL if case.endswith("f32") else 1e-9
            np.testing.assert_allclose(net.params(), run["steps"][step],
                                       rtol=0, atol=tol, err_msg=str(step))
    assert all(p.dtype == torch.float32 or case == "adam-f64"
               for p in net.parameters())
    if case.endswith("bf16"):
        f32 = graph_runs["nesterovs-f32"]
        _within_bf16_limit(losses, run["losses"], f32["losses"], "losses")
        _within_bf16_limit(net.params(), run["steps"][-1], f32["steps"][-1],
                           "params")
        assert losses[-1] < losses[0]
        return
    np.testing.assert_allclose(losses, run["losses"], rtol=0,
                               atol=TOL if case.endswith("f32") else 1e-9)
    state = net.reference_model_state()
    for name, st in run["final_state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(state[name][k], v, rtol=0, atol=TOL,
                                       err_msg=f"{name}.{k}")


def test_residual_feed_forward_clone_and_params(graph_runs, J):
    run = graph_runs["nesterovs-f32"]
    net = _port_graph(run)
    x, y = _batch(1)
    acts = net.feed_forward(x)
    assert acts["stem_conv"].shape == (4, 8, 8, 8)
    assert acts["stem_pool"].shape == (4, 4, 4, 8)
    assert acts["s2b0_out"].shape == (4, 2, 2, 16)
    np.testing.assert_array_equal(acts["fc"], net.output(x)[0])
    twin = net.clone()
    net.fit(x, y)
    twin.fit(x, y)
    np.testing.assert_array_equal(twin.params(), net.params())
    other = ComputationGraph(net.conf.clone(), device="cpu").init()
    other.set_params(net.params())
    np.testing.assert_array_equal(other.params(), net.params())
    ref = J.Graph(J.Conf.from_json(run["conf"])).init()
    assert net.num_params() == ref.num_params()


# ---------------------------------------------------------------------------
# ResNet-50 at full depth: configuration and parameters, no step
# ---------------------------------------------------------------------------

def test_resnet50_conf_json_is_the_reference_json(J):
    for kw in ({}, {"data_type": "float32", "num_classes": 10, "height": 64,
                    "width": 64}):
        ref = J.resnet.resnet50_conf(**kw).to_json()
        mine = TR.resnet50_conf(**kw).to_json()
        assert mine == ref
        assert ComputationGraphConfiguration.from_json(ref).to_json() == ref
        assert J.Conf.from_json(mine).to_json() == mine


def test_resnet50_parameters_at_full_depth(J):
    net = TR.resnet50(device="cpu")
    assert 25.4e6 <= net.num_params() <= 25.8e6
    conf = J.resnet.resnet50_conf()
    ref = J.jax.eval_shape(lambda: J.Graph(conf).init()._params)
    want = [(n, k, ref[n][k].shape) for n in
            [v for v in conf.topological_order if conf.vertices[v].is_layer]
            for k in sorted(ref[n], key=lambda k: ({"W": 0, "b": 2, "gamma": 0,
                                                    "beta": 1}[k], k))]
    got = [(n, k, tuple(layer.to_reference(k, p).shape))
           for n, k, layer, p in net._param_leaves()]
    assert got == want
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert sum(int(np.prod(s)) for *_, s in want) == net.num_params()
    with pytest.raises(NotImplementedError, match="remat_segments"):
        TR.resnet50(device="cpu", remat=True)


# ---------------------------------------------------------------------------
# Model zips
# ---------------------------------------------------------------------------

def test_golden_cg_zip(J, tmp_path):
    path = os.path.join(GOLDEN, "cg.zip")
    io = np.load(os.path.join(GOLDEN, "cg_io.npz"))
    with zipfile.ZipFile(path) as zf:
        text = zf.read("configuration.json").decode("utf-8")
    assert ComputationGraphConfiguration.from_json(text).to_json() == text
    net = TS.restore_computation_graph(path, device="cpu")
    np.testing.assert_array_equal(net.params(), io["params"])
    np.testing.assert_allclose(net.output(io["x"])[0], io["y"], rtol=1e-6,
                               atol=1e-6)
    assert net.num_params() == 164 and net.conf.iteration_count == 3
    ref = J.ser.restore_computation_graph(path)
    for a, b in zip(J.jax.tree_util.tree_leaves(ref._updater_state),
                    TS.tree_leaves(net.reference_updater_state()),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    # keeps training from the restored state as the reference does
    y = np.eye(4, dtype=np.float32)[np.random.default_rng(0).integers(
        0, 4, io["x"].shape[0])]
    ref.fit(io["x"], y)
    net.fit(io["x"], y)
    assert abs(net.score() - float(ref.score())) <= TOL
    np.testing.assert_allclose(net.params(), ref.params(), rtol=0, atol=TOL)
    # and a zip the port writes restores in the reference
    out = str(tmp_path / "port_cg.zip")
    TS.write_model(net, out)
    back = J.ser.restore_computation_graph(out)
    np.testing.assert_array_equal(back.params(), net.params())
    np.testing.assert_allclose(np.asarray(back.output(io["x"])[0]),
                               net.output(io["x"])[0], rtol=1e-6, atol=1e-6)
    for a, b in zip(J.jax.tree_util.tree_leaves(back._updater_state),
                    TS.tree_leaves(net.reference_updater_state()),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_residual_zip_round_trips_bn_state(J, graph_runs, tmp_path):
    """BatchNorm's running statistics travel in modelState.bin, in the
    reference's order (vertex names sorted)."""
    net = _port_graph(graph_runs["nesterovs-f32"])
    x, y = _batch(2)
    net.fit(x, y)
    path = str(tmp_path / "residual.zip")
    TS.write_model(net, path)
    ref = J.ser.restore_computation_graph(path)
    for name, st in net.reference_model_state().items():
        for k, v in st.items():
            np.testing.assert_array_equal(np.asarray(ref._model_state[name][k]),
                                          v)
    again = TS.restore_computation_graph(path, device="cpu")
    np.testing.assert_array_equal(again.output(x)[0], net.output(x)[0])


def test_entry_points_run_on_the_card_or_raise():
    conf = TR.resnet50_conf(height=32, width=32, num_classes=4)
    if torch.cuda.is_available():
        assert ComputationGraph(conf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ComputationGraph(conf)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TR.resnet50()


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_residual_f32_on_card_matches_cpu(cuda):
    """Same seeded weights, f32: output and three Nesterov steps on the
    card (cuDNN, TF32 off inside the port's calls while the global default
    stays on) and on the CPU agree to 1e-5."""
    torch.backends.cudnn.allow_tf32 = True
    x, y = _batch(3, n=8)
    nets = [ComputationGraph(port_residual_conf(), device=d).init()
            for d in (cuda, "cpu")]
    np.testing.assert_allclose(nets[0].output(x)[0], nets[1].output(x)[0],
                               rtol=0, atol=1e-5)
    for _ in range(STEPS):
        for net in nets:
            net.fit(x, y)
        assert abs(nets[0].score() - nets[1].score()) <= 1e-5
    np.testing.assert_allclose(nets[0].params(), nets[1].params(), rtol=0,
                               atol=1e-5)
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.gpu
def test_residual_bf16_step_on_card(cuda):
    """bf16 on the card: f32 masters, finite falling losses, and the CPU's
    bf16 losses within 2^-5."""
    x, y = _batch(4, n=8)
    nets = [ComputationGraph(port_residual_conf(data_type="bfloat16"),
                             device=d).init() for d in (cuda, "cpu")]
    losses = [[], []]
    for _ in range(STEPS):
        for net, seen in zip(nets, losses):
            net.fit(x, y)
            seen.append(net.score())
    assert np.isfinite(losses[0]).all() and losses[0][-1] < losses[0][0]
    np.testing.assert_allclose(losses[0], losses[1], rtol=BF16_REL)
    assert all(p.dtype == torch.float32 and p.is_cuda
               for p in nets[0].parameters())


@pytest.mark.gpu
def test_golden_cg_zip_on_card(cuda):
    io = np.load(os.path.join(GOLDEN, "cg_io.npz"))
    net = TS.restore_computation_graph(os.path.join(GOLDEN, "cg.zip"))
    assert net.device.type == "cuda"
    np.testing.assert_array_equal(net.params(), io["params"])
    np.testing.assert_allclose(net.output(io["x"])[0], io["y"], rtol=1e-5,
                               atol=1e-5)
