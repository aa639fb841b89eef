"""The classic CNNs of the zoo (`models/zoo/classic_cnns.py`: AlexNet,
VGG-16, GoogLeNet) against the JAX package's.

  - Each configuration's JSON at the published width (224x224x3, 1000
    classes, bf16, Nesterov 0.9) is the reference's, compared as parsed
    dicts; conf only, no weights drawn. Each loads in the other package.
  - At toy sizes (AlexNet 64x64, VGG-16 32x32, GoogLeNet 64x64; 3
    channels, 10 classes, f32) the flat parameters have the reference's
    names and shapes, in order (the reference's through `jax.eval_shape`).
  - With the reference's weights (its init's draw, under one jit, carried
    over by `from_jax_params`), dropout off, batch 2: one f32 inference
    forward within 1e-5 of the largest output (read: <= 1.7e-6), and one
    Nesterov training step in f64 from the same weights: the score within
    1e-9 relative and the parameters within 1e-9 of the largest change
    (read: <= 7.7e-16 and 7.0e-15).
    The step is held in f64 because f32 cannot show a fault at this
    depth: GoogLeNet's f32 gradients differ between the two backends by
    1.6e-4 (relative L2; 1e-3 at the stem, 57 convolutions and two LRNs
    below the loss) where its f64 gradients agree to 1.4e-15. LRN, the
    channel MergeVertex and "same" max pooling at stride 1 are on these
    paths.
"""
import json
import types

import numpy as np
import pytest

from deeplearning4j_tpu_torch.models.zoo import classic_cnns as TC
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

NAMES = ["alexnet", "vgg16", "googlenet"]
TOY = {"alexnet": 64, "vgg16": 32, "googlenet": 64}
TOL = 1e-5
TOL_F64 = 1e-9


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import importlib

    from deeplearning4j_tpu.nn.conf.computation_graph_configuration import \
        ComputationGraphConfiguration as JGConf
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
        MultiLayerConfiguration as JConf
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    zoo = importlib.import_module("deeplearning4j_tpu.models.zoo.classic_cnns")
    return types.SimpleNamespace(jax=jax, zoo=zoo, Conf=JConf, GConf=JGConf,
                                 Net=JNet, Graph=JGraph)


def _conf(module, name, **kw):
    return getattr(module, f"{name}_conf")(**kw)


def _toy(name):
    hw = TOY[name]
    return dict(height=hw, width=hw, channels=3, num_classes=10,
                data_type="float32")


def _is_graph(name):
    return name == "googlenet"


def _layers(conf):
    if hasattr(conf, "layers"):
        return list(conf.layers)
    return [v.conf for v in conf.vertices.values() if v.is_layer]


@pytest.mark.parametrize("name", NAMES)
def test_published_conf_json_is_the_reference_s(J, name):
    mine, ref = _conf(TC, name).to_json(), _conf(J.zoo, name).to_json()
    assert json.loads(mine) == json.loads(ref)
    d = json.loads(mine)
    g = d.get("global_conf", d.get("globalConf", {}))
    assert g.get("data_type") == "bfloat16"
    parse = (ComputationGraphConfiguration if _is_graph(name)
             else MultiLayerConfiguration).from_json
    assert json.loads(parse(ref).to_json()) == json.loads(ref)
    jparse = (J.GConf if _is_graph(name) else J.Conf).from_json
    assert json.loads(jparse(mine).to_json()) == json.loads(mine)


def _reference_shapes(J, name, conf):
    cls = J.Graph if _is_graph(name) else J.Net
    ref = J.jax.eval_shape(lambda: cls(conf).init()._params)
    order = lambda k: ({"W": 0, "b": 2}.get(k, 9), k)  # noqa: E731
    if _is_graph(name):
        keys = [v for v in conf.topological_order if conf.vertices[v].is_layer]
    else:
        keys = range(len(conf.layers))
    return [(str(n), k, tuple(ref[n][k].shape)) for n in keys
            for k in sorted(ref[n], key=order)]


@pytest.mark.parametrize("name", NAMES)
def test_toy_parameter_shapes_are_the_reference_s(J, name):
    conf = _conf(TC, name, **_toy(name))
    cls = ComputationGraph if _is_graph(name) else MultiLayerNetwork
    net = cls(conf, device="cpu").init()
    got = [(str(key), k, tuple(layer.to_reference(k, p).shape))
           for key, k, layer, p in net._param_leaves()]
    assert got == _reference_shapes(J, name, _conf(J.zoo, name,
                                                   **_toy(name)))
    assert net.num_params() == sum(int(np.prod(s)) for *_, s in got)


def _dropout_off(conf):
    for layer in _layers(conf):
        layer.dropout = None
    return conf


@pytest.fixture(scope="module")
def toy_runs(J):
    """Per model: the reference's toy-size f32 weights (dropout off), its
    f32 output on a batch of 2, and its f64 score and parameters after one
    step from the same weights."""
    runs = {}
    for name in NAMES:
        cls = J.Graph if _is_graph(name) else J.Net
        confs = {dt: _dropout_off(_conf(J.zoo, name,
                                        **dict(_toy(name), data_type=dt)))
                 for dt in ("float32", "float64")}
        net = cls(confs["float32"])
        # the reference's init under one jit: its own draw, compiled once
        # rather than op by op (26 s eager for GoogLeNet on the CPU)
        net._params, net._model_state = J.jax.jit(
            lambda: (lambda n: (n._params, n._model_state))(
                cls(confs["float32"]).init()))()
        hw = TOY[name]
        r = np.random.default_rng(len(name))
        x = r.random((2, hw, hw, 3)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[r.integers(0, 10, 2)]
        params = J.jax.tree.map(np.array, net._params)
        out = net.output(x)
        run = {"confs": {dt: c.to_json() for dt, c in confs.items()},
               "x": x, "y": y, "params": params,
               "output": np.asarray(out[0] if _is_graph(name) else out)}
        net64 = cls(confs["float64"])
        net64._params = J.jax.tree.map(
            lambda a: J.jax.numpy.asarray(a, np.float64), params)
        net64._model_state = net._model_state
        net64._init_updater_state()
        run["flat0"] = np.asarray(net64.params())
        net64.fit(x.astype(np.float64), y.astype(np.float64))
        run["score"] = float(net64.score())
        run["flat1"] = np.asarray(net64.params())
        runs[name] = run
    return runs


def _port(name, run, dt):
    conf = run["confs"][dt]
    if _is_graph(name):
        net = ComputationGraph(ComputationGraphConfiguration.from_json(conf),
                               device="cpu").init()
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf),
                                device="cpu").init()
    return net.from_jax_params(run["params"])


@pytest.mark.parametrize("name", NAMES)
def test_toy_forward_matches_the_reference(toy_runs, name):
    run = toy_runs[name]
    net = _port(name, run, "float32")
    out = net.output(run["x"])
    out = out[0] if _is_graph(name) else out
    assert out.shape == (2, 10)
    np.testing.assert_allclose(out, run["output"], rtol=0,
                               atol=TOL * np.abs(run["output"]).max())


@pytest.mark.parametrize("name", NAMES)
def test_toy_training_step_matches_the_reference(toy_runs, name):
    run = toy_runs[name]
    net = _port(name, run, "float64")
    np.testing.assert_array_equal(net.params(), run["flat0"])
    x, y = run["x"].astype(np.float64), run["y"].astype(np.float64)
    net.fit(x, y)
    assert net.score() == pytest.approx(run["score"], rel=TOL_F64)
    change = np.abs(run["flat1"] - run["flat0"]).max()
    assert change > 0
    np.testing.assert_allclose(net.params(), run["flat1"], rtol=0,
                               atol=TOL_F64 * change)


@pytest.mark.parametrize("name", NAMES)
def test_builders_take_a_device(name):
    import torch
    fn = getattr(TC, name)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(**_toy(name))
