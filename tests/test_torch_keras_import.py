"""The port's Keras import (`deeplearning4j_tpu_torch/keras/keras_import.py`)
against the JAX package's and against numpy.

Each of tests/test_keras_import.py's thirteen tests has its counterpart
here, run on the port on the CPU (the real-Keras fixture's too, which the
reference marks slow for JAX's compile time): the same HDF5 files, the
same numpy forwards and limits. Beside them, the reference imports the
same file, and the port's configuration JSON and `params()` must equal
its own (bit for bit: the port builds the reference's numpy trees and
loads them through `from_jax_params`; what Keras does not supply, the LSTM
peepholes and the Embedding bias, is zero in both). The real fixture
(`tests/fixtures/keras_toy_residual.h5`, written by Keras) reads within
1e-5 of Keras's own predictions (`keras_toy_residual_io.npz`), as the
reference's limit. `keras_toy_residual_torch.npz` holds that file's model
config and weight groups for machines without h5py (the card's): it equals
what h5py reads. Without h5py the readers raise ImportError naming it.

The model builders here (`MODELS`, `read_npz_model`) also feed phase 30(d)
of chip_smoke.py, which loads this file by path.

Tests marked `gpu` run on the card and skip without one:
    python -m pytest --noconftest tests/test_torch_keras_import.py -m gpu
"""
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.keras import (
    import_keras_model_and_weights, import_keras_model_configuration,
    import_keras_sequential_model_and_weights, keras_import)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
REAL_H5 = os.path.join(FIXTURES, "keras_toy_residual.h5")
REAL_IO = os.path.join(FIXTURES, "keras_toy_residual_io.npz")
REAL_NPZ = os.path.join(FIXTURES, "keras_toy_residual_torch.npz")


# ---------------------------------------------------------------------------
# Models as (model config, {layer name: [(suffix, array)]}), and files
# ---------------------------------------------------------------------------

def _sequential(layer_cfgs):
    return {"class_name": "Sequential",
            "config": [{"class_name": c, "config": k} for c, k in layer_cfgs]}


def keras1_mlp(seed=0):
    """Dense(relu) 4 -> 8, Dense(softmax) 8 -> 3."""
    rng = np.random.default_rng(seed)
    W1, b1 = rng.standard_normal((4, 8)), rng.standard_normal(8)
    W2, b2 = rng.standard_normal((8, 3)), rng.standard_normal(3)
    cfg = _sequential(
        [("Dense", {"name": "d1", "output_dim": 8, "activation": "relu",
                    "batch_input_shape": [None, 4]}),
         ("Dense", {"name": "d2", "output_dim": 3,
                    "activation": "softmax"})])
    return cfg, {"d1": [("W", W1), ("b", b1)], "d2": [("W", W2), ("b", b2)]}


TH = dict(C=2, H=8, W=8, F=3, K=3)


def keras1_th_conv(seed=1):
    """Convolution2D(th, relu), MaxPooling2D, Flatten, Dense(linear):
    OIHW kernels and a Dense whose rows are in CHW order."""
    rng = np.random.default_rng(seed)
    C, H, W, F, K = (TH[k] for k in "CHWFK")
    Wc, bc = rng.standard_normal((F, C, K, K)), rng.standard_normal(F)
    PH, PW = (H - K + 1) // 2, (W - K + 1) // 2
    Wd, bd = rng.standard_normal((F * PH * PW, 4)), rng.standard_normal(4)
    cfg = _sequential(
        [("Convolution2D", {"name": "c1", "nb_filter": F, "nb_row": K,
                            "nb_col": K, "activation": "relu",
                            "dim_ordering": "th", "border_mode": "valid",
                            "batch_input_shape": [None, C, H, W]}),
         ("MaxPooling2D", {"name": "p1", "pool_size": [2, 2],
                           "strides": [2, 2], "dim_ordering": "th"}),
         ("Flatten", {"name": "f1"}),
         ("Dense", {"name": "d1", "output_dim": 4, "activation": "linear"})])
    return cfg, {"c1": [("W", Wc), ("b", bc)], "d1": [("W", Wd), ("b", bd)]}


def keras1_lstm(seed=2, nin=3, H=5, T=6):
    """LSTM(tanh, hard_sigmoid) in Keras 1's twelve arrays, Dense(linear)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s) * 0.5            # noqa: E731
    arrays = [(f"{n}_{g}", mk(*shape)) for g in "icfo"
              for n, shape in (("W", (nin, H)), ("U", (H, H)), ("b", (H,)))]
    cfg = _sequential(
        [("LSTM", {"name": "l1", "output_dim": H, "activation": "tanh",
                   "inner_activation": "hard_sigmoid",
                   "batch_input_shape": [None, T, nin]}),
         ("Dense", {"name": "d1", "output_dim": 2, "activation": "linear"})])
    return cfg, {"l1": arrays, "d1": [("W", mk(H, 2)), ("b", mk(2))]}


def keras1_functional(seed=9, C=2, H=6, W=6, F=3):
    """A Keras 1 "Model": two 1x1 th convolutions from one input, Merge
    (sum), Flatten, Dense(linear)."""
    rng = np.random.default_rng(seed)
    Wa, ba = rng.standard_normal((F, C, 1, 1)), rng.standard_normal(F)
    Wb, bb = rng.standard_normal((F, C, 1, 1)), rng.standard_normal(F)
    Wd, bd = rng.standard_normal((F * H * W, 4)), rng.standard_normal(4)

    def conv(name, act):
        return {"class_name": "Convolution2D", "name": name,
                "config": {"name": name, "nb_filter": F, "nb_row": 1,
                           "nb_col": 1, "activation": act,
                           "dim_ordering": "th", "border_mode": "valid"},
                "inbound_nodes": [[["in1", 0, 0]]]}

    layers = [
        {"class_name": "InputLayer", "name": "in1",
         "config": {"name": "in1", "batch_input_shape": [None, C, H, W]},
         "inbound_nodes": []},
        conv("ca", "relu"), conv("cb", "linear"),
        {"class_name": "Merge", "name": "m1",
         "config": {"name": "m1", "mode": "sum"},
         "inbound_nodes": [[["ca", 0, 0], ["cb", 0, 0]]]},
        {"class_name": "Flatten", "name": "f1",
         "config": {"name": "f1"}, "inbound_nodes": [[["m1", 0, 0]]]},
        {"class_name": "Dense", "name": "d1",
         "config": {"name": "d1", "output_dim": 4, "activation": "linear"},
         "inbound_nodes": [[["f1", 0, 0]]]},
    ]
    cfg = {"class_name": "Model", "config": {
        "name": "toy", "layers": layers, "input_layers": [["in1", 0, 0]],
        "output_layers": [["d1", 0, 0]]}}
    return cfg, {"ca": [("W", Wa), ("b", ba)], "cb": [("W", Wb), ("b", bb)],
                 "d1": [("W", Wd), ("b", bd)]}


MODELS = {"mlp": keras1_mlp, "th_conv": keras1_th_conv, "lstm": keras1_lstm,
          "functional": keras1_functional}


def groups(weights):
    """{layer name: [arrays]} (f32), as `_read_model_file` gives them."""
    return {n: [np.asarray(a, np.float32) for _, a in arrs]
            for n, arrs in weights.items()}


def write_h5(path, cfg, weights):
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg).encode("utf-8")
        mw = f.create_group("model_weights")
        for lname, arrs in weights.items():
            g = mw.create_group(lname)
            names = []
            for suffix, arr in arrs:
                n = f"{lname}_{suffix}"
                g.create_dataset(n, data=np.asarray(arr, np.float32))
                names.append(n.encode())
            g.attrs["weight_names"] = names
    return path


def read_npz_model(path=REAL_NPZ):
    """(model config, weight groups) from the npz form of a Keras file:
    `model_config` (JSON text), `groups` (JSON: layer name -> number of
    arrays) and the arrays as `<layer>/<index>`."""
    with np.load(path) as z:
        cfg = json.loads(str(z["model_config"]))
        counts = json.loads(str(z["groups"]))
        return cfg, {n: [z[f"{n}/{i}"] for i in range(k)]
                     for n, k in counts.items()}


def write_npz_model(path, cfg, weights):
    """The inverse of read_npz_model (made the committed fixture from the
    real .h5)."""
    arrays = {f"{n}/{i}": a for n, arrs in weights.items()
              for i, a in enumerate(arrs)}
    np.savez_compressed(path, model_config=np.array(json.dumps(cfg)),
                        groups=np.array(json.dumps(
                            {n: len(a) for n, a in weights.items()})),
                        **arrays)


def build(cfg, grps, device="cpu"):
    """The port's builder for a config (the route the files take)."""
    if cfg["class_name"] == "Sequential":
        return keras_import._build_sequential(cfg, grps, device=device)
    return keras_import._build_functional(cfg, grps, device=device)


# ---------------------------------------------------------------------------
# Fixtures and helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.keras import keras_import as ref
    return types.SimpleNamespace(jax=jax, ki=ref)


@pytest.fixture(scope="module")
def h5py():
    return pytest.importorskip("h5py")


def _same_as_reference(J, net, path):
    """The reference's import of `path`: the same configuration JSON and
    params() bit for bit."""
    ref = J.ki.import_keras_model_and_weights(path)
    assert net.conf.to_json() == ref.conf.to_json()
    np.testing.assert_array_equal(net.params(), np.asarray(ref.params()))
    return ref


def _first(out):
    return np.asarray(out[0] if isinstance(out, (list, tuple)) else out)


# ---------------------------------------------------------------------------
# The thirteen counterparts of tests/test_keras_import.py
# ---------------------------------------------------------------------------

def test_dense_mlp_output_matches_numpy(J, h5py, tmp_path):
    cfg, w = keras1_mlp()
    p = write_h5(str(tmp_path / "mlp.h5"), cfg, w)
    net = import_keras_sequential_model_and_weights(p, device="cpu")
    _same_as_reference(J, net, p)
    (W1, b1), (W2, b2) = ((a for _, a in w[n]) for n in ("d1", "d2"))
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    h = np.maximum(x @ W1.astype(np.float32) + b1.astype(np.float32), 0)
    z = h @ W2.astype(np.float32) + b2.astype(np.float32)
    want = np.exp(z - z.max(1, keepdims=True))
    want /= want.sum(1, keepdims=True)
    assert np.allclose(net.output(x), want, atol=1e-5)


def test_conv_th_ordering_matches_numpy(J, h5py, tmp_path):
    cfg, w = keras1_th_conv()
    p = write_h5(str(tmp_path / "conv.h5"), cfg, w)
    net = import_keras_sequential_model_and_weights(p, device="cpu")
    _same_as_reference(J, net, p)
    C, H, W, F, K = (TH[k] for k in "CHWFK")
    Wc, bc = (a.astype(np.float32) for _, a in w["c1"])
    Wd, bd = (a.astype(np.float32) for _, a in w["d1"])
    OH, OW = H - K + 1, W - K + 1
    PH, PW = OH // 2, OW // 2
    x_nchw = np.random.default_rng(1).standard_normal(
        (2, C, H, W)).astype(np.float32)
    conv = np.zeros((2, F, OH, OW), np.float32)
    for n in range(2):
        for f in range(F):
            for i in range(OH):
                for j in range(OW):
                    conv[n, f, i, j] = (x_nchw[n, :, i:i + K, j:j + K]
                                        * Wc[f]).sum() + bc[f]
    conv = np.maximum(conv, 0)
    pool = conv[:, :, :PH * 2, :PW * 2].reshape(2, F, PH, 2, PW, 2).max((3, 5))
    want = pool.reshape(2, -1) @ Wd + bd          # CHW flatten
    got = net.output(x_nchw.transpose(0, 2, 3, 1))
    assert np.allclose(got, want, atol=1e-3), np.abs(got - want).max()


def test_lstm_matches_numpy(J, h5py, tmp_path):
    nin, H, T = 3, 5, 6
    cfg, w = keras1_lstm(nin=nin, H=H, T=T)
    p = write_h5(str(tmp_path / "lstm.h5"), cfg, w)
    net = import_keras_sequential_model_and_weights(p, device="cpu")
    _same_as_reference(J, net, p)
    a = {n: v.astype(np.float32) for n, v in w["l1"]}
    x = np.random.default_rng(2).standard_normal((2, T, nin)).astype(
        np.float32)
    hs = lambda v: np.clip(0.2 * v + 0.5, 0, 1)              # noqa: E731
    h = np.zeros((2, H), np.float32)
    c = np.zeros((2, H), np.float32)
    for t in range(T):
        xt = x[:, t]
        i = hs(xt @ a["W_i"] + h @ a["U_i"] + a["b_i"])
        f = hs(xt @ a["W_f"] + h @ a["U_f"] + a["b_f"])
        g = np.tanh(xt @ a["W_c"] + h @ a["U_c"] + a["b_c"])
        c = f * c + i * g
        o = hs(xt @ a["W_o"] + h @ a["U_o"] + a["b_o"])
        h = o * np.tanh(c)
    Wd = net._params[1]["W"].detach().numpy()
    bd = net._params[1]["b"].detach().numpy()
    got = net.output(x)[:, -1]
    want = h @ Wd + bd
    assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()
    assert not net._params[0]["peep"].any()       # Keras has no peepholes


def test_batchnorm_inference_stats(J, h5py, tmp_path):
    rng = np.random.default_rng(3)
    gamma, beta, mean = (rng.standard_normal(4).astype(np.float32)
                         for _ in range(3))
    var = np.abs(rng.standard_normal(4)).astype(np.float32) + 0.5
    cfg = _sequential([("BatchNormalization",
                        {"name": "bn", "epsilon": 1e-5,
                         "batch_input_shape": [None, 4]})])
    p = write_h5(str(tmp_path / "bn.h5"), cfg,
                 {"bn": [("gamma", gamma), ("beta", beta),
                         ("running_mean", mean), ("running_std", var)]})
    net = import_keras_sequential_model_and_weights(p, device="cpu")
    ref = _same_as_reference(J, net, p)
    st = net.reference_model_state()[0]
    np.testing.assert_array_equal(st["mean"], np.asarray(
        ref._model_state[0]["mean"]))
    np.testing.assert_array_equal(st["var"], np.asarray(
        ref._model_state[0]["var"]))
    x = rng.standard_normal((6, 4)).astype(np.float32)
    want = gamma * (x - mean) / np.sqrt(var + 1e-5) + beta
    assert np.allclose(net.output(x), want, atol=1e-5)


def test_config_only_import(J):
    cfg = {"class_name": "Sequential", "config": [
        {"class_name": "Dense",
         "config": {"name": "d", "output_dim": 7, "activation": "tanh",
                    "batch_input_shape": [None, 3]}}]}
    conf = import_keras_model_configuration(json.dumps(cfg))
    assert conf.layers[0].n_out == 7
    assert conf.layers[0].n_in == 3
    assert conf.layers[0].activation == "tanh"
    assert conf.to_json() == J.ki.import_keras_model_configuration(
        json.dumps(cfg)).to_json()


def test_dense_linear_plus_activation_becomes_trainable_head(J, tmp_path):
    from deeplearning4j_tpu_torch.nn.conf.layers.feedforward import LossLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    cfg = {"class_name": "Sequential", "config": [
        {"class_name": "Dense",
         "config": {"name": "d", "output_dim": 3, "activation": "linear",
                    "batch_input_shape": [None, 4]}},
        {"class_name": "Activation",
         "config": {"name": "a", "activation": "softmax"}}]}
    path = tmp_path / "head.json"
    path.write_text(json.dumps(cfg))
    conf = import_keras_model_configuration(str(path))   # from a file
    assert isinstance(conf.layers[-1], LossLayer)
    assert conf.layers[-1].loss_function == "mcxent"
    assert conf.to_json() == J.ki.import_keras_model_configuration(
        json.dumps(cfg)).to_json()
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.random((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    net.fit(DataSet(x, y))
    assert np.isfinite(float(net.score()))


def test_asymmetric_zero_padding_raises():
    cfg = {"class_name": "Sequential", "config": [
        {"class_name": "ZeroPadding2D",
         "config": {"name": "zp", "padding": [[1, 2], [1, 1]],
                    "batch_input_shape": [None, 8, 8, 3]}}]}
    with pytest.raises(ValueError, match="Asymmetric ZeroPadding2D"):
        import_keras_model_configuration(json.dumps(cfg))


def test_symmetric_nested_zero_padding_imports(J):
    cfg = {"class_name": "Sequential", "config": [
        {"class_name": "ZeroPadding2D",
         "config": {"name": "zp", "padding": [[2, 2], [3, 3]],
                    "batch_input_shape": [None, 8, 8, 3]}},
        {"class_name": "Flatten", "config": {"name": "f"}},
        {"class_name": "Dense",
         "config": {"name": "d", "output_dim": 4, "activation": "tanh"}}]}
    conf = import_keras_model_configuration(json.dumps(cfg))
    assert conf.layers[0].pad == (2, 3)
    assert conf.to_json() == J.ki.import_keras_model_configuration(
        json.dumps(cfg)).to_json()


def test_unsupported_layer_raises():
    cfg = {"class_name": "Sequential", "config": [
        {"class_name": "Lambda",
         "config": {"name": "x", "batch_input_shape": [None, 3]}}]}
    with pytest.raises(ValueError, match="Unsupported Keras layer"):
        import_keras_model_configuration(json.dumps(cfg))


def test_functional_import_real_keras_fixture(J, h5py):
    """The committed file written by Keras (tests/fixtures/
    make_keras_fixture.py): Conv branches + Add + Concatenate + BN +
    Flatten + softmax Dense, within 1e-5 of Keras's predictions."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    net = import_keras_model_and_weights(REAL_H5, device="cpu")
    assert isinstance(net, ComputationGraph)
    _same_as_reference(J, net, REAL_H5)
    io = np.load(REAL_IO)
    got = _first(net.output(io["x"]))
    assert got.shape == io["y"].shape
    assert np.abs(got - io["y"]).max() < 1e-5


def test_functional_import_keras1_dialect_matches_numpy(J, h5py, tmp_path):
    """Keras 1 'Model' JSON: classic inbound_nodes triples, Merge with
    mode=sum, th convolutions, the Dense-after-Flatten row permutation."""
    cfg, w = keras1_functional()
    p = write_h5(str(tmp_path / "func1.h5"), cfg, w)
    net = import_keras_model_and_weights(p, device="cpu")
    _same_as_reference(J, net, p)
    Wa, ba = (a.astype(np.float32) for _, a in w["ca"])
    Wb, bb = (a.astype(np.float32) for _, a in w["cb"])
    Wd, bd = (a.astype(np.float32) for _, a in w["d1"])
    x_nchw = np.random.default_rng(9).standard_normal(
        (3, 2, 6, 6)).astype(np.float32)
    a = np.maximum(np.einsum("nchw,fcij->nfhw", x_nchw, Wa)
                   + ba[None, :, None, None], 0)
    b = np.einsum("nchw,fcij->nfhw", x_nchw, Wb) + bb[None, :, None, None]
    want = (a + b).reshape(3, -1) @ Wd + bd        # CHW flatten
    got = _first(net.output(x_nchw.transpose(0, 2, 3, 1)))
    assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()


def test_functional_output_dense_becomes_trainable_output_layer(h5py):
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    net = import_keras_model_and_weights(REAL_H5, device="cpu")
    assert isinstance(net.conf.vertices["dense_out"].conf, OutputLayer)
    io = np.load(REAL_IO)
    y = np.eye(10, dtype=np.float32)[np.arange(5)]
    mds = MultiDataSet([io["x"]], [y])
    s0 = net.score(mds)
    for _ in range(5):
        net.fit(mds)
    assert net.score(mds) < s0


def test_conv_use_bias_false_imports(J, h5py, tmp_path):
    """Conv2D(use_bias=False): a kernel-only weight group imports with no
    bias parameter."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((3, 3, 1, 4)).astype(np.float32)
    path = str(tmp_path / "nb.h5")
    cfg = {"class_name": "Sequential", "config": [
        {"class_name": "Conv2D",
         "config": {"name": "c", "filters": 4, "kernel_size": [3, 3],
                    "use_bias": False, "activation": "relu",
                    "batch_input_shape": [None, 8, 8, 1]}},
        {"class_name": "Flatten", "config": {"name": "f"}},
        {"class_name": "Dense",
         "config": {"name": "d", "units": 2, "activation": "softmax"}}]}
    write_h5(path, cfg, {"c": [("W", W)],
                         "d": [("W", rng.standard_normal((144, 2))),
                               ("b", np.zeros(2))]})
    net = import_keras_sequential_model_and_weights(path, device="cpu")
    _same_as_reference(J, net, path)
    assert "b" not in net._params[0]
    np.testing.assert_array_equal(net.reference_params()[0]["W"], W)
    out = net.output(rng.random((2, 8, 8, 1)).astype(np.float32))
    assert out.shape == (2, 2)


# ---------------------------------------------------------------------------
# Beyond the reference's tests
# ---------------------------------------------------------------------------

def _tensor(name):
    return {"class_name": "__keras_tensor__",
            "config": {"keras_history": [name, 0, 0]}}


def _modern(name, cls, cfg, inbound):
    return {"class_name": cls, "name": name, "config": dict(cfg, name=name),
            "inbound_nodes": ([{"args": [_tensor(inbound)], "kwargs": {}}]
                              if inbound else [])}


def _functional(layers, inp, out):
    return {"class_name": "Functional", "config": {
        "name": "m", "layers": layers, "input_layers": [[inp, 0, 0]],
        "output_layers": [[out, 0, 0]]}}


def test_fused_lstm_weights_in_a_modern_functional_model(J, h5py, tmp_path):
    """The fused three-array LSTM (kernel, recurrent_kernel, bias; gates i,
    f, c, o) in the modern dialect: the reference's parameters, the gates
    reordered to (c, i, f, o), zero peepholes."""
    rng = np.random.default_rng(12)
    E, H, T = 4, 3, 5
    cfg = _functional([
        _modern("seq", "InputLayer", {"batch_shape": [None, T, E]}, None),
        _modern("lstm", "LSTM", {"units": H, "activation": "tanh",
                                 "recurrent_activation": "sigmoid"}, "seq")],
        "seq", "lstm")
    K = rng.standard_normal((E, 4 * H))
    R = rng.standard_normal((H, 4 * H))
    b4 = rng.standard_normal(4 * H)
    p = write_h5(str(tmp_path / "lstm3.h5"), cfg,
                 {"lstm": [("kernel", K), ("recurrent_kernel", R),
                           ("bias", b4)]})
    net = import_keras_model_and_weights(p, device="cpu")
    _same_as_reference(J, net, p)
    got = net.reference_params()["lstm"]
    for key, src, axis in (("W", K, 1), ("RW", R, 1), ("b", b4, 0)):
        i, f, c, o = np.split(src.astype(np.float32), 4, axis=axis)
        np.testing.assert_array_equal(got[key], np.concatenate(
            [c, i, f, o], axis=axis))
    assert not got["peep"].any()
    x = rng.standard_normal((2, T, E)).astype(np.float32)
    assert _first(net.output(x)).shape == (2, T, H)


def test_modern_embedding_has_a_zero_bias(J, h5py, tmp_path):
    rng = np.random.default_rng(13)
    V, E = 7, 4
    cfg = _functional([
        _modern("ids", "InputLayer", {"batch_shape": [None, 1]}, None),
        _modern("emb", "Embedding", {"input_dim": V, "output_dim": E},
                "ids"),
        _modern("out", "Dense", {"units": 3, "activation": "softmax"},
                "emb")], "ids", "out")
    p = write_h5(str(tmp_path / "emb.h5"), cfg,
                 {"emb": [("embeddings", rng.standard_normal((V, E)))],
                  "out": [("kernel", rng.standard_normal((E, 3))),
                          ("bias", rng.standard_normal(3))]})
    net = import_keras_model_and_weights(p, device="cpu")
    _same_as_reference(J, net, p)
    assert not net.reference_params()["emb"]["b"].any()
    out = _first(net.output(np.array([[1], [6]], np.float32)))
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-6)


def test_keras2_sequential_dict_config(J, h5py, tmp_path):
    cfg, w = keras1_mlp(4)
    cfg = {"class_name": "Sequential", "config": {"layers": cfg["config"]}}
    p = write_h5(str(tmp_path / "k2.h5"), cfg, w)
    net = import_keras_model_and_weights(p, device="cpu")
    _same_as_reference(J, net, p)


def test_npz_fixture_equals_the_h5(h5py):
    """The committed npz holds exactly what h5py reads from the real file;
    built from it, the graph reads Keras's predictions as well."""
    cfg, grps = keras_import._read_model_file(REAL_H5)
    cfg2, grps2 = read_npz_model()
    assert cfg2 == cfg
    assert sorted(grps2) == sorted(grps)
    for n in grps:
        assert len(grps2[n]) == len(grps[n])
        for a, b in zip(grps2[n], grps[n]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    io = np.load(REAL_IO)
    got = _first(build(cfg2, grps2).output(io["x"]))
    assert np.abs(got - io["y"]).max() < 1e-5


@pytest.mark.parametrize("name", sorted(MODELS))
def test_builders_take_the_groups_as_the_files_give_them(h5py, name,
                                                         tmp_path):
    """The in-memory route (phase 30(d) on the card) equals the file
    route."""
    cfg, w = MODELS[name]()
    p = write_h5(str(tmp_path / f"{name}.h5"), cfg, w)
    a = import_keras_model_and_weights(p, device="cpu")
    b = build(cfg, groups(w))
    np.testing.assert_array_equal(a.params(), b.params())
    assert a.conf.to_json() == b.conf.to_json()


def test_readers_without_h5py_raise_import_error_naming_it(monkeypatch):
    from deeplearning4j_tpu_torch.keras import server
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        import_keras_model_and_weights(REAL_H5, device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        import_keras_sequential_model_and_weights(REAL_H5, device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        server._load_array(REAL_H5, "features")
    # the npz route needs no h5py
    assert server._load_array(REAL_IO, "x").shape == (5, 8, 8, 3)


def test_entry_points_default_to_the_card(h5py, tmp_path):
    cfg, w = keras1_mlp()
    p = write_h5(str(tmp_path / "mlp.h5"), cfg, w)
    for call in (import_keras_model_and_weights,
                 import_keras_sequential_model_and_weights):
        if torch.cuda.is_available():
            assert call(p).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call(p)


def test_aliases_and_exports():
    from deeplearning4j_tpu_torch import keras as K
    ki = keras_import
    assert ki.importKerasModelAndWeights is import_keras_model_and_weights
    assert ki.importKerasSequentialModelAndWeights is \
        import_keras_sequential_model_and_weights
    assert ki.importKerasModelConfiguration is \
        import_keras_model_configuration
    assert K.KerasModelImport is ki
    assert sorted(K.__all__) == sorted([
        "DeepLearning4jEntryPoint", "KerasBridgeServer", "KerasModelImport",
        "import_keras_model_and_weights", "import_keras_model_configuration",
        "import_keras_sequential_model_and_weights"])


@pytest.mark.parametrize("config", [
    {}, {"dim_ordering": "th"}, {"dim_ordering": "tf"},
    {"data_format": "channels_first"}, {"dim_ordering": None}])
def test_dim_ordering_of_is_the_reference_s(J, config):
    """A layer config's `dim_ordering` ("tf" when it names none; a Keras 2
    `data_format` is not read), as the reference's."""
    lc = {"class_name": "Conv2D", "config": dict(config)}
    assert keras_import.dim_ordering_of(lc) == J.ki.dim_ordering_of(lc)


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_real_fixture_on_card(cuda):
    net = build(*read_npz_model(), device=cuda)
    assert net.device.type == "cuda"
    io = np.load(REAL_IO)
    got = _first(net.output(io["x"]))
    assert np.abs(got - io["y"]).max() < 1e-5
