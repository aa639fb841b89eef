"""Keras model import (a JSON topology and HDF5 weights): port of
deeplearning4j_tpu/keras/keras_import.py.

Three entry points, each with its camelCase alias:
  - `import_keras_sequential_model_and_weights(h5_path, device=None)`: a
    Sequential model as a MultiLayerNetwork;
  - `import_keras_model_and_weights(h5_path, device=None)`: a Sequential
    model as above, a functional `Model` as a ComputationGraph;
  - `import_keras_model_configuration(json_path_or_str)`: the
    MultiLayerConfiguration of a Sequential topology, touching no device.
`device=None` is the CUDA card, as for every entry point of the port.

Both config dialects are read: Keras 1 (output_dim / nb_filter / nb_row /
subsample / border_mode / p, Merge with a mode) and the modern one (units /
filters / kernel_size / strides / padding / rate, Add / Concatenate ...),
in `th` (channels-first) and `tf` (channels-last) ordering. The layers:
Dense, Convolution2D / Conv2D, MaxPooling2D, AveragePooling2D, LSTM,
Embedding, BatchNormalization, Activation, Dropout, ZeroPadding2D, and the
structural Flatten, Reshape and InputLayer; the merge layers become graph
vertices. A trailing softmax / sigmoid becomes a loss head (mcxent / xent),
so the imported network trains.

Reading (`_read_model_file` -> (model config, weight groups); h5py,
imported when a file is read) is apart from building (`_build_sequential`,
`_build_functional`), which takes the config and the groups as plain dicts
of numpy arrays. The builders copy the Keras arrays into the reference's
layout (HWIO kernels; a Dense after a channels-first Flatten has its rows
permuted from CHW to HWC order; LSTM gates reordered to (c, i, f, o)) as
numpy trees and load them through the network's weight bridge,
`from_jax_params`, which makes every move into the port's own layout. What
Keras does not supply keeps the network's constant init: LSTM peepholes
and the Embedding bias are zero.
"""
from __future__ import annotations

import json

import numpy as np

from ..nn.conf.input_type import ConvolutionalInputType, InputType
from ..nn.conf.layers import (ActivationLayer, BatchNormalization,
                              ConvolutionLayer, DenseLayer, DropoutLayer,
                              EmbeddingLayer, GravesLSTM, LossLayer,
                              OutputLayer, SubsamplingLayer, ZeroPaddingLayer)
from ..nn.conf.neural_net_configuration import NeuralNetConfiguration

_ACTIVATION_MAP = {
    "linear": "identity", "relu": "relu", "tanh": "tanh",
    "sigmoid": "sigmoid", "softmax": "softmax", "softplus": "softplus",
    "softsign": "softsign", "hard_sigmoid": "hardsigmoid", "elu": "elu",
}


def _map_activation(name):
    if name not in _ACTIVATION_MAP:
        raise ValueError(f"Unsupported Keras activation '{name}'")
    return _ACTIVATION_MAP[name]


def _h5py():
    """h5py, which reads HDF5 files; an ImportError naming it when it is
    not installed."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading a Keras HDF5 file needs the h5py "
                          "package, which is not installed") from e
    return h5py


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _read_model_file(h5_path):
    """(model config, weight groups) of a file written by Keras's
    model.save()."""
    h5py = _h5py()
    with h5py.File(h5_path, "r") as f:
        cfg = f.attrs["model_config"]
        if isinstance(cfg, bytes):
            cfg = cfg.decode("utf-8")
        model_cfg = json.loads(cfg)
        weights = _read_weight_groups(f["model_weights"]
                                      if "model_weights" in f else f)
    return model_cfg, weights


def _read_weight_groups(g):
    """layer name -> its arrays, in the `weight_names` attribute's order."""
    out = {}
    for lname in g:
        grp = g[lname]
        if "weight_names" in grp.attrs:
            names = [n.decode() if isinstance(n, bytes) else n
                     for n in grp.attrs["weight_names"]]
            out[lname] = [np.asarray(grp[n]) for n in names]
        else:
            out[lname] = [np.asarray(grp[d]) for d in sorted(grp)]
    return out


def import_keras_sequential_model_and_weights(h5_path, device=None):
    """A Sequential model saved by model.save(): the topology from the
    `model_config` attribute, the weights from `model_weights`; a
    MultiLayerNetwork on `device` (None: the card)."""
    model_cfg, weights = _read_model_file(h5_path)
    return _build_sequential(model_cfg, weights, device=device)


importKerasSequentialModelAndWeights = import_keras_sequential_model_and_weights


def import_keras_model_and_weights(h5_path, device=None):
    """A model saved by model.save(): a Sequential model as a
    MultiLayerNetwork, a functional Model (Keras 1 "Model", modern
    "Functional") as a ComputationGraph, on `device` (None: the card)."""
    model_cfg, weights = _read_model_file(h5_path)
    if model_cfg.get("class_name") == "Sequential":
        return _build_sequential(model_cfg, weights, device=device)
    return _build_functional(model_cfg, weights, device=device)


importKerasModelAndWeights = import_keras_model_and_weights


def import_keras_model_configuration(json_path_or_str):
    """The MultiLayerConfiguration of a Sequential topology (a JSON string
    or a file holding one), without weights or a device."""
    s = json_path_or_str
    if not s.lstrip().startswith("{"):
        with open(s, "r", encoding="utf-8") as fh:
            s = fh.read()
    return _build_sequential(json.loads(s), weights=None, conf_only=True)


importKerasModelConfiguration = import_keras_model_configuration


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _pair_of(v, default):
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return (int(v), int(v))
    return tuple(int(x) for x in v)


def _map_layer(cls, cfg, dim_ordering):
    """A Keras layer's config -> (the layer conf, or None for a structural
    layer; whether it is structural)."""
    act = cfg.get("activation", "linear")
    same = (cfg.get("border_mode") or cfg.get("padding", "valid")) == "same"
    if cls == "Dense":
        n_out = cfg.get("output_dim", cfg.get("units"))
        return DenseLayer(n_out=int(n_out),
                          activation=_map_activation(act)), False
    if cls in ("Convolution2D", "Conv2D"):
        n_out = cfg.get("nb_filter", cfg.get("filters"))
        if "nb_row" in cfg:
            kernel = (int(cfg["nb_row"]), int(cfg["nb_col"]))
        else:
            kernel = _pair_of(cfg.get("kernel_size"), (3, 3))
        stride = _pair_of(cfg.get("subsample") or cfg.get("strides"), (1, 1))
        has_bias = bool(cfg.get("use_bias", cfg.get("bias", True)))
        return ConvolutionLayer(
            n_out=int(n_out), kernel_size=kernel, stride=stride,
            convolution_mode=("same" if same else "truncate"),
            activation=_map_activation(act), has_bias=has_bias), False
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        pool = _pair_of(cfg.get("pool_size"), (2, 2))
        return SubsamplingLayer(
            pooling_type="max" if cls.startswith("Max") else "avg",
            kernel_size=pool,
            stride=_pair_of(cfg.get("strides"), pool),
            convolution_mode=("same" if same else "truncate")), False
    if cls == "LSTM":
        n_out = cfg.get("output_dim", cfg.get("units"))
        return GravesLSTM(n_out=int(n_out),
                          activation=_map_activation(act),
                          gate_activation=_map_activation(
                              cfg.get("inner_activation",
                                      cfg.get("recurrent_activation",
                                              "hard_sigmoid"))),
                          forget_gate_bias_init=0.0), False
    if cls == "Embedding":
        return EmbeddingLayer(n_in=int(cfg["input_dim"]),
                              n_out=int(cfg["output_dim"]),
                              activation="identity"), False
    if cls == "BatchNormalization":
        return BatchNormalization(eps=float(cfg.get("epsilon", 1e-5)),
                                  decay=float(cfg.get("momentum", 0.99))), False
    if cls == "Activation":
        return ActivationLayer(activation=_map_activation(act)), False
    if cls == "Dropout":
        # Keras' p / rate is the drop probability; ours the retain one
        p = cfg.get("p", cfg.get("rate", 0.5))
        return DropoutLayer(dropout=1.0 - float(p)), False
    if cls == "ZeroPadding2D":
        pad = cfg.get("padding", (1, 1))
        if isinstance(pad, (list, tuple)) and pad and \
                isinstance(pad[0], (list, tuple)):
            # ((top, bottom), (left, right)): only symmetric pads map onto
            # ZeroPaddingLayer's (ph, pw)
            if pad[0][0] != pad[0][1] or pad[1][0] != pad[1][1]:
                raise ValueError(
                    f"Asymmetric ZeroPadding2D {tuple(map(tuple, pad))} is "
                    f"not supported (top!=bottom or left!=right)")
            pad = (pad[0][0], pad[1][0])
        return ZeroPaddingLayer(pad=_pair_of(pad, (1, 1))), False
    if cls in ("Flatten", "Reshape", "InputLayer"):
        return None, True
    raise ValueError(f"Unsupported Keras layer type '{cls}'")


# Merge layers -> graph vertices (functional models only). Keras 1: one
# "Merge" class with a mode; modern Keras: one class per op.
_MERGE_MODES = {"sum": "add", "add": "add", "mul": "product",
                "ave": "average", "average": "average", "max": "max",
                "sub": "subtract", "subtract": "subtract"}
_MERGE_CLASSES = {"Add": "add", "Multiply": "product", "Average": "average",
                  "Maximum": "max", "Subtract": "subtract"}


def _map_merge(cls, cfg):
    """The graph vertex of a merge layer, else None."""
    from ..nn.conf.graph_vertices import ElementWiseVertex, MergeVertex
    if cls == "Merge":
        mode = cfg.get("mode", "sum")
        if mode in ("concat", "concatenate"):
            return MergeVertex()
        if mode in _MERGE_MODES:
            return ElementWiseVertex(op=_MERGE_MODES[mode])
        raise ValueError(f"Unsupported Keras Merge mode '{mode}'")
    if cls in _MERGE_CLASSES:
        return ElementWiseVertex(op=_MERGE_CLASSES[cls])
    if cls == "Concatenate":
        return MergeVertex()
    return None


def _loss_head(layer):
    """A softmax / sigmoid Dense as an OutputLayer, or such an Activation
    as a LossLayer; anything else unchanged."""
    if layer.activation not in ("softmax", "sigmoid"):
        return layer
    loss = "mcxent" if layer.activation == "softmax" else "xent"
    if isinstance(layer, DenseLayer) and not isinstance(layer, OutputLayer):
        return OutputLayer(n_out=layer.n_out, n_in=layer.n_in,
                           activation=layer.activation, loss_function=loss)
    if isinstance(layer, ActivationLayer):
        return LossLayer(activation=layer.activation, loss_function=loss)
    return layer


# ---------------------------------------------------------------------------
# Weights: Keras arrays -> the reference's layout
# ---------------------------------------------------------------------------

def _chw_rows_to_hwc(W, conv_type):
    """A Dense kernel whose rows a channels-first Flatten ordered (c, h, w),
    with its rows in the (h, w, c) order of ours."""
    c, h, w = conv_type.channels, conv_type.height, conv_type.width
    return (W.reshape(c, h, w, -1).transpose(1, 2, 0, 3)
            .reshape(c * h * w, -1))


def _lstm_arrays(w):
    """(W, RW, b) in our gate order (c, i, f, o), from Keras 1's twelve
    per-gate arrays (i, c, f, o triplets) or the fused three (gates i, f,
    c, o)."""
    if len(w) == 12:
        (Wi, Ui, bi, Wc, Uc, bc, Wf, Uf, bf, Wo, Uo, bo) = w
        return (np.concatenate([Wc, Wi, Wf, Wo], axis=1),
                np.concatenate([Uc, Ui, Uf, Uo], axis=1),
                np.concatenate([bc, bi, bf, bo]))

    def regate(a, axis):
        i, f, c, o = np.split(a, 4, axis=axis)
        return np.concatenate([c, i, f, o], axis=axis)

    return regate(w[0], 1), regate(w[1], 1), regate(w[2], 0)


def _copy_layer(lc, layer, w, params, state, flatten_type=None):
    """Write one Keras layer's arrays `w` into its reference-layout
    parameter dict `params` (and BatchNormalization's running statistics
    into `state`). `flatten_type`: the convolutional type a channels-first
    Flatten before a Dense flattened."""
    cls = lc["class_name"]
    if cls == "Dense":
        W = w[0]
        if flatten_type is not None:
            W = _chw_rows_to_hwc(W, flatten_type)
        params["W"] = W
        params["b"] = np.asarray(w[1]).ravel()
    elif cls in ("Convolution2D", "Conv2D"):
        W = w[0]
        # channels-first files hold OIHW; trust the layer's ordering and
        # fall back to the shape when it names none
        do = lc["config"].get("dim_ordering") or \
            lc["config"].get("data_format")
        th = (do in ("th", "channels_first") if do is not None
              else (W.shape[0] == layer.n_out
                    and W.shape[-1] != layer.n_out))
        params["W"] = W.transpose(2, 3, 1, 0) if th else W   # -> HWIO
        if len(w) > 1:                  # use_bias=False: the kernel alone
            params["b"] = np.asarray(w[1]).ravel()
    elif cls == "LSTM":
        params["W"], params["RW"], params["b"] = _lstm_arrays(w)
    elif cls == "Embedding":
        params["W"] = w[0]
    elif cls == "BatchNormalization":
        params["gamma"], params["beta"] = w[0], w[1]
        state["mean"], state["var"] = w[2], np.abs(w[3])


# ---------------------------------------------------------------------------
# Sequential -> MultiLayerNetwork
# ---------------------------------------------------------------------------

def _input_type_of(first_layer_cfg):
    cfg = first_layer_cfg["config"]
    shape = cfg.get("batch_input_shape")
    dim_ordering = cfg.get("dim_ordering", "tf")
    if shape is None:
        raise ValueError("First layer has no batch_input_shape")
    return _shape_type(shape, dim_ordering), dim_ordering


def _shape_type(shape, dim_ordering):
    dims = list(shape[1:])
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:
        return InputType.recurrent(dims[1])
    if len(dims) == 3:
        if dim_ordering in ("th", "channels_first"):
            c, h, w = dims
        else:
            h, w, c = dims
        return InputType.convolutional(h, w, c)
    raise ValueError(f"Unsupported input shape {shape}")


def _build_sequential(model_cfg, weights, conf_only=False, device=None):
    """A Sequential model config (and its weight groups) -> a
    MultiLayerNetwork on `device`, or with conf_only its configuration."""
    if model_cfg.get("class_name") != "Sequential":
        raise ValueError(
            f"Expected Sequential model, got {model_cfg.get('class_name')} "
            "(functional Model import: use the ComputationGraph path)")
    layer_cfgs = model_cfg["config"]
    if isinstance(layer_cfgs, dict):   # Keras 2: {"layers": [...]}
        layer_cfgs = layer_cfgs["layers"]

    builder = NeuralNetConfiguration.Builder().seed(12345).list()
    input_type, dim_ordering = _input_type_of(layer_cfgs[0])
    mapped = []          # (our layer conf or None, keras config)
    flatten_perm = set()  # our indices of a Dense after a th Flatten
    after_flatten = False
    idx = 0
    for lc in layer_cfgs:
        layer, _ = _map_layer(lc["class_name"], lc["config"], dim_ordering)
        if layer is None:
            after_flatten |= lc["class_name"] == "Flatten"
            mapped.append((None, lc))
            continue
        if after_flatten and isinstance(layer, DenseLayer) \
                and dim_ordering == "th":
            flatten_perm.add(idx)
        after_flatten = False
        builder.layer(idx, layer)
        mapped.append((layer, lc))
        idx += 1

    # a trailing classifier becomes a loss head (Keras keeps the loss in
    # compile(), which model_config does not carry): Dense(softmax), or the
    # Keras 1 idiom Dense(linear) + Activation('softmax')
    last_i = next((i for i in range(len(mapped) - 1, -1, -1)
                   if mapped[i][0] is not None), None)
    if last_i is not None:
        head = _loss_head(mapped[last_i][0])
        builder.layer(idx - 1, head)
        mapped[last_i] = (head, mapped[last_i][1])

    builder.set_input_type(input_type)
    conf = builder.build()
    if conf_only:
        return conf
    from ..nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(conf, device=device).init()
    if weights is None:
        return net
    params, state = net.reference_params(), net.reference_model_state()
    idx, cur_type, flat_type = 0, conf.input_type, None
    for layer, lc in mapped:
        if layer is None:
            if lc["class_name"] == "Flatten" and isinstance(
                    cur_type, ConvolutionalInputType):
                flat_type = cur_type
            continue
        w = weights.get(lc["config"].get("name", ""), [])
        if w:
            _copy_layer(lc, layer, w, params[idx], state[idx],
                        flat_type if idx in flatten_perm else None)
        cur_type = conf.layers[idx].get_output_type(cur_type)
        idx += 1
    return net.from_jax_params(params, state)


# ---------------------------------------------------------------------------
# Functional Model -> ComputationGraph
# ---------------------------------------------------------------------------

def _inbound_names(lc):
    """The names of the layers feeding `lc`, in either dialect: classic
    inbound_nodes = [[[name, node_idx, tensor_idx, ...], ...]]; modern
    inbound_nodes = [{"args": [...]}] holding __keras_tensor__ dicts whose
    keras_history starts with the name."""
    nodes = lc.get("inbound_nodes", [])
    if not nodes:
        return []
    node = nodes[0]
    names = []
    if isinstance(node, dict):
        def collect(obj):
            if isinstance(obj, dict):
                if obj.get("class_name") == "__keras_tensor__":
                    names.append(obj["config"]["keras_history"][0])
                else:
                    for v in obj.values():
                        collect(v)
            elif isinstance(obj, (list, tuple)):
                for v in obj:
                    collect(v)
        collect(node.get("args", []))
        return names
    return [entry[0] for entry in node]


def _ref_names(refs):
    """[[name, 0, 0], ...] or [name, 0, 0] -> [name, ...]"""
    if refs and isinstance(refs[0], str):
        refs = [refs]
    return [r[0] for r in refs]


def _build_functional(model_cfg, weights, device=None):
    """A functional Model config (and its weight groups) -> a
    ComputationGraph on `device`. Flatten / Reshape dissolve into name
    aliases (the graph builder inserts the CNN-to-dense preprocessors);
    merge layers become vertices; an output Dense with softmax / sigmoid
    becomes an OutputLayer."""
    cls_name = model_cfg.get("class_name")
    if cls_name not in ("Model", "Functional"):
        raise ValueError(f"Expected functional Model, got {cls_name}")
    cfg = model_cfg["config"]
    layer_cfgs = cfg["layers"]
    output_names = set(_ref_names(cfg.get("output_layers", [])))

    dim_ordering = "tf"
    for lc in layer_cfgs:
        do = lc["config"].get("dim_ordering") or lc["config"].get("data_format")
        if do:
            dim_ordering = do
            break
    th = dim_ordering in ("th", "channels_first")

    gb = NeuralNetConfiguration.Builder().seed(12345).graph_builder()
    alias = {}              # keras name -> the vertex or input it resolves to
    input_types, input_names = [], []
    mapped = []             # (vertex name, our layer conf, keras config)
    dense_after_flatten, flatten_sources = set(), set()
    for lc in layer_cfgs:
        cls, kcfg = lc["class_name"], lc["config"]
        name = kcfg.get("name") or lc.get("name")
        inputs = [alias.get(n, n) for n in _inbound_names(lc)]
        if cls == "InputLayer":
            shape = kcfg.get("batch_input_shape") or kcfg.get("batch_shape")
            if shape is None:
                raise ValueError(
                    "InputLayer has no batch_input_shape/batch_shape")
            input_names.append(name)
            input_types.append(_shape_type(shape, dim_ordering))
            gb.add_inputs(name)
            alias[name] = name
            continue
        merge = _map_merge(cls, kcfg)
        if merge is not None:
            gb.add_vertex(name, merge, *inputs)
            alias[name] = name
            continue
        layer, structural = _map_layer(cls, kcfg, dim_ordering)
        if structural or layer is None:
            alias[name] = inputs[0]
            if cls == "Flatten":
                flatten_sources.add(inputs[0])
            continue
        if name in output_names and isinstance(layer, DenseLayer):
            layer = _loss_head(layer)
        if (isinstance(layer, DenseLayer) and inputs
                and inputs[0] in flatten_sources and th):
            dense_after_flatten.add(name)
        gb.add_layer(name, layer, *inputs)
        alias[name] = name
        mapped.append((name, layer, lc))

    gb.set_outputs(*[alias.get(n, n)
                     for n in _ref_names(cfg.get("output_layers", []))])
    in_order = _ref_names(cfg.get("input_layers", [])) or input_names
    gb.set_input_types(*[input_types[input_names.index(n)]
                         for n in in_order])
    conf = gb.build()
    from ..nn.graph import ComputationGraph
    net = ComputationGraph(conf, device=device).init()
    if weights is None:
        return net
    params, state = net.reference_params(), net.reference_model_state()
    types = getattr(conf, "vertex_output_types", {})
    for name, layer, lc in mapped:
        w = weights.get(name, [])
        if not w:
            continue
        flat_type = None
        if name in dense_after_flatten:
            t = types.get(conf.vertices[name].inputs[0])
            if isinstance(t, ConvolutionalInputType):
                flat_type = t
        _copy_layer(lc, layer, w, params[name], state[name], flat_type)
    return net.from_jax_params(params, state)


def dim_ordering_of(lc):
    """A Keras layer config's `dim_ordering` ("tf" when it names none)."""
    return lc["config"].get("dim_ordering", "tf")
