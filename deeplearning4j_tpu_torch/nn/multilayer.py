"""MultiLayerNetwork, the sequential container: port of
deeplearning4j_tpu/nn/multilayer.py (`init`, `fit`, `output`,
`feed_forward`, `score`, `compute_gradient_and_score`, `params`,
`set_params`, `num_params`, `clone`), and `Network`, what it shares with
`nn.graph.ComputationGraph`.

A container is an `nn.Module` of per-layer slots: the parameters, held as
f32 masters in the port's layout (convolution kernels OIHW), and the
layers' state as buffers (BatchNorm's running mean and var). Each forward
casts the parameters and the input to the compute type (`data_type`:
float32, bfloat16 or float64), so the gradients flow back to the f32
masters. A `fit` step is: the loss (the output layer's per-example loss,
mean in f32, plus the L1/L2 terms of the masters), its gradients by
autograd, then each layer's updater with its own state and learning-rate
schedule, in f32 (`updater.updaters.apply_layer`); then the layers' new
state. Where the reference compiles that step into one XLA program, the
port runs it eagerly: cuDNN and cuBLAS for the convolutions and products,
and `torch.autograd.Function`s for the reference's two hand-derived
backwards (`_BNTrain`, `_MaxPoolGather`).

The public API speaks the reference's terms: numpy inputs and outputs,
images NHWC (the port runs them as NCHW in the channels_last memory
format, the same bytes), and `params()` / `set_params()` /
`from_jax_params()` / the model zip in the reference's layout (HWIO
kernels) and flat order (`_param_sort_key`).

Recurrent layers carry their state (h, c) through `forward_with_carry`.
With `backprop_type="tbptt"` a `fit` step is truncated BPTT: the time axis
is cut into `tbptt_fwd_length` segments (the last one short when the
length does not divide T), one updater step per segment, the carries
handed on between segments detached, so no gradient crosses a segment
boundary and memory does not grow with T. `rnn_time_step` streams: the
carries stay on the network between calls until `rnn_clear_previous_state`.

`fit` also takes a DataSetIterator: the batches are staged onto the
network's device by `datasets.iterators.AsyncDataSetIterator` while the
previous step runs (a bf16 feature wire for bf16 networks), with the
reference's epoch semantics. `evaluate` / `evaluate_regression` score an
iterator through the same staging; `make_inference_fn` is the pure
inference step `serving.InferenceServer` runs.

Entry points run on the CUDA card unless the caller passes device="cpu";
on the card float32 networks run with TF32 off (`card_numerics`).

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
item): `fused_steps` (with it the fused TBPTT route), `training_health`,
listeners, `pretrain`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import obs
from ..common.device import card_numerics, resolve_device, to_port, to_public
from ..datasets.dataset import DataSet
from ..datasets.iterators import (AsyncDataSetIterator, DataSetIterator,
                                  ListDataSetIterator, next_processed,
                                  wrap_async_for_fit)
from .conf.layers.recurrent import BaseRecurrentLayer
from .conf.neural_net_configuration import MultiLayerConfiguration
from .updater import updaters as U

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}


def not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet: ROADMAP.md "
        f"queue 1 item {item}")


def _param_sort_key(k):
    # canonical variable order: W-like first, then recurrent, then biases
    order = {"W": 0, "RW": 1, "b": 2, "gamma": 0, "beta": 1, "mean": 2, "var": 3,
             "vb": 3}
    return (order.get(k, 9), k)


def mean_score(per_example):
    """The mean of the per-example losses, in f32 at least."""
    if per_example.dtype in (torch.bfloat16, torch.float16):
        per_example = per_example.float()
    return per_example.mean()


class _Slot(nn.Module):
    """One layer's parameters (f32 masters, the port's layout) and state
    buffers."""

    def __init__(self, params, state):
        super().__init__()
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params.items()})
        for k, v in state.items():
            self.register_buffer(k, v)

    def state(self):
        return dict(self.named_buffers(recurse=False))


class Network(nn.Module):
    """What both containers share: parameters and state, the training
    step, the flat parameters and the reference's layouts.

    A subclass names its layers by key (MultiLayerNetwork: the index;
    ComputationGraph: the vertex name) in the flat-parameter order
    (`_keyed_layers`), and says how the reference nests per-layer trees
    (`_tree`: a list or a name-keyed dict)."""

    def __init__(self, conf, device=None):
        super().__init__()
        self.conf = conf
        dt = str(conf.global_conf.get("data_type", "float32"))
        self.compute_dtype = _COMPUTE_DTYPES.get(dt, torch.float32)
        self.param_dtype = torch.float64 if dt == "float64" else torch.float32
        self._device = resolve_device(device)
        self._seed = int(conf.global_conf.get("seed", 123))
        # dropout's random bits (the reference draws them from its PRNG key)
        self._dropout_gen = torch.Generator(self._device).manual_seed(
            self._seed)
        self.slots = None
        self._pos = None
        self._updater_state = None   # key -> param -> state name -> tensor
        self._score = None
        self._rnn_state = None       # rnn_time_step's carries, per layer

    # -- what a subclass provides ------------------------------------------
    def _keyed_layers(self):
        raise NotImplementedError

    def _tree(self, by_key):
        raise NotImplementedError

    def _untree(self, tree):
        raise NotImplementedError

    def _time_steps(self, batch):
        """(T, batch size) of a device batch of sequences."""
        raise NotImplementedError

    def _segment(self, batch, t0, length):
        """The TBPTT segment [t0, t0 + length) of a device batch."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    @property
    def device(self):
        return self._device

    def init(self, parameters=None):
        """Draw the weights (a torch.Generator seeded from the conf's seed,
        on the CPU, so every device gets the same ones) and zero the
        updater state."""
        if self.slots is None:
            gen = torch.Generator().manual_seed(self._seed)
            keyed = self._keyed_layers()
            self._pos = {key: i for i, (key, _) in enumerate(keyed)}
            self.slots = nn.ModuleList(
                _Slot(layer.init_params(gen, self.param_dtype),
                      layer.init_state()) for _, layer in keyed
            ).to(self._device)
            sd = self.conf.global_conf.get("updater_state_dtype")
            self._updater_state = {}
            for key, layer in keyed:
                init_fn, _ = U.get(layer.updater or "sgd")
                self._updater_state[key] = U.cast_updater_state(
                    {k: init_fn(p.detach())
                     for k, p in self._slot(key).params.items()}, sd)
        if parameters is not None:
            self.set_params(parameters)
        return self

    def _ensure_init(self):
        if self.slots is None:
            self.init()

    def _slot(self, key):
        return self.slots[self._pos[key]]

    def _cast_params(self):
        """Every layer's parameters in the compute type (a no-op for f32;
        gradients flow back to the masters)."""
        cdt = self.compute_dtype
        return {key: {k: p.to(cdt) for k, p in self._slot(key).params.items()}
                for key, _ in self._keyed_layers()}

    def _states(self):
        return {key: self._slot(key).state() for key, _ in self._keyed_layers()}

    @property
    def _params(self):
        """Every layer's parameters (the f32 masters, the port's layout),
        keyed as the forward takes them; with `_model_state`, what
        `serving.InferenceServer` reads at build and at each swap."""
        self._ensure_init()
        return {key: dict(self._slot(key).params)
                for key, _ in self._keyed_layers()}

    @property
    def _model_state(self):
        self._ensure_init()
        return self._states()

    def _step(self, batch):
        """num_iterations optimizer steps on one device batch, or with
        truncated BPTT one step per segment."""
        if self.conf.backprop_type == "tbptt":
            return self._fit_tbptt(batch)
        for _ in range(int(self.conf.global_conf.get("num_iterations", 1))):
            with obs.TRACER.span("train.dispatch", cat="train"):
                self._train_step(lambda rng: self._loss(*batch, True, rng))

    def _init_carries(self, batch_size):
        """Every recurrent layer's zero carry, by key, in the compute type
        (the reference's choice: a recurrent forward returns its carry in
        the compute type)."""
        return {key: layer.init_carry(batch_size, self.compute_dtype,
                                      self._device)
                for key, layer in self._keyed_layers()
                if isinstance(layer, BaseRecurrentLayer)}

    def _fit_tbptt(self, batch):
        """Truncated BPTT over one device batch: one updater step per
        `tbptt_fwd_length` segment, iteration_count advanced per segment,
        the recurrent state carried across segments without its gradient
        (each segment starts from detached carries)."""
        T, n = self._time_steps(batch)
        L = int(self.conf.tbptt_fwd_length)
        carries = self._init_carries(n)
        for t0 in range(0, T, L):
            seg = self._segment(batch, t0, L)
            with obs.TRACER.span("train.dispatch", cat="train", tbptt=True):
                carries = _detached(self._train_step(
                    lambda rng: self._loss(*seg, True, rng, carries)))

    def _fit_iterator(self, it, num_epochs):
        """fit over an iterator, with the reference's epoch semantics: a
        plain iterator the caller hands in may be mid-stream, so it is reset
        BEFORE wrapping (the fresh wrapper prefetches from position 0 and
        needs no reset in epoch 0); an AsyncDataSetIterator the caller built
        resets every epoch."""
        wrapped_here = not isinstance(it, AsyncDataSetIterator)
        if wrapped_here:
            it.reset()
        async_it = wrap_async_for_fit(it, self.compute_dtype,
                                      device=self._device)
        for epoch in range(num_epochs):
            if epoch > 0 or not wrapped_here or not async_it.has_next():
                async_it.reset()
            while async_it.has_next():
                self._step(self._batch(self._dataset(
                    next_processed(async_it))))
            self.conf.epoch_count += 1
        return self

    def _eval_batches(self, data):
        """The batches of `data` (a DataSet, an iterator, or a list of
        batches) for evaluation: an iterator is reset (the full pass) and
        staged onto the device ahead of the forward."""
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        if isinstance(data, DataSetIterator):
            data.reset()
            data = wrap_async_for_fit(data, self.compute_dtype,
                                      device=self._device)
        return data

    def _reg_score(self):
        total = 0.0
        for key, layer in self._keyed_layers():
            total = total + layer.reg_score(dict(self._slot(key).params))
        return total

    def _grads(self, score):
        """{key: {param name: gradient}} of `score` for the masters."""
        leaves = [(key, k, p) for key, _ in self._keyed_layers()
                  for k, p in self._slot(key).params.items()]
        grads = torch.autograd.grad(score, [p for _, _, p in leaves],
                                    allow_unused=True, materialize_grads=True)
        out = {key: {} for key, _ in self._keyed_layers()}
        for (key, k, _), g in zip(leaves, grads):
            out[key][k] = g
        return out

    def _train_step(self, loss_fn):
        """One optimizer step on the loss `loss_fn(rng)` -> (score, new
        layer state, new carries). Returns the new carries."""
        with card_numerics(self._device, self.compute_dtype):
            score, new_state, new_carries = loss_fn(self._dropout_gen)
            grads = self._grads(score)
            minimize = self.conf.global_conf.get("minimize", True)
            it = self.conf.iteration_count
            for key, layer in self._keyed_layers():
                self._updater_state[key] = U.apply_layer(
                    layer, dict(self._slot(key).params), grads[key],
                    self._updater_state[key], it, minimize)
            self._store_state(new_state)
        self._score = score.detach()
        self.conf.iteration_count += 1
        return new_carries

    @torch.no_grad()
    def _store_state(self, new_state):
        for key, st in new_state.items():
            slot = self._slot(key)
            for name, v in st.items():
                buf = getattr(slot, name)
                if v is not buf:
                    buf.copy_(v)

    def score(self, data=None, training=False):
        """The score (loss plus L1/L2 terms) of the last fit step, or of
        `data` (as `fit` takes it)."""
        if data is None:
            return (float(self._score) if self._score is not None
                    else float("nan"))
        self._ensure_init()
        batch = self._batch(self._dataset(data))
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            s, *_ = self._loss(*batch, training,
                               self._dropout_gen if training else None)
        return float(s)

    def _gradient_and_score(self, batch, train):
        """(gradients as the reference nests its parameters, in the port's
        layout; score). Dropout draws from a generator seeded 0, as the
        reference uses PRNGKey(0)."""
        self._ensure_init()
        with card_numerics(self._device, self.compute_dtype):
            score, *_ = self._loss(
                *batch, train, torch.Generator(self._device).manual_seed(0))
            grads = self._grads(score)
        return self._tree(grads), float(score.detach())

    # ------------------------------------------------------------------
    # Flat parameters, in the reference's layout and order
    # ------------------------------------------------------------------
    def _param_leaves(self):
        leaves = []
        for key, layer in self._keyed_layers():
            p = self._slot(key).params
            for k in sorted(p.keys(), key=_param_sort_key):
                leaves.append((key, k, layer, p[k]))
        return leaves

    def params(self):
        """The flat parameter vector (f32, or f64 for float64 networks), as
        the reference's `params()`."""
        self._ensure_init()
        vecs = [layer.to_reference(k, p.detach()).cpu().reshape(-1)
                for _, k, layer, p in self._param_leaves()]
        if not vecs:
            return np.zeros((0,), np.float32)
        return torch.cat(vecs).numpy()

    @torch.no_grad()
    def set_params(self, flat):
        """Load a flat vector in the reference's layout and order."""
        self._ensure_init()
        flat = torch.tensor(np.asarray(flat).ravel())
        offset = 0
        for _, k, layer, p in self._param_leaves():
            ref_shape = layer.to_reference(k, p).shape
            n = p.numel()
            if offset + n > flat.numel():
                raise ValueError(f"Expected {self.num_params()} params, "
                                 f"got {flat.numel()}")
            chunk = flat[offset:offset + n].reshape(ref_shape)
            p.copy_(layer.from_reference(k, chunk))
            offset += n
        if offset != flat.numel():
            raise ValueError(f"Expected {offset} params, got {flat.numel()}")

    def num_params(self):
        self._ensure_init()
        return int(sum(p.numel() for *_, p in self._param_leaves()))

    def flatten_gradients(self, grads):
        """A gradient tree (`compute_gradient_and_score`) as one float64
        vector in the flat-parameter layout and order."""
        grads = self._untree(grads)
        vecs = [layer.to_reference(k, grads[key][k].detach()).double().cpu()
                .reshape(-1) for key, k, layer, _ in self._param_leaves()]
        return torch.cat(vecs).numpy() if vecs else np.zeros((0,))

    # ------------------------------------------------------------------
    # The reference's per-layer trees (weight bridge and model zips)
    # ------------------------------------------------------------------
    def reference_updater_state(self):
        """The updater state as the reference nests it (per layer: param
        name -> state name -> numpy array), in its layout."""
        self._ensure_init()
        out = {}
        for key, layer in self._keyed_layers():
            out[key] = {k: {s: _to_numpy(layer.to_reference(k, t)
                                         if t.ndim else t)
                            for s, t in st.items()}
                        for k, st in self._updater_state[key].items()}
        return self._tree(out)

    def reference_model_state(self):
        """The layers' state (BatchNorm's running mean and var) as the
        reference nests it."""
        self._ensure_init()
        return self._tree({key: {n: _to_numpy(b) for n, b in
                                 self._slot(key).state().items()}
                           for key, _ in self._keyed_layers()})

    @torch.no_grad()
    def load_reference_updater_state(self, tree):
        self._ensure_init()
        tree = self._untree(tree)
        for key, layer in self._keyed_layers():
            for k, st in self._updater_state[key].items():
                for s, t in st.items():
                    a = torch.tensor(np.asarray(tree[key][k][s]))
                    if t.ndim:
                        a = layer.from_reference(k, a)
                    st[s] = a.to(device=t.device, dtype=t.dtype).contiguous(
                        memory_format=_memory_format(t))

    @torch.no_grad()
    def load_reference_model_state(self, tree):
        self._ensure_init()
        tree = self._untree(tree)
        for key, _ in self._keyed_layers():
            for n, b in self._slot(key).state().items():
                b.copy_(torch.tensor(np.asarray(tree[key][n])))

    @torch.no_grad()
    def from_jax_params(self, params, model_state=None, updater_state=None):
        """The weight bridge: load the reference's per-layer trees (its
        `_params`, `_model_state` and `_updater_state`, as numpy arrays:
        a list per layer for MultiLayerNetwork, a name-keyed dict for
        ComputationGraph). Every layout move happens here: HWIO kernels
        become OIHW; dense weights after a CNN-to-dense preprocessor keep
        their (h, w, c) row order, which the port's NHWC-order flatten
        reads as it is. Returns self."""
        self._ensure_init()
        params = self._untree(params)
        for key, layer in self._keyed_layers():
            for k, p in self._slot(key).params.items():
                a = torch.tensor(np.asarray(params[key][k]))
                p.copy_(layer.from_reference(k, a))
        if model_state is not None:
            self.load_reference_model_state(model_state)
        if updater_state is not None:
            self.load_reference_updater_state(updater_state)
        return self

    # ------------------------------------------------------------------
    def clone(self):
        net = type(self)(self.conf.clone(), device=self._device)
        if self.slots is not None:
            net.init()
            net.load_state_dict(self.state_dict())
            net._updater_state = {
                key: {k: {s: t.clone() for s, t in st.items()}
                      for k, st in per.items()}
                for key, per in self._updater_state.items()}
        return net

    def rnn_clear_previous_state(self):
        """Forget the state `rnn_time_step` carries between calls."""
        self._rnn_state = None

    rnnClearPreviousState = rnn_clear_previous_state

    # -- not ported yet ------------------------------------------------
    def fused_steps(self, k=8):
        raise not_ported("fused_steps", 17)

    def training_health(self, *args, **kwargs):
        raise not_ported("training_health", 17)

    def set_listeners(self, *listeners):
        raise not_ported("listeners", 16)


def _detached(carries):
    """Carries (key -> name -> tensor) cut from the autograd graph."""
    return {key: {n: t.detach() for n, t in c.items()}
            for key, c in carries.items()}


def _to_numpy(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _host(a):
    """A label or mask array of a (possibly staged) batch as numpy."""
    return _to_numpy(a) if isinstance(a, torch.Tensor) else a


def _memory_format(t):
    if t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class MultiLayerNetwork(Network):
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__(conf, device)
        self.layers = conf.layers

    def _keyed_layers(self):
        return list(enumerate(self.layers))

    def _tree(self, by_key):
        return [by_key[i] for i in range(len(self.layers))]

    def _untree(self, tree):
        return dict(enumerate(tree))

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _apply_layers(self, params, state, x, *, train, rng, fmask=None,
                      upto=None, carries=None):
        """Forward through layers [0, upto) -> (activations, new state,
        new carries). With `carries` (index -> carry), each recurrent layer
        starts from its carry; without, from zero, and new carries is
        None."""
        n = len(self.layers) if upto is None else upto
        acts = []
        new_state = dict(state)
        new_carries = dict(carries) if carries is not None else None
        for i in range(n):
            layer = self.layers[i]
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i].pre_process(x)
            if isinstance(layer, BaseRecurrentLayer) and carries is not None:
                x, new_carries[i] = layer.forward_with_carry(
                    params[i], x, carries[i], train=train, rng=rng,
                    mask=fmask)
            elif layer.has_state():
                x, new_state[i] = layer.forward_with_state(
                    params[i], x, state[i], train=train, rng=rng, mask=fmask)
            else:
                x = layer.forward(params[i], x, train=train, rng=rng,
                                  mask=fmask)
            acts.append(x)
        return acts, new_state, new_carries

    def _input(self, x):
        x = to_port(x, self._device)
        return x.to(self.compute_dtype) if x.is_floating_point() else x

    def _output_layer_input(self, params, state, x, *, train, rng,
                            fmask=None, carries=None):
        """(h, new state, new carries, acts): the output layer's input
        after its preprocessor, and the interior activations."""
        i = len(self.layers) - 1
        acts, new_state, new_carries = self._apply_layers(
            params, state, x, train=train, rng=rng, fmask=fmask, upto=i,
            carries=carries)
        h = acts[-1] if acts else x
        if i in self.conf.preprocessors:
            h = self.conf.preprocessors[i].pre_process(h)
        return h, new_state, new_carries, acts

    def _loss(self, features, labels, fmask, lmask, train, rng,
              carries=None):
        """(score, new layer state, new carries)."""
        params = self._cast_params()
        h, new_state, new_carries, _ = self._output_layer_input(
            params, self._states(), features, train=train, rng=rng,
            fmask=fmask, carries=carries)
        i = len(self.layers) - 1
        per_ex = self.layers[i].compute_score_per_example(
            params[i], h, labels, train=train, rng=rng, mask=lmask)
        return mean_score(per_ex) + self._reg_score(), new_state, new_carries

    def _time_steps(self, batch):
        return int(batch[0].shape[1]), int(batch[0].shape[0])

    def _segment(self, batch, t0, length):
        features, labels, fmask, lmask = batch
        cut = slice(t0, t0 + length)
        return (features[:, cut],
                labels[:, cut] if labels.ndim >= 3 else labels,
                None if fmask is None else fmask[:, cut],
                None if lmask is None else lmask[:, cut])

    def _batch(self, ds):
        dev = self._device
        return (self._input(ds.features), to_port(ds.labels, dev),
                None if ds.features_mask is None
                else to_port(ds.features_mask, dev),
                None if ds.labels_mask is None
                else to_port(ds.labels_mask, dev))

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, features_mask=None, labels_mask=None,
            num_epochs=1):
        """Train on one DataSet (or arrays `data`, `labels`, or a tuple of
        them), num_epochs steps of it; or on a DataSetIterator, num_epochs
        passes over it."""
        self._ensure_init()
        if labels is not None:
            data = DataSet(data, labels, features_mask, labels_mask)
        if isinstance(data, DataSetIterator):
            return self._fit_iterator(data, num_epochs)
        batch = self._batch(self._dataset(data))
        for _ in range(num_epochs):
            self._step(batch)
        return self

    @staticmethod
    def _dataset(data):
        """A DataSet (or a tuple of its arrays) as a DataSet."""
        if isinstance(data, tuple):
            data = DataSet(*data)
        if not isinstance(data, DataSet):
            raise TypeError(f"Cannot fit on {type(data)}")
        return data

    def pretrain(self, *args, **kwargs):
        raise not_ported("layerwise pretraining", "18b")


    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    def _forward_out(self, params, state, x, *, train, rng, fmask=None):
        h, _, _, _ = self._output_layer_input(params, state, x, train=train,
                                              rng=rng, fmask=fmask)
        return self._head(params, state, h, train=train, rng=rng)

    def _head(self, params, state, h, *, train, rng):
        """The output layer's activations for its input `h`."""
        i = len(self.layers) - 1
        layer = self.layers[i]
        if layer.has_state():
            return layer.forward_with_state(params[i], h, state[i],
                                            train=train, rng=rng)[0]
        return layer.forward(params[i], h, train=train, rng=rng)

    def output(self, x, train=False, features_mask=None):
        """The output layer's activations for `x`, as numpy."""
        self._ensure_init()
        x = self._input(x)
        fmask = (None if features_mask is None
                 else to_port(features_mask, self._device))
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            out = self._forward_out(self._cast_params(), self._states(), x,
                                    train=train, fmask=fmask,
                                    rng=self._dropout_gen if train else None)
        return to_public(out)

    def rnn_time_step(self, x):
        """Streaming inference: x [B, F] is one time step, [B, T, F] a
        run of them; returns the output with the same time rank, as numpy.
        Each recurrent layer starts from the state the previous call left
        (zero after `rnn_clear_previous_state`) and keeps its new one."""
        self._ensure_init()
        x = self._input(x)
        single = x.ndim == 2
        if single:
            x = x[:, None, :]
        if self._rnn_state is None:
            self._rnn_state = self._init_carries(int(x.shape[0]))
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            params, state = self._cast_params(), self._states()
            h, _, self._rnn_state, _ = self._output_layer_input(
                params, state, x, train=False, rng=None,
                carries=self._rnn_state)
            out = self._head(params, state, h, train=False, rng=None)
        return to_public(out[:, 0] if single else out)

    rnnTimeStep = rnn_time_step

    def make_inference_fn(self):
        """The pure inference step `(params, state, x) -> out` that
        `serving.InferenceServer` runs per padding bucket: `params` in the
        compute type (the server casts the masters once, at build and at
        each swap), `state` the layers' state, `x` a batch in the public
        layout (numpy or a tensor); the output stays on the device.
        train=False, so no randomness reaches the math: two calls with the
        same arguments give the same bits on a deterministic backend.
        Params are arguments, so a hot swap is a new argument."""
        self._ensure_init()

        def infer(params, state, x):
            with torch.no_grad(), card_numerics(self._device,
                                                self.compute_dtype):
                return self._forward_out(params, state, self._input(x),
                                         train=False, rng=None)

        return infer

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    def evaluate(self, data, meta=None):
        """Classification statistics (`eval.Evaluation`) over a DataSet or
        an iterator (reset first, staged through AsyncDataSetIterator).
        `meta`: optional per-example metadata over all examples in
        iteration order (or each batch's `example_metas`), for
        Evaluation's error-analysis queries."""
        from ..eval.evaluation import Evaluation
        ev = Evaluation()
        pos = 0
        for ds in self._eval_batches(data):
            out = self.output(ds.features, features_mask=ds.features_mask)
            batch_meta = getattr(ds, "example_metas", None)
            if batch_meta is None and meta is not None:
                batch_meta = meta[pos:pos + ds.num_examples()]
            pos += ds.num_examples()
            ev.eval(_host(ds.labels), out, mask=_host(ds.labels_mask),
                    meta=batch_meta)
        return ev

    def evaluate_regression(self, data):
        """Regression statistics (`eval.RegressionEvaluation`), as
        `evaluate`."""
        from ..eval.regression import RegressionEvaluation
        ev = None
        for ds in self._eval_batches(data):
            out = self.output(ds.features, features_mask=ds.features_mask)
            if ev is None:
                ev = RegressionEvaluation(int(ds.labels.shape[-1]))
            ev.eval(_host(ds.labels), out)
        return ev

    def feed_forward(self, x, train=False):
        """The input, then every layer's activations, as numpy."""
        self._ensure_init()
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            acts, _, _ = self._apply_layers(
                self._cast_params(), self._states(), self._input(x),
                train=train, rng=self._dropout_gen if train else None)
        return [np.asarray(x)] + [to_public(a) for a in acts]


    # ------------------------------------------------------------------
    # Score / gradients
    # ------------------------------------------------------------------
    def compute_gradient_and_score(self, features, labels, fmask=None,
                                   lmask=None, train=True):
        """(gradients, score): the gradients as the reference nests its
        parameters (a list of per-layer dicts), in the port's layout
        (`flatten_gradients` gives the reference's flat vector)."""
        return self._gradient_and_score(
            self._batch(DataSet(features, labels, fmask, lmask)), train)
