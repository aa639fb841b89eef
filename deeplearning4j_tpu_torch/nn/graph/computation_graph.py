"""ComputationGraph, the DAG container: port of
deeplearning4j_tpu/nn/graph/computation_graph.py (`init`, `fit`,
`output`, `feed_forward`, `score`, `compute_gradient_and_score`, the flat
parameters, `clone`).

The forward walks the configuration's topological order over layers and
vertices; the loss sums, over the output layers, the mean of each one's
per-example loss (the head recomputed on its input, as the reference),
plus the L1/L2 terms. Parameters, state, the training step and the
reference's layouts are `multilayer.Network`'s: f32 masters in the port's
layout, a cast to the compute type per forward, updates in f32, NHWC
numpy at the API. The flat parameters follow the layer vertices in
topological order; the per-layer trees of the reference (its
`_params`, `_updater_state`, `_model_state`) are dicts keyed by vertex
name.

`fit` over an iterator of DataSets or MultiDataSets, `evaluate`,
`make_inference_fn`, truncated BPTT and `rnn_time_step` are
`MultiLayerNetwork`'s, over the graph's inputs and outputs: a recurrent
layer vertex carries its state by vertex name; a TBPTT segment slices the
sequence inputs, labels and masks and passes static ones whole.

Listeners, `make_flat_score_fn` and `_last_batch_size` are
`multilayer.Network`'s (the reference's graph has `set_listeners` but no
`add_listener`); `get_layer(name)` is the vertex's layer configuration.

`fused_steps(K)` and `training_health` are `multilayer.Network`'s: a fused
group stacks the multi-input feature dicts and multi-output label lists
leaf by leaf, over an iterator of DataSets or MultiDataSets (or any object
with has_next()/next()), and fuses K full TBPTT segments of a sequence.

`remat_segments=True` recomputes the training forward in segments that
end at the element-wise (residual-add) vertices, as the reference's
`jax.checkpoint` segments do: each segment but the last runs under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`, so only the
segment boundaries' activations are kept for the backward. It wraps only
the training loss's forward without masks or carries; inference and
inspection keep every activation. BatchNorm's new running statistics are
the first forward's outputs (the recompute's are discarded). Dropout draws
from the network's one generator, whose state checkpoint does not keep and
which cannot be read on the host inside a CUDA graph capture (a fused
group): a segment's keep masks are drawn in its first forward, in the
plain path's order, and its recompute reuses them (`_DropoutTape`).
Inside ParallelWrapper's tensor-parallel step it raises, naming both.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ...common.device import card_numerics, to_port, to_public
from ...datasets.dataset import DataSet, MultiDataSet
from ...datasets.iterators import DataSetIterator
from ...optimize import profiler as P
from ..conf.computation_graph_configuration import ComputationGraphConfiguration
from ..conf.graph_vertices import ElementWiseVertex
from ..conf.layers.base import DropoutTape
from ..conf.layers.recurrent import BaseRecurrentLayer
from ..multilayer import Network, _host, mean_score


class ComputationGraph(Network):
    def __init__(self, conf: ComputationGraphConfiguration,
                 remat_segments=False, device=None):
        super().__init__(conf, device)
        self._remat = bool(remat_segments)
        self._remat_plan_cache = None

    def _layer_names(self):
        """Layer vertices in topological order (the flat-parameter order)."""
        return [n for n in self.conf.topological_order
                if self.conf.vertices[n].is_layer]

    def _keyed_layers(self):
        return [(n, self.conf.vertices[n].conf) for n in self._layer_names()]

    def _tree(self, by_key):
        return dict(by_key)

    def _untree(self, tree):
        return dict(tree)

    # ------------------------------------------------------------------
    # Forward: per vertex in topological order
    # ------------------------------------------------------------------
    def _apply_graph(self, params, state, inputs, *, train, rng,
                     fmasks=None, carries=None, allow_remat=False):
        """inputs: input name -> tensor (compute type); carries: layer
        name -> carry (TBPTT, `rnn_time_step`), or None for zero carries.
        Returns (activations incl. inputs, new state, masks, new carries;
        None without `carries`). `allow_remat` (the training loss only)
        takes the segment-recompute forward when the graph was built with
        `remat_segments=True`."""
        if (self._remat and allow_remat and train
                and torch.is_grad_enabled() and carries is None
                and not (fmasks and any(m is not None
                                        for m in fmasks.values()))):
            return self._apply_graph_remat(params, state, inputs, rng=rng)
        acts = dict(inputs)
        masks = {n: (fmasks.get(n) if fmasks else None) for n in inputs}
        new_state = dict(state)
        new_carries = dict(carries) if carries is not None else None
        for name in self.conf.topological_order:
            spec = self.conf.vertices[name]
            in_acts = [acts[i] for i in spec.inputs]
            in_masks = [masks.get(i) for i in spec.inputs]
            out, st, c = self._forward_vertex(
                spec, params.get(name), in_acts, in_masks, train=train,
                rng=rng, state_entry=state.get(name),
                carry_entry=(carries.get(name) if carries is not None
                             else None))
            if st is not None:
                new_state[name] = st
            if c is not None:
                new_carries[name] = c
            if spec.is_layer:
                masks[name] = (in_masks[0] if _keeps_time_axis(spec.conf)
                               else None)
            else:
                masks[name] = spec.conf.output_mask(in_masks)
            acts[name] = out
        return acts, new_state, masks, new_carries

    def _forward_vertex(self, spec, p, in_acts, in_masks, *, train, rng,
                        state_entry=None, carry_entry=None):
        """One vertex's forward, shared by `_apply_graph` and the remat
        segments so the two cannot drift. Returns (out, new state or None,
        new carry or None)."""
        if not spec.is_layer:
            return (spec.conf.forward(in_acts, masks=in_masks, train=train,
                                      rng=rng), None, None)
        layer = spec.conf
        x = in_acts[0]
        if spec.preprocessor is not None:
            x = spec.preprocessor.pre_process(x)
        if isinstance(layer, BaseRecurrentLayer) and carry_entry is not None:
            out, c = layer.forward_with_carry(p, x, carry_entry, train=train,
                                              rng=rng, mask=in_masks[0])
            return out, None, c
        if layer.has_state():
            out, st = self._layer_forward(spec.name, layer, p, x, train=train,
                                          rng=rng, mask=in_masks[0],
                                          state=state_entry)
            return out, st, None
        return (self._layer_forward(spec.name, layer, p, x, train=train,
                                    rng=rng, mask=in_masks[0]), None, None)

    def _remat_plan(self):
        """The topological order cut after each element-wise (residual-add)
        vertex: (segment id per vertex, number of segments)."""
        if self._remat_plan_cache is None:
            seg, s = {}, 0
            for name in self.conf.topological_order:
                seg[name] = s
                spec = self.conf.vertices[name]
                if (not spec.is_layer
                        and isinstance(spec.conf, ElementWiseVertex)):
                    s += 1
            self._remat_plan_cache = (seg, s + 1)
        return self._remat_plan_cache

    def _apply_graph_remat(self, params, state, inputs, *, rng):
        """The training forward with every segment but the last under a
        non-reentrant checkpoint: only the activations a later segment or
        an output head reads are kept; the interior is recomputed in the
        backward. Returns what `_apply_graph` returns (masks all None, no
        carries). Inside the wrapper's tensor-parallel step it raises: a
        recompute would run the split layers' collectives again in the
        backward."""
        if self._column_parallel is not None:
            raise ValueError(
                "remat_segments=True and ParallelWrapper's "
                "tensor_parallel(True) do not combine: build the "
                "ComputationGraph without remat_segments to split it over "
                "\"model\"")
        seg_of, n_seg = self._remat_plan()
        order = self.conf.topological_order
        segments = [[] for _ in range(n_seg)]
        for name in order:
            segments[seg_of[name]].append(name)
        needed_later = set(self.conf.network_outputs)
        for out in self.conf.network_outputs:
            needed_later.update(self.conf.vertices[out].inputs)
        for name in order:
            for inp in self.conf.vertices[name].inputs:
                if seg_of.get(inp, -1) != seg_of[name]:
                    needed_later.add(inp)
        acts = dict(inputs)
        new_state = dict(state)
        for si, names in enumerate(segments):
            if not names:
                continue
            ext_in = sorted({i for n in names
                             for i in self.conf.vertices[n].inputs
                             if seg_of.get(i, -1) != si})
            outs = [n for n in names if n in needed_later]
            tape = DropoutTape(rng) if rng is not None else None

            def seg_fn(ext, names=names, ext_in=ext_in, outs=outs,
                       tape=tape):
                if tape is not None:
                    tape.rewind()
                local = dict(zip(ext_in, ext))
                st_new = {}
                for name in names:
                    spec = self.conf.vertices[name]
                    in_acts = [local[i] for i in spec.inputs]
                    out, st, _ = self._forward_vertex(
                        spec, params.get(name), in_acts,
                        [None] * len(in_acts), train=True, rng=tape,
                        state_entry=state.get(name))
                    if st is not None:
                        st_new[name] = st
                    local[name] = out
                return [local[o] for o in outs], st_new

            ext = [acts[i] for i in ext_in]
            if si < n_seg - 1:
                got, st_new = checkpoint(seg_fn, ext, use_reentrant=False,
                                         preserve_rng_state=False)
            else:
                # the head's segment backs the loss directly
                got, st_new = seg_fn(ext)
            acts.update(zip(outs, got))
            new_state.update(st_new)
        return acts, new_state, {name: None for name in acts}, None

    def _inputs(self, features):
        if isinstance(features, dict):
            features = [features[n] for n in self.conf.network_inputs]
        elif not isinstance(features, (list, tuple)):
            features = [features]
        if len(features) != len(self.conf.network_inputs):
            raise ValueError(
                f"Graph has {len(self.conf.network_inputs)} inputs "
                f"{self.conf.network_inputs}, got {len(features)} arrays")
        out = {}
        for n, f in zip(self.conf.network_inputs, features):
            x = to_port(f, self._device)
            out[n] = x.to(self.compute_dtype) if x.is_floating_point() else x
        return out

    def _masks(self, masks):
        if masks is None:
            return None
        if isinstance(masks, dict):
            masks = [masks.get(n) for n in self.conf.network_inputs]
        elif not isinstance(masks, (list, tuple)):
            masks = [masks]
        return {n: to_port(m, self._device)
                for n, m in zip(self.conf.network_inputs, masks)
                if m is not None}

    def _batch(self, mds):
        dev = self._device
        lmasks = None
        if mds.labels_masks:
            lmasks = [None if m is None else to_port(m, dev)
                      for m in mds.labels_masks]
        return (self._inputs(mds.features),
                [to_port(l, dev) for l in mds.labels],
                self._masks(mds.features_masks), lmasks)

    # ------------------------------------------------------------------
    # Loss over the output vertices
    # ------------------------------------------------------------------
    def _loss(self, features, labels, fmasks, lmasks, train, rng,
              carries=None, params=None, state=None):
        """(score, new layer state, new carries), on the network's masters
        and layer state or on `params` and `state` in their place (see
        MultiLayerNetwork._loss)."""
        masters = params
        params = self._cast_params(masters)
        acts, new_state, _, new_carries = self._apply_graph(
            params, self._states() if state is None else state, features,
            train=train, rng=rng, fmasks=fmasks, carries=carries,
            allow_remat=True)
        total = 0.0
        for oi, out_name in enumerate(self.conf.network_outputs):
            spec = self.conf.vertices[out_name]
            layer = spec.conf
            if not hasattr(layer, "compute_score_per_example"):
                continue  # non-loss output (pure inference head)
            x = acts[spec.inputs[0]]
            if spec.preprocessor is not None:
                x = spec.preprocessor.pre_process(x)
            lmask = lmasks[oi] if lmasks else None
            per_ex = self._layer_score(out_name, layer, params[out_name], x,
                                       labels[oi], train=train, rng=rng,
                                       mask=lmask)
            total = total + mean_score(per_ex)
        return total + self._reg_score(masters), new_state, new_carries

    def _time_steps(self, batch):
        """T from the first sequence input."""
        features = batch[0]
        seq = [f for f in features.values() if f.ndim >= 3]
        return int(seq[0].shape[1]), int(next(iter(features.values()))
                                          .shape[0])

    def _segment(self, batch, t0, length):
        """Only arrays with the whole time axis are sliced: sequence
        inputs and labels (3-D) and their masks; static inputs, labels and
        masks pass whole."""
        features, labels, fmasks, lmasks = batch
        T, _ = self._time_steps(batch)

        def cut(a):
            if a is None or a.ndim < 2 or a.shape[1] < T:
                return a
            return a[:, t0:t0 + length]

        return ({n: cut(f) if f.ndim >= 3 else f
                 for n, f in features.items()},
                [cut(l) if l.ndim >= 3 else l for l in labels],
                {n: cut(m) for n, m in fmasks.items()} if fmasks else None,
                [cut(m) for m in lmasks] if lmasks else None)

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, num_epochs=1):
        """Train on one MultiDataSet or DataSet (or arrays `data`,
        `labels`), num_epochs steps of it; or num_epochs passes over an
        iterator of them. The reference's fit(MultiDataSet) takes one step
        whatever num_epochs says; the port takes num_epochs.

        A DataSetIterator (of DataSets or MultiDataSets) is staged through
        AsyncDataSetIterator; any other object with has_next()/next() (a
        RecordReaderMultiDataSetIterator) or a plain iterable is read on
        this thread, as the reference does."""
        self._ensure_init()
        if labels is not None:
            data = MultiDataSet(data, labels)
        if isinstance(data, (DataSet, MultiDataSet)):
            batch = self._batch(self._dataset(data))
            for _ in range(num_epochs):
                self._step(batch)
            return self
        if isinstance(data, DataSetIterator):
            return self._fit_iterator(data, num_epochs)
        for _ in range(num_epochs):
            if hasattr(data, "reset"):
                data.reset()
            self._epoch_event("on_epoch_start")
            if hasattr(data, "has_next"):
                self._fit_stream(data)
            else:
                for ds in data:
                    self._step(self._batch(self._dataset(ds)))
            self._epoch_event("on_epoch_end")
            self.conf.epoch_count += 1
        return self

    @staticmethod
    def _dataset(data):
        """A MultiDataSet, or a DataSet as one."""
        if isinstance(data, DataSet):
            data = _dataset_to_mds(data)
        if not isinstance(data, MultiDataSet):
            raise TypeError(f"Cannot fit on {type(data)}")
        return data

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    def _forward(self, features, train, features_masks=None):
        self._ensure_init()
        if len(features) == 1 and isinstance(features[0],
                                              (list, tuple, dict)):
            features = features[0]
        inputs = self._inputs(features)
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            acts, *_ = self._apply_graph(
                self._cast_params(), self._states(), inputs, train=train,
                rng=self._dropout_gen if train else None,
                fmasks=self._masks(features_masks))
        return acts

    def output(self, *features, train=False, features_masks=None):
        """The network outputs' activations, as a list of numpy arrays."""
        with P.follow("infer.forward", self._device):
            acts = self._forward(features, train, features_masks)
        with P.span("infer.to_host"):
            return [to_public(acts[n]) for n in self.conf.network_outputs]

    def feed_forward(self, *features, train=False):
        """Every vertex's activation (inputs included), as numpy."""
        return {n: to_public(a)
                for n, a in self._forward(features, train).items()}

    def rnn_time_step(self, *features):
        """Streaming inference with the state carried between calls (see
        MultiLayerNetwork.rnn_time_step): each input [B, F] is one step,
        [B, T, F] a run; returns the outputs as a list of numpy arrays,
        a single step's without its time axis. Raises if the batch size
        differs from the held state's: call `rnn_clear_previous_state`
        first."""
        self._ensure_init()
        if len(features) == 1 and isinstance(features[0],
                                              (list, tuple, dict)):
            features = features[0]
        inputs = self._inputs(features)
        single = all(x.ndim == 2 for x in inputs.values())
        if single:
            inputs = {n: x[:, None, :] for n, x in inputs.items()}
        B = int(next(iter(inputs.values())).shape[0])
        if self._rnn_state:
            held = next(iter(next(iter(self._rnn_state.values())).values()))
            if held.shape[0] != B:
                raise ValueError(
                    f"rnn_time_step batch size changed ({held.shape[0]} -> "
                    f"{B}); call rnn_clear_previous_state() first")
        if self._rnn_state is None:
            self._rnn_state = self._init_carries(B)
        with torch.no_grad(), card_numerics(self._device,
                                            self.compute_dtype):
            acts, _, _, self._rnn_state = self._apply_graph(
                self._cast_params(), self._states(), inputs, train=False,
                rng=None, carries=self._rnn_state)
        outs = [acts[n] for n in self.conf.network_outputs]
        if single:
            outs = [o[:, 0] if o.ndim >= 3 else o for o in outs]
        return [to_public(o) for o in outs]

    rnnTimeStep = rnn_time_step

    def make_inference_fn(self):
        """The pure inference step `(params, state, x) -> [outputs]`, the
        graph's twin of MultiLayerNetwork.make_inference_fn: `x` is one
        array (a single-input graph) or a dict input name -> array; the
        outputs stay on the device."""
        self._ensure_init()
        in_names = list(self.conf.network_inputs)

        def infer(params, state, x):
            feats = x if isinstance(x, dict) else {in_names[0]: x}
            with torch.no_grad(), card_numerics(self._device,
                                                self.compute_dtype):
                acts, *_ = self._apply_graph(params, state,
                                             self._inputs(feats),
                                             train=False, rng=None)
            return [acts[n] for n in self.conf.network_outputs]

        return infer

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    def evaluate(self, data, output_index=0):
        """Classification statistics (`eval.Evaluation`) of output
        `output_index` over a DataSet, a MultiDataSet, an iterator (reset
        first, staged through AsyncDataSetIterator) or a list of batches."""
        from ...eval.evaluation import Evaluation
        ev = Evaluation()
        if isinstance(data, MultiDataSet):
            data = [data]
        with P.follow("eval.run"):
            for ds in self._eval_batches(data):
                with P.follow("eval.batch"):
                    mds = _dataset_to_mds(ds) if isinstance(ds, DataSet) \
                        else ds
                    outs = self.output(mds.features,
                                       features_masks=mds.features_masks)
                    lmask = (mds.labels_masks[output_index]
                             if mds.labels_masks else None)
                    with P.span("eval.score"):
                        ev.eval(_host(mds.labels[output_index]),
                                outs[output_index], mask=_host(lmask))
        return ev

    # ------------------------------------------------------------------
    # Score / gradients
    # ------------------------------------------------------------------
    def _gradient_batch(self, features, labels, fmask, lmask):
        lmasks = None if lmask is None else _as_list(lmask)
        batch = self._batch(MultiDataSet(features, labels, None, lmasks))
        return batch[:2] + (self._masks(fmask),) + batch[3:]

    def get_layer(self, name):
        """The layer configuration of vertex `name`."""
        return self.conf.vertices[name].conf


def _keeps_time_axis(layer):
    """Whether the layer's output keeps its input's time axis (so the mask
    stays meaningful): recurrent layers and per-step heads."""
    if isinstance(layer, BaseRecurrentLayer):
        return True
    return getattr(layer, "layer_type", "") in ("rnnoutput", "activation",
                                                "dropoutlayer", "batchnorm",
                                                "loss")


def _dataset_to_mds(ds: DataSet) -> MultiDataSet:
    return MultiDataSet(
        [ds.features], [ds.labels],
        [ds.features_mask] if ds.features_mask is not None else None,
        [ds.labels_mask] if ds.labels_mask is not None else None)


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]
