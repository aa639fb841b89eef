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

Not ported yet (NotImplementedError, naming the ROADMAP.md item):
`remat_segments=True` (to come on `torch.utils.checkpoint`), iterators,
`fused_steps`, `training_health`, listeners, truncated BPTT,
`rnn_time_step`, `evaluate`.
"""
from __future__ import annotations

import torch

from ...common.device import card_numerics, to_port, to_public
from ...datasets.dataset import DataSet, MultiDataSet
from ..conf.computation_graph_configuration import ComputationGraphConfiguration
from ..multilayer import Network, mean_score, not_ported


class ComputationGraph(Network):
    def __init__(self, conf: ComputationGraphConfiguration,
                 remat_segments=False, device=None):
        if remat_segments:
            raise not_ported("remat_segments=True (segment recompute, to "
                             "come on torch.utils.checkpoint)", 11)
        super().__init__(conf, device)

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
                     fmasks=None):
        """inputs: input name -> tensor (compute type). Returns
        (activations incl. inputs, new state, masks)."""
        acts = dict(inputs)
        masks = {n: (fmasks.get(n) if fmasks else None) for n in inputs}
        new_state = dict(state)
        for name in self.conf.topological_order:
            spec = self.conf.vertices[name]
            in_acts = [acts[i] for i in spec.inputs]
            in_masks = [masks.get(i) for i in spec.inputs]
            if spec.is_layer:
                layer = spec.conf
                x = in_acts[0]
                if spec.preprocessor is not None:
                    x = spec.preprocessor.pre_process(x)
                if layer.has_state():
                    out, new_state[name] = layer.forward_with_state(
                        params[name], x, state[name], train=train, rng=rng,
                        mask=in_masks[0])
                else:
                    out = layer.forward(params[name], x, train=train,
                                        rng=rng, mask=in_masks[0])
                masks[name] = (in_masks[0] if _keeps_time_axis(layer)
                               else None)
            else:
                out = spec.conf.forward(in_acts, masks=in_masks, train=train,
                                        rng=rng)
                masks[name] = spec.conf.output_mask(in_masks)
            acts[name] = out
        return acts, new_state, masks

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
    def _loss(self, features, labels, fmasks, lmasks, train, rng):
        params = self._cast_params()
        acts, new_state, _ = self._apply_graph(
            params, self._states(), features, train=train, rng=rng,
            fmasks=fmasks)
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
            per_ex = layer.compute_score_per_example(
                params[out_name], x, labels[oi], train=train, rng=rng,
                mask=lmask)
            total = total + mean_score(per_ex)
        return total + self._reg_score(), new_state

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, num_epochs=1):
        """Train on one MultiDataSet or DataSet (or arrays `data`,
        `labels`), num_epochs steps of it. The reference's
        fit(MultiDataSet) takes one step whatever num_epochs says; the
        port takes num_epochs."""
        self._ensure_init()
        if labels is not None:
            data = MultiDataSet(data, labels)
        data = self._dataset(data)
        if self.conf.backprop_type == "tbptt":
            raise not_ported("truncated BPTT", 18)
        batch = self._batch(data)
        for _ in range(num_epochs):
            for _ in range(int(self.conf.global_conf.get("num_iterations",
                                                         1))):
                self._train_step(lambda rng: self._loss(*batch, True, rng))
        return self

    @staticmethod
    def _dataset(data):
        """A MultiDataSet, or a DataSet as one."""
        if isinstance(data, DataSet):
            data = _dataset_to_mds(data)
        if not isinstance(data, MultiDataSet):
            raise not_ported("fit over a DataSetIterator", 14)
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
            acts, _, _ = self._apply_graph(
                self._cast_params(), self._states(), inputs, train=train,
                rng=self._dropout_gen if train else None,
                fmasks=self._masks(features_masks))
        return acts

    def output(self, *features, train=False, features_masks=None):
        """The network outputs' activations, as a list of numpy arrays."""
        acts = self._forward(features, train, features_masks)
        return [to_public(acts[n]) for n in self.conf.network_outputs]

    def feed_forward(self, *features, train=False):
        """Every vertex's activation (inputs included), as numpy."""
        return {n: to_public(a)
                for n, a in self._forward(features, train).items()}

    # ------------------------------------------------------------------
    # Score / gradients
    # ------------------------------------------------------------------
    def compute_gradient_and_score(self, features, labels, fmask=None,
                                   lmask=None, train=True):
        """(gradients keyed by vertex name, score); see
        MultiLayerNetwork.compute_gradient_and_score."""
        self._ensure_init()
        lmasks = None if lmask is None else _as_list(lmask)
        batch = self._batch(MultiDataSet(features, labels, None, lmasks))
        batch = batch[:2] + (self._masks(fmask),) + batch[3:]
        return self._gradient_and_score(batch, train)


def _keeps_time_axis(layer):
    """Whether the layer's output keeps its input's time axis (so the mask
    stays meaningful)."""
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
