"""ModelSerializer, checkpoints in the reference's zip layout: port of
deeplearning4j_tpu/util/model_serializer.py, with the same entries:
  - configuration.json   the network configuration, with the iteration and
                         epoch counters;
  - coefficients.bin     `np.save` of the flat parameter vector
                         (`params()`, the reference's layout and order);
  - updaterState.bin     `np.savez` of the updater state's arrays;
  - modelState.bin       `np.savez` of the layers' state (BatchNorm's
                         running statistics).
A zip written by either package restores in the other.

The two `.bin` trees are the reference's `jax.tree_util` leaves: lists in
order, dict keys sorted, empty dicts contribute nothing; the structure is
rebuilt from the configuration on restore. `tree_leaves` reproduces that
order without JAX, on the containers' reference-layout trees
(`reference_updater_state`, `reference_model_state`).
"""
from __future__ import annotations

import io
import zipfile

import numpy as np

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.bin"
UPDATER_ENTRY = "updaterState.bin"
MODEL_STATE_ENTRY = "modelState.bin"


def tree_leaves(tree):
    """The leaves of nested lists/tuples/dicts in jax.tree_util's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves):
    """`leaves` in the nesting of `like` (the inverse of tree_leaves)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(like)


def _save_tree(tree):
    buf = io.BytesIO()
    np.savez(buf, *[np.asarray(a) for a in tree_leaves(tree)])
    return buf.getvalue()


def _load_tree(data, like):
    """npz bytes into the nesting of `like`, each array in its leaf's type."""
    leaves = tree_leaves(like)
    with np.load(io.BytesIO(data)) as z:
        loaded = [z[f"arr_{i}"] for i in range(len(z.files))]
    if len(loaded) != len(leaves):
        raise ValueError(f"Checkpoint has {len(loaded)} arrays, "
                         f"model expects {len(leaves)}")
    return tree_unflatten(like, [np.asarray(a, l.dtype)
                                 for a, l in zip(loaded, leaves)])


def write_model(model, path, save_updater=True, normalizer=None):
    """Write `model` (MultiLayerNetwork or ComputationGraph) to a zip."""
    if normalizer is not None:
        from ..nn.multilayer import not_ported
        raise not_ported("saving a data normalizer", 14)
    model._ensure_init()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(CONFIG_ENTRY, model.conf.to_json())
        buf = io.BytesIO()
        np.save(buf, model.params())
        zf.writestr(COEFFICIENTS_ENTRY, buf.getvalue())
        if save_updater:
            zf.writestr(UPDATER_ENTRY,
                        _save_tree(model.reference_updater_state()))
        zf.writestr(MODEL_STATE_ENTRY,
                    _save_tree(model.reference_model_state()))



def _restore(path, conf_cls, net_cls, load_updater, device):
    with zipfile.ZipFile(path, "r") as zf:
        conf = conf_cls.from_json(zf.read(CONFIG_ENTRY).decode("utf-8"))
        net = net_cls(conf, device=device).init()
        net.set_params(np.load(io.BytesIO(zf.read(COEFFICIENTS_ENTRY))))
        names = zf.namelist()
        if load_updater and UPDATER_ENTRY in names:
            net.load_reference_updater_state(_load_tree(
                zf.read(UPDATER_ENTRY), net.reference_updater_state()))
        if MODEL_STATE_ENTRY in names:
            net.load_reference_model_state(_load_tree(
                zf.read(MODEL_STATE_ENTRY), net.reference_model_state()))
        return net


def restore_multi_layer_network(path, load_updater=True, device=None):
    """A MultiLayerNetwork from a zip, on the card unless `device` says
    otherwise."""
    from ..nn.conf.neural_net_configuration import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork
    return _restore(path, MultiLayerConfiguration, MultiLayerNetwork,
                    load_updater, device)



def restore_computation_graph(path, load_updater=True, device=None):
    """A ComputationGraph from a zip, on the card unless `device` says
    otherwise."""
    from ..nn.conf.computation_graph_configuration import \
        ComputationGraphConfiguration
    from ..nn.graph import ComputationGraph
    return _restore(path, ComputationGraphConfiguration, ComputationGraph,
                    load_updater, device)
