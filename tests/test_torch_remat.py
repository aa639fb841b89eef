"""Segment recompute on the port: `ComputationGraph(remat_segments=True)`
and `resnet50(remat=True)` (nn/graph/computation_graph.py).

  * The reference's five cases (tests/test_remat_segments.py), their
    bodies run on the port's classes.
  * Against the JAX package: the reference's remat step and the port's on
    the same numpy weights, three steps: scores and parameters within 1e-5
    with Nesterov in f32, and within 1e-9 with Adam in f64 (as
    tests/test_torch_computation_graph.py holds Adam: it turns the last
    bits of a tiny f32 gradient into an lr-size step); the BatchNorm
    statistics, which the port keeps in f32, within 1e-5.
  * Inside the port, remat against plain bit for bit: dropout (the keep
    masks of a segment's recompute are its first forward's), a fused group
    of two steps against two single steps, and a residual graph with
    BatchNorm on two gloo ranks in all-reduce mode (the recompute re-issues
    the statistics' all-reduce; every rank recomputes the same segments in
    the same order, so the collectives pair up). The ranks run this file as
    a script.
"""
import pickle
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel import ParallelWrapper

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel_wrapper import join_ranks, start_ranks  # noqa: E402

WORLD = 2
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 150


def _residual_conf(seed=7, dropout=None, updater="sgd",
                   data_type="float32"):
    """Two residual blocks: conv->BN->relu chains + adds (the ResNet
    shape at toy scale; tests/test_remat_segments.py's graph, with an
    optional input dropout on the convolutions)."""
    gb = (NeuralNetConfiguration.Builder().seed(seed).updater(updater)
          .learning_rate(0.1).weight_init("relu").data_type(data_type)
          .graph_builder()
          .add_inputs("input"))
    gb.add_layer("c0", ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                        convolution_mode="same"), "input")
    x = "c0"
    for b in range(2):
        gb.add_layer(f"b{b}_c1", ConvolutionLayer(
            n_out=8, kernel_size=(3, 3), convolution_mode="same",
            dropout=dropout), x)
        gb.add_layer(f"b{b}_bn", BatchNormalization(), f"b{b}_c1")
        gb.add_layer(f"b{b}_r", ActivationLayer(activation="relu"),
                     f"b{b}_bn")
        gb.add_layer(f"b{b}_c2", ConvolutionLayer(
            n_out=8, kernel_size=(3, 3), convolution_mode="same",
            dropout=dropout), f"b{b}_r")
        gb.add_vertex(f"b{b}_add", ElementWiseVertex(op="add"),
                      f"b{b}_c2", x)
        gb.add_layer(f"b{b}_out", ActivationLayer(activation="relu"),
                     f"b{b}_add")
        x = f"b{b}_out"
    gb.add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), x)
    gb.add_layer("fc", OutputLayer(n_out=3, activation="softmax",
                                   loss_function="mcxent"), "pool")
    return (gb.set_outputs("fc")
            .set_input_types(InputType.convolutional(8, 8, 2)).build())


def _data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _graph(remat, **kw):
    return ComputationGraph(_residual_conf(**kw), remat_segments=remat,
                            device="cpu").init()


def _assert_bit_equal(a, b):
    np.testing.assert_array_equal(a.params(), b.params())
    for key, _ in a._keyed_layers():
        for n, t in a._slot(key).state().items():
            assert torch.equal(t, b._slot(key).state()[n]), (key, n)
    assert float(a._score) == float(b._score)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_remat_segments.py), on the port
# ---------------------------------------------------------------------------
class TestRematSegments:
    def test_plan_segments_at_adds(self):
        net = _graph(True)
        seg_of, n_seg = net._remat_plan()
        assert n_seg == 3                       # two adds -> three segments
        assert seg_of["b0_c1"] == 0
        assert seg_of["b0_out"] == 1            # first vertex after add 0
        assert seg_of["fc"] == 2

    def test_training_identical_to_default(self):
        x, y = _data()
        nets = [_graph(r) for r in (False, True)]
        scores = [[], []]
        for i, net in enumerate(nets):
            for _ in range(4):
                net.fit(DataSet(x, y))
                scores[i].append(float(net._score))
        np.testing.assert_allclose(scores[0], scores[1], rtol=1e-5)
        np.testing.assert_allclose(nets[0].params(), nets[1].params(),
                                   atol=2e-5)

    def test_bn_running_stats_still_update(self):
        x, y = _data()
        net = _graph(True)
        before = net._model_state["b0_bn"]["mean"].clone()
        net.fit(DataSet(x, y))
        after = net._model_state["b0_bn"]["mean"]
        assert not torch.allclose(before, after)

    def test_inference_output_matches(self):
        x, _ = _data()
        n0, n1 = _graph(False), _graph(True)
        np.testing.assert_allclose(np.asarray(n0.output(x)),
                                   np.asarray(n1.output(x)), atol=1e-6)

    def test_resnet50_factory_flag(self):
        from deeplearning4j_tpu_torch.models.zoo.resnet import resnet50_conf
        conf = resnet50_conf(height=32, width=32, num_classes=4,
                             data_type="float32")
        net = ComputationGraph(conf, remat_segments=True, device="cpu")
        _, n_seg = net._remat_plan()
        assert n_seg == 17                      # 16 bottleneck adds + head


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("updater, data_type, tol", [
    ("nesterovs", "float32", 1e-5), ("adam", "float64", 1e-9)])
def test_remat_steps_match_the_reference_remat(updater, data_type, tol):
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.conf.computation_graph_configuration import \
        ComputationGraphConfiguration as JConf
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    conf = _residual_conf(seed=11, updater=updater, data_type=data_type)
    jnet = JGraph(JConf.from_json(conf.to_json()),
                  remat_segments=True).init()
    params, state = jax.tree.map(np.array, (jnet._params, jnet._model_state))
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), remat_segments=True, device="cpu").init()
    net.from_jax_params(params, state)
    np.testing.assert_array_equal(net.params(), np.asarray(jnet.params()))
    for step in range(3):
        x, y = _data(seed=step)
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
        assert abs(float(net._score) - float(jnet._score)) <= tol
    np.testing.assert_allclose(net.params(), np.asarray(jnet.params()),
                               rtol=0, atol=tol)
    for name in ("b0_bn", "b1_bn"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                net._model_state[name][k].numpy(),
                np.asarray(jnet._model_state[name][k]), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# inside the port: remat == plain, bit for bit
# ---------------------------------------------------------------------------
def test_dropout_under_remat_bit_equal_to_plain():
    """The recompute must see the first forward's keep masks; the
    generator (a torch.Generator checkpoint does not save) moves once."""
    x, y = _data()
    nets = [_graph(r, dropout=0.7) for r in (False, True)]
    for net in nets:
        for step in range(3):
            net.fit(DataSet(*_data(seed=step)))
    _assert_bit_equal(*nets)
    assert torch.equal(nets[0]._dropout_gen.get_state(),
                       nets[1]._dropout_gen.get_state())


@pytest.mark.parametrize("dropout", [None, 0.7])
def test_remat_fused_group_equals_single_steps(dropout):
    batches = [DataSet(*_data(seed=s)) for s in range(4)]
    single = _graph(True, dropout=dropout)
    single.fit(ListDataSetIterator(batches))
    fused = _graph(True, dropout=dropout).fused_steps(2)
    fused.fit(ListDataSetIterator(batches))
    _assert_bit_equal(single, fused)
    assert fused.fused_counts["fused_steps"] == 4
    plain = _graph(False, dropout=dropout)
    plain.fit(ListDataSetIterator(batches))
    _assert_bit_equal(plain, fused)


def _rank_main(rank, world, store, out_dir):
    """One gloo rank: a BatchNorm residual graph through the all-reduce
    wrapper, plain and with remat, on this rank's half of each batch."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    batches = [DataSet(*_data(seed=s, n=16)) for s in range(3)]
    out = {}
    for remat in (False, True):
        net = _graph(remat)
        pw = ParallelWrapper.Builder(net).averaging_frequency(1).build()
        pw.fit(ListDataSetIterator(batches))
        out[remat] = {"params": net.params(),
                      "mean": net._model_state["b1_bn"]["mean"].numpy(),
                      "score": float(net._score)}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


def test_remat_on_two_gloo_ranks_with_batchnorm(tmp_path):
    procs, logs = start_ranks(WORLD, tmp_path, script=__file__)
    ranks = join_ranks(procs, logs, tmp_path,
                       time.monotonic() + JOIN_TIMEOUT_S)
    for r in ranks:
        np.testing.assert_array_equal(r[True]["params"], r[False]["params"])
        np.testing.assert_array_equal(r[True]["mean"], r[False]["mean"])
        assert r[True]["score"] == r[False]["score"]
    np.testing.assert_array_equal(ranks[0][True]["params"],
                                  ranks[1][True]["params"])
    # the statistics span both ranks: a one-rank run on the rank's half
    # batch differs
    alone = _graph(True)
    alone.fit(DataSet(*[a[:8] for a in _data(seed=0, n=16)]))
    assert not np.array_equal(alone._model_state["b1_bn"]["mean"].numpy(),
                              ranks[0][True]["mean"])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
