"""The port's numerical gradient check (`gradientcheck/gradient_check_util.py`)
on one network of each family the reference gradient-checks, float64 on
the CPU, at the reference's toy sizes and tolerances:

  - a dense MLP (tests/test_mlp.py:127), plain and with L1/L2 terms;
  - a convolution with max, average and sum pooling, LRN and global
    pooling (tests/test_cnn.py:102-129), on a subset of the parameters
    drawn as the reference draws it;
  - a GravesLSTM with feature and label masks (tests/test_rnn.py:83-104);
  - a ComputationGraph with a MergeVertex and each ElementWiseVertex op
    (tests/test_computation_graph.py:98-118).

The check is not vacuous: with one entry of the analytic gradient moved by
10% it fails, naming that entry. The subset is the reference's draw
(numpy's default_rng(seed).choice), the same indices in both packages.
"""
import logging

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (ElementWiseVertex,
                                                            MergeVertex)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                    DenseLayer,
                                                    GlobalPoolingLayer,
                                                    GravesLSTM,
                                                    LocalResponseNormalization,
                                                    OutputLayer,
                                                    RnnOutputLayer,
                                                    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny forwards: one intra-op thread each, so that a
    worker among several does not wait on a pool of all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_blobs(n=8, n_features=4, n_classes=3, seed=0):
    """tests/test_mlp.py's blobs, float64."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, (n_classes, n_features))
    x = np.array([centers[i % n_classes] + rng.normal(0, 0.5, n_features)
                  for i in range(n)])
    return x, np.eye(n_classes)[np.arange(n) % n_classes]


def mlp_net(**g):
    b = (NeuralNetConfiguration.Builder().seed(42).updater("sgd")
         .learning_rate(0.1).data_type("float64"))
    for k, v in g.items():
        getattr(b, k)(v)
    conf = (b.list()
            .layer(0, DenseLayer(n_out=16, activation="relu",
                                 weight_init="xavier"))
            .layer(1, OutputLayer(n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def cnn_net(extra=(), device="cpu"):
    """tests/test_cnn.py's small_cnn_conf: 8x8x2, a 3x3 tanh convolution,
    `extra`, a softmax head; float64."""
    layers = [ConvolutionLayer(n_out=3, kernel_size=(3, 3), stride=(1, 1),
                               activation="tanh"), *extra,
              OutputLayer(n_out=3, activation="softmax",
                          loss_function="mcxent")]
    b = (NeuralNetConfiguration.Builder().seed(12345).data_type("float64")
         .learning_rate(0.1).weight_init("xavier").list())
    for i, layer in enumerate(layers):
        b.layer(i, layer)
    conf = b.set_input_type(InputType.convolutional(8, 8, 2)).build()
    return MultiLayerNetwork(conf, device=device).init()


def cnn_data(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 8, 8, 2)),
            np.eye(3)[rng.integers(0, 3, n)])


def lstm_net(device="cpu"):
    """tests/test_rnn.py's rnn_conf(GravesLSTM(n_out=4)), float64."""
    conf = (NeuralNetConfiguration.Builder().seed(12345)
            .data_type("float64").learning_rate(0.1).weight_init("xavier")
            .list()
            .layer(0, GravesLSTM(n_out=4))
            .layer(1, RnnOutputLayer(n_out=3, activation="softmax",
                                     loss_function="mcxent"))
            .set_input_type(InputType.recurrent(3)).build())
    return MultiLayerNetwork(conf, device=device).init()


def lstm_data(seed=0):
    """tests/test_rnn.py's seq_data and its masks: row 2 from step 3 on and
    row 3 from step 1 on are padding."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (4, 6, 3))
    y = np.eye(3)[rng.integers(0, 3, (4, 6))]
    mask = np.ones((4, 6))
    mask[2, 3:] = 0
    mask[3, 1:] = 0
    return x, y, mask, mask.copy()


def graph_net(vertex):
    conf = (NeuralNetConfiguration.Builder().seed(42).data_type("float64")
            .updater("sgd").learning_rate(0.1).graph_builder()
            .add_inputs("in")
            .add_layer("d1", DenseLayer(n_out=5, activation="tanh"), "in")
            .add_layer("d2", DenseLayer(n_out=5, activation="tanh"), "in")
            .add_vertex("v", vertex, "d1", "d2")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"), "v")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(conf, device="cpu").init()


def graph_data():
    r = np.random.default_rng(12345)
    return r.random((8, 4)), np.eye(3)[r.integers(0, 3, 8)]


@pytest.mark.parametrize("g", [{}, {"l1": 0.01, "l2": 0.02}],
                         ids=["plain", "l1_l2"])
def test_dense_mlp_passes(g):
    x, y = make_blobs()
    assert check_gradients(mlp_net(**g), x, y, epsilon=1e-6,
                           max_rel_error=1e-4)


@pytest.mark.parametrize("extra,subset", [
    ((SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                       stride=(2, 2)),), 50),
    ((SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2),
                       stride=(2, 2)),), 50),
    ((SubsamplingLayer(pooling_type="sum", kernel_size=(2, 2),
                       stride=(2, 2)),), 50),
    ((LocalResponseNormalization(),), 50),
    ((GlobalPoolingLayer(pooling_type="avg"),), 40),
    ((), 60)], ids=["max", "avg", "sum", "lrn", "global_avg", "conv"])
def test_conv_and_pooling_nets_pass(extra, subset):
    x, y = cnn_data()
    assert check_gradients(cnn_net(extra), x, y, max_rel_error=1e-4,
                           subset=subset)


def test_graves_lstm_with_masks_passes():
    x, y, fmask, lmask = lstm_data()
    assert check_gradients(lstm_net(), x, y, fmask=fmask, lmask=lmask,
                           max_rel_error=1e-4, subset=50)


@pytest.mark.parametrize("vertex", [
    MergeVertex(), ElementWiseVertex(op="add"),
    ElementWiseVertex(op="subtract"), ElementWiseVertex(op="product"),
    ElementWiseVertex(op="average"), ElementWiseVertex(op="max")],
    ids=["merge", "add", "subtract", "product", "average", "max"])
def test_graph_with_merge_and_elementwise_vertices_passes(vertex):
    x, y = graph_data()
    assert check_gradients(graph_net(vertex), x, y, max_rel_error=1e-4)


def test_a_perturbed_gradient_fails(caplog, monkeypatch):
    """One entry of the analytic gradient moved by 10%: the check fails on
    that entry alone. The parameters are put back as they were."""
    x, y = make_blobs()
    net = mlp_net()
    before = net.params()
    flatten = net.flatten_gradients
    target = 7

    def perturbed(grads):
        flat = flatten(grads)
        flat[target] *= 1.1
        return flat

    assert abs(flatten(net.compute_gradient_and_score(x, y)[0])[target]) \
        > 1e-3
    monkeypatch.setattr(net, "flatten_gradients", perturbed)
    with caplog.at_level(logging.WARNING):
        assert not check_gradients(net, x, y, max_rel_error=1e-4)
    failed = [r.getMessage() for r in caplog.records
              if "FAILED:" in r.getMessage()]
    assert len(failed) == 1 and failed[0].startswith(f"param {target} ")
    np.testing.assert_array_equal(net.params(), before)


def test_subset_is_the_reference_s_draw(monkeypatch):
    """subset=N checks numpy's default_rng(seed).choice(n, N) indices, as
    the reference: a perturbed entry outside the draw passes, inside fails."""
    x, y = make_blobs()
    net = mlp_net()
    n = net.num_params()
    drawn = np.random.default_rng(12345).choice(n, size=10, replace=False)
    outside = next(i for i in range(n) if i not in set(drawn.tolist()))
    flatten = net.flatten_gradients
    for target, ok in ((outside, True), (int(drawn[3]), False)):
        def perturbed(grads, target=target):
            flat = flatten(grads)
            flat[target] += 0.5
            return flat

        monkeypatch.setattr(net, "flatten_gradients", perturbed)
        assert check_gradients(net, x, y, max_rel_error=1e-4,
                               subset=10) is ok
