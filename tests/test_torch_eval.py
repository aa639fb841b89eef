"""The port's training over iterators and its evaluation against the JAX
package's: `MultiLayerNetwork.fit(iterator)` / `ComputationGraph.fit(
iterator)` (through AsyncDataSetIterator, staged to the CPU),
`evaluate`, `evaluate_regression`, `ComputationGraph.evaluate`, and the
`eval/` classes.

The reference draws the weights; each port network takes them through
`from_jax_params` and the same configuration JSON. Held, in f32 on the
CPU:
  - LeNet: `fit(MnistDataSetIterator(16, synthetic) + NormalizerMinMaxScaler,
    num_epochs=1)` is three steps: the parameters to 1e-5, with the
    reference's iteration and epoch counts; two epochs over a caller's
    iterator left mid-stream (fit resets it first) and over an
    AsyncDataSetIterator the caller built, the same;
  - a two-input graph (Merge of two dense branches): three steps over a
    ListDataSetIterator of MultiDataSets and over a
    RecordReaderMultiDataSetIterator, parameters to 1e-5;
  - `evaluate`: the confusion matrices equal, accuracy, precision, recall
    and F1 to 1e-12 (they are ratios of those counts), example metadata
    carried to the prediction errors;
  - `evaluate_regression`: MSE, MAE, RMSE, RSE and R per column to 1e-5
    relative (they are sums over f32 outputs that agree to ~1e-7);
  - `Evaluation`, `ROC`, `ROCMultiClass` and `RegressionEvaluation` are
    copies: equal results on the same numpy inputs.
"""
import types

import numpy as np
import pytest

import deeplearning4j_tpu_torch.datasets as TD
from deeplearning4j_tpu_torch import eval as TE
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = 1e-5
STAT_TOL = 1e-12


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import importlib

    import deeplearning4j_tpu.datasets as JD
    from deeplearning4j_tpu import eval as JE
    from deeplearning4j_tpu.datasets import records
    from deeplearning4j_tpu.nn.conf import graph_vertices
    from deeplearning4j_tpu.nn.conf import layers
    from deeplearning4j_tpu.nn.conf.input_type import InputType
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu.nn.graph.computation_graph import \
        ComputationGraph as JCG
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    jlenet = importlib.import_module("deeplearning4j_tpu.models.zoo.lenet")
    return types.SimpleNamespace(
        jax=jax, D=JD, E=JE, R=records, V=graph_vertices, L=layers,
        InputType=InputType, NNC=NeuralNetConfiguration, CG=JCG, Net=JNet,
        lenet_conf=jlenet.lenet_conf)


def _np(J, tree):
    return J.jax.tree.map(np.array, tree)


def _port_of(J, net):
    """The port's network of the reference's `net`: the same JSON, its
    weights, layer state and updater state."""
    if isinstance(net, J.CG):
        conf = ComputationGraphConfiguration.from_json(net.conf.to_json())
        ours = ComputationGraph(conf, device="cpu")
    else:
        conf = MultiLayerConfiguration.from_json(net.conf.to_json())
        ours = MultiLayerNetwork(conf, device="cpu")
    return ours.init().from_jax_params(_np(J, net._params),
                                       _np(J, net._model_state),
                                       _np(J, net._updater_state))


def _mnist(M, n=48, train=True, norm_from=None):
    it = M.D.MnistDataSetIterator(16, num_examples=n, train=train)
    norm = norm_from or M.D.NormalizerMinMaxScaler().fit(it)
    it.set_pre_processor(norm)
    return it, norm


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def lenet_pair(J):
    ref = J.Net(J.lenet_conf()).init()
    return ref, _port_of(J, ref)


def test_lenet_fit_iterator_three_steps(J, lenet_pair):
    ref, _ = lenet_pair
    ref = ref.clone()
    ours = _port_of(J, ref)
    it_ref, _ = _mnist(J)
    it_ours, _ = _mnist(types.SimpleNamespace(D=TD))
    ref.fit(it_ref)
    ours.fit(it_ours)
    assert (ours.conf.iteration_count, ours.conf.epoch_count) == \
        (ref.conf.iteration_count, ref.conf.epoch_count) == (3, 1)
    assert _max_err(ours.params(), ref.params()) <= TOL
    assert abs(ours.score() - float(ref.score())) <= TOL


@pytest.mark.parametrize("how", ["mid_stream_plain", "caller_async"])
def test_lenet_fit_two_epochs_reset_semantics(J, lenet_pair, how):
    """A plain iterator the caller left mid-stream is reset before the
    first epoch; an AsyncDataSetIterator the caller built resets every
    epoch. Either way: two full passes, six steps, as the reference."""
    ref, _ = lenet_pair
    ref = ref.clone()
    ours = _port_of(J, ref)
    it_ref, _ = _mnist(J)
    it_ours, _ = _mnist(types.SimpleNamespace(D=TD))
    if how == "mid_stream_plain":
        it_ref.next()
        it_ours.next()
    else:
        it_ref = J.D.AsyncDataSetIterator(it_ref, num_workers=2)
        it_ours = TD.AsyncDataSetIterator(it_ours, num_workers=2,
                                          device="cpu")
    ref.fit(it_ref, num_epochs=2)
    ours.fit(it_ours, num_epochs=2)
    assert (ours.conf.iteration_count, ours.conf.epoch_count) == \
        (ref.conf.iteration_count, ref.conf.epoch_count) == (6, 2)
    assert _max_err(ours.params(), ref.params()) <= TOL


def _ev_equal(ours, ref):
    np.testing.assert_array_equal(ours.confusion.matrix, ref.confusion.matrix)
    assert ours.num_examples == ref.num_examples
    for stat in ("accuracy", "precision", "recall", "f1"):
        assert abs(getattr(ours, stat)() - getattr(ref, stat)()) <= STAT_TOL


def test_lenet_evaluate_equals_reference(J, lenet_pair):
    ref, _ = lenet_pair
    ref = ref.clone()
    ours = _port_of(J, ref)
    it_ref, norm_ref = _mnist(J)
    it_ours, norm_ours = _mnist(types.SimpleNamespace(D=TD))
    ref.fit(it_ref)
    ours.fit(it_ours)
    te_ref, _ = _mnist(J, 40, train=False, norm_from=norm_ref)
    te_ours, _ = _mnist(types.SimpleNamespace(D=TD), 40, train=False,
                        norm_from=norm_ours)
    ev_ref, ev_ours = ref.evaluate(te_ref), ours.evaluate(te_ours)
    assert ev_ours.num_examples == 40
    _ev_equal(ev_ours, ev_ref)
    # a DataSet, and positional metadata reaching the prediction errors
    x, y = te_ours._x[:20], te_ours._y[:20]
    meta = [("row", i) for i in range(20)]
    ev_ref = ref.evaluate(J.D.DataSet(x, y), meta=meta)
    ev_ours = ours.evaluate(TD.DataSet(x, y), meta=meta)
    _ev_equal(ev_ours, ev_ref)
    assert ([(p.actual_class, p.predicted_class, p.record_meta_data)
             for p in ev_ours.get_prediction_errors()]
            == [(p.actual_class, p.predicted_class, p.record_meta_data)
                for p in ev_ref.get_prediction_errors()])


def _regression_net(J):
    conf = (J.NNC.Builder().seed(11).updater("nesterovs").learning_rate(0.05)
            .momentum(0.9).list()
            .layer(0, J.L.DenseLayer(n_out=12, activation="tanh"))
            .layer(1, J.L.OutputLayer(n_out=2, activation="identity",
                                      loss_function="mse"))
            .set_input_type(J.InputType.feed_forward(5)).build())
    return J.Net(conf).init()


def test_evaluate_regression_equals_reference(J):
    ref = _regression_net(J)
    ours = _port_of(J, ref)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30, 5)).astype(np.float32)
    y = np.stack([x[:, 0] - x[:, 1], x[:, 2] * 0.5], 1).astype(np.float32)
    ref.fit(J.D.ArraysDataSetIterator((x, y), 10))
    ours.fit(TD.ArraysDataSetIterator((x, y), 10))
    assert _max_err(ours.params(), ref.params()) <= TOL
    ev_ref = ref.evaluate_regression(J.D.ArraysDataSetIterator((x, y), 7))
    ev_ours = ours.evaluate_regression(TD.ArraysDataSetIterator((x, y), 7))
    for c in range(2):
        for stat in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "relative_squared_error",
                     "correlation_r2"):
            a = getattr(ev_ours, stat)(c)
            b = getattr(ev_ref, stat)(c)
            assert abs(a - b) <= TOL * max(1.0, abs(b)), (stat, c)


def _two_input_graph(J):
    conf = (J.NNC.Builder().seed(5).updater("nesterovs").learning_rate(0.1)
            .momentum(0.9).graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", J.L.DenseLayer(n_out=6, activation="tanh"), "a")
            .add_layer("db", J.L.DenseLayer(n_out=5, activation="relu"), "b")
            .add_vertex("m", J.V.MergeVertex(), "da", "db")
            .add_layer("out", J.L.OutputLayer(n_out=3, activation="softmax",
                                              loss_function="mcxent"), "m")
            .set_outputs("out")
            .set_input_types(J.InputType.feed_forward(2),
                             J.InputType.feed_forward(2))
            .build())
    return J.CG(conf).init()


def _graph_batches(M, n=3, b=8):
    rng = np.random.default_rng(6)
    out = []
    for _ in range(n):
        xa = rng.standard_normal((b, 2)).astype(np.float32)
        xb = rng.standard_normal((b, 2)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]
        out.append(M.MultiDataSet([xa, xb], [y]))
    return out


def _graph_csv(tmp_path):
    rng = np.random.default_rng(7)
    path = tmp_path / "graph.csv"
    with open(path, "w") as fh:
        for _ in range(9):
            v = rng.integers(-20, 20, 4) / 8.0
            fh.write(",".join(str(a) for a in v) + f",{rng.integers(0, 3)}\n")
    return str(path)


@pytest.mark.parametrize("source", ["multidataset_list", "record_reader"])
def test_two_input_graph_fit_iterator_and_evaluate(J, source, tmp_path):
    ref = _two_input_graph(J)
    ours = _port_of(J, ref)

    def make(M, R):
        if source == "multidataset_list":
            return M.ListDataSetIterator(_graph_batches(M))
        return (R.RecordReaderMultiDataSetIterator.Builder(3)
                .add_reader("csv", R.CSVRecordReader(_graph_csv(tmp_path)))
                .add_input("csv", 0, 1).add_input("csv", 2, 3)
                .add_output_one_hot("csv", 4, 3).build())

    ref.fit(make(J.D, J.R))
    ours.fit(make(TD, TD.records))
    assert ours.conf.iteration_count == ref.conf.iteration_count == 3
    assert _max_err(ours.params(), ref.params()) <= TOL
    ev_ref = ref.evaluate(J.D.ListDataSetIterator(_graph_batches(J.D)))
    ev_ours = ours.evaluate(TD.ListDataSetIterator(_graph_batches(TD)))
    assert ev_ours.num_examples == 24
    _ev_equal(ev_ours, ev_ref)


def test_eval_classes_equal_reference(J):
    rng = np.random.default_rng(8)
    y = np.eye(4)[rng.integers(0, 4, 50)]
    p = rng.random((50, 4))
    p /= p.sum(1, keepdims=True)
    mask = (rng.random(50) > 0.2).astype(np.float32)
    got = []
    for E in (TE, J.E):
        ev = E.Evaluation(top_n=2)
        ev.eval(y[:30], p[:30], mask=mask[:30])
        other = E.Evaluation(top_n=2)
        other.eval(y[30:], p[30:])
        ev.merge(other)
        roc = E.ROC(threshold_steps=20)
        roc.eval(y[:, :1], p[:, :1])
        rocm = E.ROCMultiClass(threshold_steps=20)
        rocm.eval(y, p)
        reg = E.RegressionEvaluation(4)
        reg.eval(y, p)
        got.append((ev.confusion.matrix.tolist(), ev.stats(),
                    ev.top_n_accuracy(), roc.calculate_auc(),
                    np.asarray(roc.get_roc_curve()).tolist(),
                    rocm.calculate_average_auc(), reg.stats()))
    assert got[0] == got[1]
