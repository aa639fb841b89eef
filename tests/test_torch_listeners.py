"""The port's training listeners (`optimize/listeners.py`) and where the
containers fire them, against the JAX package's.

Parity: a `CollectScoresIterationListener` on the port and one on the
reference record the same (iteration, score) pairs over the same two-epoch
fit of the same f64 weights (the reference draws them, `from_jax_params`
carries them over): the iteration numbers equal, the scores within 1e-10
relative (f64: the two backends sum in other orders, read: <= 3.9e-16). One
case per path the reference fires `iteration_done` on: the single step,
TBPTT (once a segment), a ComputationGraph, `fused_steps(4)` (once an inner
step, from the group's epilogue), the armed step (`training_health`), and
the one-rank `ParallelWrapper` in both modes (all-reduce: once a batch;
k = 3 local steps: once a round, the iteration advanced by k, a short last
round of the batches that remain).

Inside the port: the epoch hooks fire once an epoch, around it;
`PerformanceListener` reads `_last_batch_size` equal to the batch size on
every fit path; `ComposableIterationListener` fans out; a fused group with
no listener takes no host read per step (counted on `Tensor.__float__` /
`item` / `tolist` and `common.health.split_stacked`), while a listener
that reads the score takes one per step.
"""
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common import health as H
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import (CollectScoresIterationListener,
                                               ComposableIterationListener,
                                               IterationListener,
                                               PerformanceListener,
                                               ScoreIterationListener,
                                               TrainingListener)
from deeplearning4j_tpu_torch.parallel import ParallelWrapper

REL = 1e-10
EPOCHS = 2


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu import (ComputationGraph as JGraph,
                                    InputType as JInputType,
                                    MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.optimize.listeners import \
        CollectScoresIterationListener as JCollect
    from deeplearning4j_tpu.parallel import (ParallelWrapper as JPW,
                                             make_mesh as jmesh)
    return types.SimpleNamespace(jax=jax, InputType=JInputType, Net=JNet,
                                 Graph=JGraph, Conf=JConf, DataSet=JDataSet,
                                 List=JList, L=JL, Collect=JCollect, PW=JPW,
                                 make_mesh=jmesh)


def _jax_net(J, kind):
    b = (J.Conf.Builder().seed(21).data_type("float64").updater("adam")
         .learning_rate(0.01))
    if kind == "tbptt":
        conf = (J.Conf.Builder().seed(21).data_type("float64")
                .updater("sgd").learning_rate(0.1).list()
                .layer(0, J.L.GravesLSTM(n_out=6, activation="tanh"))
                .layer(1, J.L.RnnOutputLayer(n_out=3, activation="softmax",
                                             loss_function="mcxent"))
                .backprop_type("tbptt").t_bptt_forward_length(4)
                .set_input_type(J.InputType.recurrent(4)).build())
        return J.Net(conf).init()
    if kind == "graph":
        conf = (b.graph_builder().add_inputs("in")
                .add_layer("d", J.L.DenseLayer(n_out=8, activation="tanh"),
                           "in")
                .add_layer("out", J.L.OutputLayer(
                    n_out=3, activation="softmax", loss_function="mcxent"),
                    "d")
                .set_outputs("out")
                .set_input_types(J.InputType.feed_forward(5)).build())
        return J.Graph(conf).init()
    conf = (b.list()
            .layer(0, J.L.DenseLayer(n_out=8, activation="tanh"))
            .layer(1, J.L.OutputLayer(n_out=3, activation="softmax",
                                      loss_function="mcxent"))
            .set_input_type(J.InputType.feed_forward(5)).build())
    return J.Net(conf).init()


def _twin(J, jnet):
    tree = lambda t: J.jax.tree.map(np.array, t)  # noqa: E731
    if isinstance(jnet, J.Graph):
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jnet.conf.to_json()), device="cpu").init()
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jnet.conf.to_json()), device="cpu").init()
    return net.from_jax_params(tree(jnet._params), tree(jnet._model_state),
                               tree(jnet._updater_state))


def _batches(kind, n, seed=0, rows=8):
    r = np.random.default_rng(seed)
    if kind == "tbptt":
        x = r.random((n * rows, 10, 4))
        y = np.eye(3)[r.integers(0, 3, (n * rows, 10))]
    else:
        x = r.random((n * rows, 5))
        y = np.eye(3)[np.argmax(x @ r.random((5, 3)), 1)]
    return list(DataSet(x, y).batch_by(rows))


# path: (net kind, batches an epoch, how each package fits)
PATHS = {
    "single": ("mln", 5, "fit"),
    "tbptt": ("tbptt", 3, "fit"),
    "graph": ("graph", 5, "fit"),
    "fused4": ("mln", 10, "fused"),
    "armed": ("mln", 5, "armed"),
    "wrapper_allreduce": ("mln", 5, 1),
    "wrapper_kstep": ("mln", 7, 3),
}


def _fit(J, how, jnet, net, batches):
    jit = J.List([J.DataSet(b.features, b.labels) for b in batches])
    it = ListDataSetIterator(batches)
    if isinstance(how, int):
        mesh = J.make_mesh(n_data=1, devices=J.jax.devices()[:1])
        J.PW.Builder(jnet).mesh(mesh).averaging_frequency(how).build().fit(
            jit, num_epochs=EPOCHS)
        ParallelWrapper.Builder(net).averaging_frequency(how).build().fit(
            it, num_epochs=EPOCHS)
        return
    if how == "fused":
        jnet.fused_steps(4)
        net.fused_steps(4)
    elif how == "armed":
        jnet.training_health()
        net.training_health()
    jnet.fit(jit, num_epochs=EPOCHS)
    net.fit(it, num_epochs=EPOCHS)


@pytest.mark.parametrize("path", list(PATHS))
def test_collected_scores_match_the_reference(J, path):
    kind, n, how = PATHS[path]
    jnet = _jax_net(J, kind)
    net = _twin(J, jnet)
    jl, pl = J.Collect(), CollectScoresIterationListener()
    jnet.set_listeners(jl)
    assert net.set_listeners(pl) is net
    _fit(J, how, jnet, net, _batches(kind, n, seed=len(path)))
    its = [i for i, _ in pl.scores]
    assert its == [i for i, _ in jl.scores]
    steps = {"tbptt": 3 * n * EPOCHS}.get(kind, n * EPOCHS)
    assert net.conf.iteration_count == jnet.conf.iteration_count == steps
    if how == 3:     # a round of 3, 3 and 1 batches an epoch
        assert its == [2, 5, 6, 9, 12, 13]
    else:
        assert its == list(range(steps))
    np.testing.assert_allclose([s for _, s in pl.scores],
                               [s for _, s in jl.scores], rtol=REL, atol=0)


class _Events(TrainingListener):
    def __init__(self):
        self.seen = []

    def on_epoch_start(self, model):
        self.seen.append(("start", model.conf.iteration_count))

    def on_epoch_end(self, model):
        self.seen.append(("end", model.conf.iteration_count))

    def iteration_done(self, model, iteration):
        self.seen.append(("it", iteration))


def _port_net(kind="mln", seed=3):
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                        GravesLSTM,
                                                        OutputLayer,
                                                        RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    b = NeuralNetConfiguration.Builder().seed(seed).updater("adam")
    if kind == "tbptt":
        conf = (b.list()
                .layer(0, GravesLSTM(n_out=6, activation="tanh"))
                .layer(1, RnnOutputLayer(n_out=3, activation="softmax",
                                         loss_function="mcxent"))
                .backprop_type("tbptt").t_bptt_forward_length(4)
                .set_input_type(InputType.recurrent(4)).build())
        return MultiLayerNetwork(conf, device="cpu").init()
    if kind == "graph":
        conf = (b.graph_builder().add_inputs("in")
                .add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
                .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                              loss_function="mcxent"), "d")
                .set_outputs("out")
                .set_input_types(InputType.feed_forward(5)).build())
        return ComputationGraph(conf, device="cpu").init()
    conf = (b.list()
            .layer(0, DenseLayer(n_out=8, activation="tanh"))
            .layer(1, OutputLayer(n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_epoch_hooks_fire_once_an_epoch_around_it(kind):
    net = _port_net(kind)
    ev = _Events()
    net.set_listeners(ev)
    net.fit(ListDataSetIterator(_batches("mln", 3, seed=1)), num_epochs=2)
    assert ev.seen == [("start", 0), ("it", 0), ("it", 1), ("it", 2),
                       ("end", 3), ("start", 3), ("it", 3), ("it", 4),
                       ("it", 5), ("end", 6)]
    # a DataSet fit is one batch, no epoch
    ev.seen.clear()
    net.fit(_batches("mln", 1, seed=2)[0])
    assert ev.seen == [("it", 6)]


class _Rows(IterationListener):
    def __init__(self):
        self.rows = []

    def iteration_done(self, model, iteration):
        self.rows.append(model._last_batch_size)


@pytest.mark.parametrize("path", ["fit_dataset", "fit_iterator", "tbptt",
                                  "graph", "fused", "armed",
                                  "wrapper_allreduce", "wrapper_kstep"])
def test_performance_listener_reads_the_batch_size(path):
    kind = {"tbptt": "tbptt", "graph": "graph"}.get(path, "mln")
    net = _port_net(kind)
    batches = _batches(kind, 4, seed=4, rows=6)
    perf, rows = PerformanceListener(), _Rows()
    net.set_listeners(perf, rows)
    assert net._last_batch_size == 0
    if path == "fit_dataset":
        for b in batches:
            net.fit(b)
    elif path.startswith("wrapper"):
        k = 1 if path == "wrapper_allreduce" else 2
        ParallelWrapper.Builder(net).averaging_frequency(k).build().fit(
            ListDataSetIterator(batches))
    else:
        if path == "fused":
            net.fused_steps(2)
        elif path == "armed":
            net.training_health()
        net.fit(ListDataSetIterator(batches))
    calls = {"tbptt": 12, "wrapper_kstep": 2}.get(path, 4)
    assert rows.rows == [6] * calls
    assert len(perf.history) == calls - 1
    for _, dt, samples_per_s in perf.history:
        assert samples_per_s == pytest.approx(6 / dt)


def test_composable_listener_fans_out_and_score_listener_logs(caplog):
    a, b = CollectScoresIterationListener(), CollectScoresIterationListener(2)
    net = _port_net()
    net.add_listener(ComposableIterationListener(a, b))
    net.add_listener(ScoreIterationListener(print_iterations=2))
    with caplog.at_level("INFO", logger="deeplearning4j_tpu_torch"):
        net.fit(ListDataSetIterator(_batches("mln", 5, seed=5)))
    assert [i for i, _ in a.scores] == [0, 1, 2, 3, 4]
    assert [i for i, _ in b.scores] == [0, 2, 4]
    assert dict(b.scores) == {i: s for i, s in a.scores if i % 2 == 0}
    logged = [r.getMessage() for r in caplog.records
              if "Score at iteration" in r.getMessage()]
    assert [m.split()[3] for m in logged] == ["0", "2", "4"]


class _HostReads:
    """Counts the host reads of tensor values inside the block."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("__float__", "item", "tolist"):
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **kw):
                self.n += 1
                return _orig(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)
        split = H.split_stacked

        def counted_split(*a, **kw):
            self.n += 1
            return split(*a, **kw)

        monkeypatch.setattr(H, "split_stacked", counted_split)


def test_fused_group_without_listener_reads_nothing_on_the_host(monkeypatch):
    batches = _batches("mln", 8, seed=6)
    quiet = _port_net().fused_steps(4)
    heard = _port_net().fused_steps(4)
    collect = CollectScoresIterationListener()
    heard.set_listeners(collect)
    reads = _HostReads(monkeypatch)
    quiet.fit(ListDataSetIterator(batches))
    quiet_reads = reads.n
    heard.fit(ListDataSetIterator(batches))
    assert quiet.fused_counts["groups"] == heard.fused_counts["groups"] == 2
    assert quiet_reads == 0
    assert isinstance(quiet._score, torch.Tensor)
    assert reads.n - quiet_reads == 8 == len(collect.scores)
    assert quiet.conf.iteration_count == heard.conf.iteration_count == 8
    np.testing.assert_array_equal(quiet.params(), heard.params())
