"""The port's fused steps (`nn/fused.py`, `Network.fused_steps`) against its
single steps, and against the JAX package's fused steps.

Inside the port, `fused_steps(K)` must be bit-identical to K single steps
(the reference's tests/test_fused_steps.py:164-370, rebuilt here on the
port): parameters, updater state, layer state, iteration counters and
score, for the batch loop (one and several epochs, a ragged tail, K longer
than the epoch), the TBPTT loop (K full segments a group, the carries
threaded, the short tail single-step), the ComputationGraph's batch loop
(multi-input feature dicts and multi-output label lists stacked per leaf)
and TBPTT; the health watchdog inside a group (a NaN skip, a rollback
mid-group whose remaining batches replay single-step, the checkpoint
cadence counted in optimizer steps, an abort like the sequential one); and
what a CUDA graph would freeze if the host computed it once: learning-rate
schedules (exponential, a schedule map) over two groups, and dropout. On
the CPU a group runs the step body itself over the static buffers a CUDA
graph captures on the card; the card's tests (marked gpu) pin the captured
graphs the same way.

Across packages, from the same numpy weights (`from_jax_params`) and
batches: the port's fused8 against the JAX package's fused8, a Nesterov
net in f32 within 1e-5 (cuBLAS-free CPU sums in another order) and an Adam
net in float64 within 1e-9 (Adam turns a gradient's last bits into an
lr-sized change, so its f32 steps are compared in f64), and the TBPTT
char-RNN in f32 within 1e-5.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common.health import (TrainingDivergedError,
                                                    TrainingHealthPolicy)
from deeplearning4j_tpu_torch.common.resilience import FaultInjector
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetValidator, ListDataSetIterator, ValidatingDataSetIterator)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer, GravesLSTM,
                                                    OutputLayer,
                                                    RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL_F32, TOL_F64 = 1e-5, 1e-9


# ------------------------------------------------------------------ nets

def _builder(seed, updater="adam", lr=0.01, data_type="float32", **kw):
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(updater)
         .learning_rate(lr).data_type(data_type))
    if kw.get("policy") == "exponential":
        b = b.learning_rate_decay_policy("exponential").lr_policy_decay_rate(
            0.9)
    elif kw.get("policy") == "schedule":
        b = b.learning_rate_decay_policy("schedule").learning_rate_schedule(
            {0: 0.05, 5: 0.02, 11: 0.005})
    if kw.get("dropout") is not None:
        b = b.dropout(kw["dropout"])
    return b


def _net(seed=7, device="cpu", **kw):
    conf = (_builder(seed, **kw).list()
            .layer(0, DenseLayer(n_out=8, activation="relu"))
            .layer(1, OutputLayer(n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _reg_net(seed=7):
    """MSE head: a value-poisoned batch explodes the gradient norm."""
    conf = (_builder(seed).list()
            .layer(0, DenseLayer(n_out=8, activation="identity"))
            .layer(1, OutputLayer(n_out=3, activation="identity",
                                  loss_function="mse"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _rnn_net(seed=7, device="cpu"):
    conf = (_builder(seed, updater="sgd", lr=0.05).list()
            .layer(0, GravesLSTM(n_out=12, activation="tanh"))
            .layer(1, RnnOutputLayer(n_out=4, activation="softmax",
                                     loss_function="mcxent"))
            .backprop_type("tbptt").t_bptt_forward_length(4)
            .set_input_type(InputType.recurrent(6)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _cg(seed=3):
    conf = (_builder(seed).graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_out=6, activation="relu"), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(5)).build())
    return ComputationGraph(conf, device="cpu").init()


def _cg_two_in_two_out(seed=4):
    conf = (_builder(seed, updater="nesterovs", lr=0.05).graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_out=6, activation="tanh"), "a")
            .add_layer("db", DenseLayer(n_out=4, activation="relu"), "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("o1", OutputLayer(n_out=3, activation="softmax",
                                         loss_function="mcxent"), "m")
            .add_layer("o2", OutputLayer(n_out=2, activation="identity",
                                         loss_function="mse"), "m")
            .set_outputs("o1", "o2")
            .set_input_types(InputType.feed_forward(5),
                             InputType.feed_forward(3)).build())
    return ComputationGraph(conf, device="cpu").init()


def _cg_rnn(seed=5):
    conf = (_builder(seed).graph_builder()
            .add_inputs("in")
            .add_layer("lstm", GravesLSTM(n_out=8, activation="tanh"), "in")
            .add_layer("out", RnnOutputLayer(n_out=3, activation="softmax",
                                             loss_function="mcxent"), "lstm")
            .set_outputs("out")
            .set_input_types(InputType.recurrent(4))
            .backprop_type("tbptt").t_bptt_forward_length(5).build())
    return ComputationGraph(conf, device="cpu").init()


def _data(n=96, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n, 5)).astype(np.float32)
    w = r.random((5, 3))
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return DataSet(x, y)


def _seq(b=8, t=18, f=6, c=4, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((b, t, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[r.integers(0, c, (b, t))]
    return x, y


def _assert_same(a, b, iterations):
    np.testing.assert_array_equal(a.params(), b.params())
    for key, _ in a._keyed_layers():
        for k, st in a._updater_state[key].items():
            for n, t in st.items():
                assert torch.equal(t, b._updater_state[key][k][n]), \
                    (key, k, n)
        for n, t in a._slot(key).state().items():
            assert torch.equal(t, b._slot(key).state()[n]), (key, n)
    assert a.conf.iteration_count == b.conf.iteration_count == iterations
    assert float(a._score) == float(b._score)


def _valit(batches, call, poison):
    """An iterator that poisons the features of batch `call` through the
    injector's data.batch site."""
    inj = FaultInjector(seed=0)
    inj.plan("data.batch", on_call=call, corrupt=poison)
    v = DataSetValidator(policy="count", check_finite=False,
                         fault_injector=inj)
    return ValidatingDataSetIterator(ListDataSetIterator(batches), v)


# ------------------------------------------------- bit-identical in the port

def test_fused_batch_loop_bit_identical():
    batches = list(_data(96, seed=1).batch_by(16))     # 6 batches, K=3
    a = _net(3)
    a.fit(ListDataSetIterator(batches))
    b = _net(3).fused_steps(3)
    b.fit(ListDataSetIterator(batches))
    _assert_same(a, b, 6)
    assert b.fused_counts["groups"] == 2
    assert b.fused_counts["fused_steps"] == 6
    assert b.fused_counts["single_steps"] == {}


def test_fused_multi_epoch_bit_identical():
    batches = list(_data(96, seed=2).batch_by(16))
    a = _net(5)
    a.fit(ListDataSetIterator(batches), num_epochs=2)
    b = _net(5).fused_steps(3)
    b.fit(ListDataSetIterator(batches), num_epochs=2)
    _assert_same(a, b, 12)
    assert a.conf.epoch_count == b.conf.epoch_count == 2


def test_fused_ragged_tail_falls_back():
    ds = _data(104, seed=3)                  # 6x16 + one 8-row tail
    batches = list(ds.batch_by(16))
    assert batches[-1].num_examples() == 8
    a = _net(4)
    a.fit(ListDataSetIterator(batches))
    b = _net(4).fused_steps(3)
    b.fit(ListDataSetIterator(batches))
    _assert_same(a, b, 7)
    assert b.fused_counts["single_steps"] == {"ragged_tail": 1}


def test_fused_mixed_shapes_and_num_iterations_run_single_steps():
    batches = list(_data(64, seed=3).batch_by(16))
    mixed = batches[:2] + [DataSet(batches[2].features[:8],
                                   batches[2].labels[:8])]
    a = _net(4)
    a.fit(ListDataSetIterator(mixed))
    b = _net(4).fused_steps(3)
    b.fit(ListDataSetIterator(mixed))
    _assert_same(a, b, 3)
    assert b.fused_counts["single_steps"] == {"mixed_shapes": 3}
    c = _net(4)
    c.conf.global_conf["num_iterations"] = 2
    c.fused_steps(3).fit(ListDataSetIterator(batches))
    assert c.fused_counts["groups"] == 0
    assert c.fused_counts["single_steps"] == {"num_iterations": 4}
    assert c.conf.iteration_count == 8


def test_fused_k_larger_than_epoch_falls_back():
    batches = list(_data(32, seed=4).batch_by(16))     # 2 batches, K=8
    a = _net(6)
    a.fit(ListDataSetIterator(batches))
    b = _net(6).fused_steps(8)
    b.fit(ListDataSetIterator(batches))
    _assert_same(a, b, 2)
    assert b.fused_counts["groups"] == 0


def test_fused_steps_1_is_the_single_step():
    batches = list(_data(48, seed=4).batch_by(16))
    a = _net(6)
    a.fit(ListDataSetIterator(batches))
    b = _net(6).fused_steps(1)
    b.fit(ListDataSetIterator(batches))
    _assert_same(a, b, 3)
    assert b.fused_counts == {"groups": 0, "graph_replays": 0,
                              "captures": 0, "fused_steps": 0,
                              "single_steps": {}}


def test_fused_tbptt_bit_identical_with_ragged_tail():
    x, y = _seq()                  # T=18, L=4: 4 full segments + a tail
    a = _rnn_net(3)
    a.fit(DataSet(x, y))
    b = _rnn_net(3).fused_steps(3)
    b.fit(DataSet(x, y))
    _assert_same(a, b, 5)
    # one group of 3 at t0 = 0, the fourth full segment and the tail alone
    assert b.fused_counts["groups"] == 1
    assert b.fused_counts["single_steps"] == {"tbptt_tail": 2}


def test_fused_tbptt_groups_at_later_offsets_share_one_group():
    x, y = _seq(t=20, seed=1)      # L=4, K=2: groups at t0 = 0 and 8
    a = _rnn_net(2)
    b = _rnn_net(2).fused_steps(2)
    for _ in range(2):
        a.fit(DataSet(x, y))
        b.fit(DataSet(x, y))
    _assert_same(a, b, 10)
    assert b.fused_counts["groups"] == 4
    assert len([k for k in b._fused_cache if k != "gen"]) == 1


def test_cg_fused_tbptt_bit_identical():
    r = np.random.default_rng(0)
    x = r.random((2, 20, 4)).astype(np.float32)     # L=5 -> 4 segments
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, (2, 20))]
    a = _cg_rnn(5)
    a.fit(MultiDataSet([x], [y]))
    b = _cg_rnn(5).fused_steps(4)
    b.fit(MultiDataSet([x], [y]))
    _assert_same(a, b, 4)
    assert b.fused_counts["groups"] == 1


def test_cg_fused_batch_loop_bit_identical():
    batches = list(_data(96, seed=5).batch_by(16))
    a = _cg(3)
    a.fit(ListDataSetIterator(batches))
    b = _cg(3).fused_steps(3)
    b.fit(ListDataSetIterator(batches))
    _assert_same(a, b, 6)
    assert b.fused_counts["groups"] == 2


def test_cg_fused_multi_input_multi_output_bit_identical():
    r = np.random.default_rng(6)
    mds = [MultiDataSet([r.random((8, 5)).astype(np.float32),
                         r.random((8, 3)).astype(np.float32)],
                        [np.eye(3, dtype=np.float32)[r.integers(0, 3, 8)],
                         r.random((8, 2)).astype(np.float32)])
           for _ in range(6)]
    a = _cg_two_in_two_out()
    a.fit(ListDataSetIterator(mds), num_epochs=2)
    b = _cg_two_in_two_out().fused_steps(3)
    b.fit(ListDataSetIterator(mds), num_epochs=2)
    _assert_same(a, b, 12)
    assert b.fused_counts["groups"] == 4


@pytest.mark.parametrize("kw", [dict(policy="exponential"),
                                dict(policy="schedule", updater="nesterovs"),
                                dict(dropout=0.7, updater="sgd", lr=0.1)],
                         ids=["lr_exponential", "lr_schedule", "dropout"])
def test_fused_reads_each_steps_rate_and_draws(kw):
    """What a captured graph would freeze if the host computed it once:
    each inner step's learning rate (two groups, so the second group's
    rates differ from the first's) and its dropout draws."""
    batches = list(_data(128, seed=7).batch_by(16))    # 8 batches, K=4
    a = _net(8, **kw)
    a.fit(ListDataSetIterator(batches))
    b = _net(8, **kw).fused_steps(4)
    b.fit(ListDataSetIterator(batches))
    _assert_same(a, b, 8)
    assert b.fused_counts["groups"] == 2
    if "policy" in kw:
        rates = [row[0] for row in b._lr_rows(0, 8)]
        assert len(set(rates)) > 1


# ------------------------------------------------------- health composition

def test_fused_nan_skip_inside_group_counters_aligned():
    batches = list(_data(128, seed=6).batch_by(16))    # 8 batches
    pol_a = TrainingHealthPolicy(max_consecutive_bad=5)
    a = _net(11).training_health(pol_a)
    a.fit(_valit(batches, 2, "nan"))
    pol_b = TrainingHealthPolicy(max_consecutive_bad=5)
    b = _net(11).fused_steps(4).training_health(pol_b)
    b.fit(_valit(batches, 2, "nan"))
    assert pol_b.counts["skips"] == 1 and pol_b.counts["ok"] == 7
    assert pol_a.counts == pol_b.counts
    _assert_same(a, b, 8)
    assert b.fused_counts["groups"] == 2
    assert np.isfinite(b.params()).all()


def test_fused_rollback_mid_group(tmp_path):
    batches = list(_data(128, seed=7).batch_by(16))    # 8 batches
    pol_a = TrainingHealthPolicy(grad_norm_limit=50.0, max_consecutive_bad=4)
    a = _reg_net(4).training_health(pol_a, checkpoint_dir=tmp_path / "a",
                                    checkpoint_every=4)
    a.fit(_valit(batches, 5, 500.0))
    pol_b = TrainingHealthPolicy(grad_norm_limit=50.0, max_consecutive_bad=4)
    b = _reg_net(4).fused_steps(4).training_health(
        pol_b, checkpoint_dir=tmp_path / "b", checkpoint_every=4)
    b.fit(_valit(batches, 5, 500.0))
    # divergence at inner step 1 of the second group: restore round 4, the
    # group's last two batches replay single-step, as the sequential run
    assert pol_b.counts["spikes"] == 1 and pol_b.counts["rollbacks"] == 1
    assert pol_a.counts == pol_b.counts
    rb = [e for e in pol_b.events if e["kind"] == "rollback"]
    assert rb[0]["restoredRound"] == 4
    assert b.fused_counts["single_steps"] == {"rollback_replay": 2}
    _assert_same(a, b, 6)
    # == the run that never saw batches 4 and 5
    ref = _reg_net(4)
    ref.fit(ListDataSetIterator(batches[:4] + batches[6:]))
    np.testing.assert_array_equal(ref.params(), b.params())


def test_fused_checkpoint_cadence_in_optimizer_steps(tmp_path):
    """checkpoint_every=2 with fused_steps=8: groups clip at checkpoint
    boundaries, so the manager holds the same steps as the sequential
    run."""
    batches = list(_data(128, seed=8).batch_by(16))    # 8 batches
    nets = {}
    for name, k in (("seq", 1), ("fused", 8)):
        pol = TrainingHealthPolicy(max_consecutive_bad=5)
        n = _net(9).fused_steps(k).training_health(
            pol, checkpoint_dir=tmp_path / name, checkpoint_every=2,
            keep_checkpoints=16)
        n.fit(ListDataSetIterator(batches))
        nets[name] = n
    assert (nets["seq"]._health_ckpt.steps()
            == nets["fused"]._health_ckpt.steps() == [2, 4, 6, 8])
    _assert_same(nets["seq"], nets["fused"], 8)
    assert nets["fused"].fused_counts["groups"] == 4


def test_fused_abort_raises_like_sequential():
    bad = DataSet(np.full((16, 5), np.nan, np.float32),
                  np.eye(3, dtype=np.float32)[np.zeros(16, int)])
    pol = TrainingHealthPolicy(max_consecutive_bad=2)
    net = _net(10).fused_steps(4).training_health(pol)
    net.fit(_data(32, seed=9))
    with pytest.raises(TrainingDivergedError,
                       match=r"offending rounds \[1, 2\]"):
        net.fit(ListDataSetIterator([bad] * 4))
    assert pol.counts["aborts"] == 1


# ------------------------------------------------- against the JAX package

@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import types

    from deeplearning4j_tpu import (InputType as JInputType,
                                    MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.nn.conf import layers as JL
    return types.SimpleNamespace(jax=jax, InputType=JInputType, Net=JNet,
                                 Conf=JConf, DataSet=JDataSet, List=JList,
                                 L=JL)


def _jax_net(J, kind, data_type):
    b = (J.Conf.Builder().seed(21).data_type(data_type)
         .updater("adam" if kind == "adam" else "nesterovs")
         .learning_rate(0.01 if kind == "adam" else 0.05))
    if kind == "rnn":
        conf = (J.Conf.Builder().seed(21).data_type(data_type)
                .updater("sgd").learning_rate(0.05).list()
                .layer(0, J.L.GravesLSTM(n_out=12, activation="tanh"))
                .layer(1, J.L.RnnOutputLayer(n_out=4, activation="softmax",
                                             loss_function="mcxent"))
                .backprop_type("tbptt").t_bptt_forward_length(4)
                .set_input_type(J.InputType.recurrent(6)).build())
    else:
        conf = (b.list()
                .layer(0, J.L.DenseLayer(n_out=16, activation="tanh"))
                .layer(1, J.L.OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"))
                .set_input_type(J.InputType.feed_forward(5)).build())
    return J.Net(conf).init()


def _twin(J, jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init()
    tree = lambda t: J.jax.tree.map(np.array, t)  # noqa: E731
    return net.from_jax_params(tree(jnet._params), tree(jnet._model_state),
                               tree(jnet._updater_state))


@pytest.mark.parametrize("kind,data_type,tol", [
    ("nesterovs", "float32", TOL_F32), ("adam", "float64", TOL_F64)])
def test_fused8_matches_the_reference_fused8(J, kind, data_type, tol):
    jnet = _jax_net(J, kind, data_type)
    net = _twin(J, jnet).fused_steps(8)
    jnet.fused_steps(8)
    batches = list(_data(16 * 18, seed=12).batch_by(16))   # 2 groups + 2
    jnet.fit(J.List([J.DataSet(b.features, b.labels) for b in batches]),
             num_epochs=2)
    net.fit(ListDataSetIterator(batches), num_epochs=2)
    assert net.conf.iteration_count == jnet.conf.iteration_count == 36
    np.testing.assert_allclose(net.params(), np.asarray(jnet.params()),
                               rtol=0, atol=tol)
    assert abs(float(net._score) - float(jnet._score)) <= tol
    assert net.fused_counts["groups"] == 4


def test_fused_tbptt_matches_the_reference(J):
    jnet = _jax_net(J, "rnn", "float32")
    net = _twin(J, jnet).fused_steps(3)
    jnet.fused_steps(3)
    x, y = _seq(seed=13)
    for _ in range(2):
        jnet.fit(J.DataSet(x, y))
        net.fit(DataSet(x, y))
    assert net.conf.iteration_count == jnet.conf.iteration_count == 10
    np.testing.assert_allclose(net.params(), np.asarray(jnet.params()),
                               rtol=0, atol=TOL_F32)


# --------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(policy="exponential", dropout=0.8),
                                dict(policy="schedule", updater="nesterovs")],
                         ids=["exponential_dropout", "schedule"])
def test_captured_groups_equal_single_steps_on_the_card(cuda, kw):
    batches = list(_data(128, seed=14).batch_by(16))
    a = _net(8, device=cuda, **kw)
    b = _net(8, device=cuda, **kw).fused_steps(4)
    for n in (a, b):
        n.fit(ListDataSetIterator(batches))
    _assert_same(a, b, 8)
    assert b.fused_counts["graph_replays"] == 2
    assert b.fused_counts["captures"] == 1


@pytest.mark.gpu
def test_captured_tbptt_equals_single_steps_on_the_card(cuda):
    x, y = _seq(t=20, seed=15)
    a, b = _rnn_net(2, device=cuda), _rnn_net(2, device=cuda).fused_steps(2)
    for _ in range(2):
        for n in (a, b):
            n.fit(DataSet(x, y))
    _assert_same(a, b, 10)
    assert (b.fused_counts["captures"], b.fused_counts["graph_replays"]) \
        == (1, 4)
