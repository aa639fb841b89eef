"""The port's early stopping (`earlystopping/early_stopping.py`,
`parallel/early_stopping.py`) and `util.sharded_checkpoint.ShardedModelSaver`,
against the JAX package's.

  - The reference's TestEarlyStopping bodies
    (tests/test_serialization_earlystopping.py:182-260) rebuilt on the
    port: max epochs, score improvement at "lr 0" (a rate of 0 reads as
    the default 0.1 in both packages, `layer.learning_rate or 0.1`), an
    invalid score at lr 1e9, the local-file saver, max time.
  - Parity: the same f64 MLP weights (the reference draws them,
    `from_jax_params` carries them over) and data through each package's
    trainer, 3 epochs of MaxEpochs(3) and ScoreImprovement(2): the same
    `score_vs_epoch` (1e-9 relative; f64 sums in other orders), best epoch,
    termination reason and details (word for word) and total epochs.
  - `LocalFileModelSaver`'s `bestModel.bin` written by the port restores in
    the reference's `restore_model` with equal outputs (1e-6), and in the
    port on the device of the network it saved.
  - `ShardedModelSaver` drives the trainer as the reference's
    tests/test_sharded_checkpoint.py:163-185 does; the best model it
    restores holds the parameters of the best epoch, bit for bit.
  - `TpuEarlyStoppingTrainer` over the port's TrainingMaster, as the
    reference's tests/test_training_master.py:359-388 (one rank here: the
    master takes the process group's size).
  - `EarlyStoppingParallelTrainer` over the one-rank ParallelWrapper in both
    modes: the same result as `EarlyStoppingTrainer` on `fit`, bit for bit
    (the one-rank wrapper is `fit`); k = 2 hands each epoch's iterator over
    whole. `tensor_parallel=True` raises naming item 20.
"""
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.earlystopping import (
    BestScoreEpochTerminationCondition, DataSetLossCalculator,
    EarlyStoppingConfiguration, EarlyStoppingGraphTrainer,
    EarlyStoppingResult, EarlyStoppingTrainer, InMemoryModelSaver,
    InvalidScoreIterationTerminationCondition, LocalFileModelSaver,
    MaxEpochsTerminationCondition, MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    EarlyStoppingParallelTrainer, MasterDataSetLossCalculator,
    ParameterAveragingTrainingMaster, SparkEarlyStoppingTrainer,
    TpuEarlyStoppingTrainer)
from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
    ShardedModelSaver


def _mln(seed=7, n_in=4, width=8, data_type="float32"):
    """tests/test_serialization_earlystopping.py's net, on the port."""
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater("adam").learning_rate(0.01).data_type(data_type).list()
            .layer(0, DenseLayer(n_out=width, activation="relu"))
            .layer(1, OutputLayer(n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=32, seed=0, n_in=4, dtype=np.float32):
    r = np.random.default_rng(seed)
    x = r.random((n, n_in)).astype(dtype)
    y = np.eye(3, dtype=dtype)[r.integers(0, 3, n)]
    return DataSet(x, y)


def _iters(dtype=np.float32):
    train = ListDataSetIterator(list(_data(64, 1, dtype=dtype).batch_by(16)))
    val = ListDataSetIterator(list(_data(32, 2, dtype=dtype).batch_by(16)))
    return train, val


# ------------------------------------------- the reference's bodies, port

def test_max_epochs_termination():
    train, val = _iters()
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(DataSetLossCalculator(val))
          .epoch_termination_conditions(MaxEpochsTerminationCondition(3))
          .build())
    result = EarlyStoppingTrainer(es, _mln(), train).fit()
    assert result.termination_reason == "EpochTerminationCondition"
    assert "MaxEpochs" in result.termination_details
    assert result.total_epochs == 3
    assert result.get_best_model() is not None
    assert len(result.score_vs_epoch) == 3
    assert isinstance(es.saver, InMemoryModelSaver)


def test_score_improvement_termination():
    train, val = _iters()
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(DataSetLossCalculator(val))
          .epoch_termination_conditions(
              ScoreImprovementEpochTerminationCondition(2),
              MaxEpochsTerminationCondition(100))
          .build())
    net = _mln()
    # zero LR -> no improvement -> stops after 2 stagnant epochs
    for layer in net.layers:
        layer.learning_rate = 0.0
    result = EarlyStoppingTrainer(es, net, train).fit()
    assert result.termination_reason == "EpochTerminationCondition"
    assert "ScoreImprovement" in result.termination_details


def test_invalid_score_termination():
    train, val = _iters()
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(DataSetLossCalculator(val))
          .iteration_termination_conditions(
              InvalidScoreIterationTerminationCondition())
          .epoch_termination_conditions(MaxEpochsTerminationCondition(5))
          .build())
    net = _mln()
    for layer in net.layers:
        layer.learning_rate = 1e9  # diverge -> NaN
    result = EarlyStoppingTrainer(es, net, train).fit()
    # either NaN hit (iteration condition) or epochs exhausted
    assert result.termination_reason in (
        "IterationTerminationCondition", "EpochTerminationCondition")


def test_local_file_saver(tmp_path):
    train, val = _iters()
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(DataSetLossCalculator(val))
          .epoch_termination_conditions(MaxEpochsTerminationCondition(2))
          .model_saver(LocalFileModelSaver(str(tmp_path)))
          .build())
    result = EarlyStoppingTrainer(es, _mln(), train).fit()
    best = result.get_best_model()
    assert best is not None and best.device.type == "cpu"
    assert (tmp_path / "bestModel.bin").exists()
    ds = _data()
    assert np.asarray(best.output(ds.features)).shape == (32, 3)


def test_max_time_termination():
    train, val = _iters()
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(DataSetLossCalculator(val))
          .iteration_termination_conditions(
              MaxTimeIterationTerminationCondition(0.0))
          .epoch_termination_conditions(MaxEpochsTerminationCondition(50))
          .build())
    result = EarlyStoppingTrainer(es, _mln(), train).fit()
    assert result.termination_reason == "IterationTerminationCondition"
    assert "MaxTime" in result.termination_details


def test_conditions_savers_and_the_default_nan_guard(tmp_path):
    assert MaxEpochsTerminationCondition(2).terminate(1, 0.5)
    assert BestScoreEpochTerminationCondition(0.4).terminate(0, 0.3)
    assert MaxScoreIterationTerminationCondition(2.0).terminate(2.5)
    train, _ = _iters()
    net = _mln()
    for layer in net.layers:
        layer.learning_rate = 1e30
    es = (EarlyStoppingConfiguration.Builder()
          .epoch_termination_conditions(MaxEpochsTerminationCondition(5))
          .save_last_model(True).build())
    result = EarlyStoppingTrainer(es, net, train).fit()
    assert result.termination_reason == "IterationTerminationCondition"
    assert result.termination_details.startswith("score is non-finite (")
    assert EarlyStoppingGraphTrainer is EarlyStoppingTrainer
    assert str(result).startswith("EarlyStoppingResult(reason=")
    assert EarlyStoppingResult.TerminationReason.Error == "Error"


# --------------------------------------------------- against the reference

@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu import (InputType as JInputType,
                                    MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu import earlystopping as JES
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.util import model_serializer as jser
    return types.SimpleNamespace(jax=jax, InputType=JInputType, Net=JNet,
                                 Conf=JConf, ES=JES, DataSet=JDataSet,
                                 List=JList, L=JL, ser=jser)


def _jax_mln(J):
    conf = (J.Conf.Builder().seed(7).updater("adam").learning_rate(0.01)
            .data_type("float64").list()
            .layer(0, J.L.DenseLayer(n_out=8, activation="relu"))
            .layer(1, J.L.OutputLayer(n_out=3, activation="softmax",
                                      loss_function="mcxent"))
            .set_input_type(J.InputType.feed_forward(4)).build())
    return J.Net(conf).init()


def _twin(J, jnet):
    tree = lambda t: J.jax.tree.map(np.array, t)  # noqa: E731
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    return net.from_jax_params(tree(jnet._params), tree(jnet._model_state),
                               tree(jnet._updater_state))


def _jax_iters(J, dtype=np.float64):
    train, val = _iters(dtype)
    as_j = lambda it: J.List([J.DataSet(b.features, b.labels)  # noqa: E731
                              for b in it._batches])
    return as_j(train), as_j(val)


def test_trainer_matches_the_reference(J):
    jnet = _jax_mln(J)
    net = _twin(J, jnet)

    def conf(ES, val):
        return (ES.EarlyStoppingConfiguration.Builder()
                .score_calculator(ES.DataSetLossCalculator(val))
                .epoch_termination_conditions(
                    ES.MaxEpochsTerminationCondition(3),
                    ES.ScoreImprovementEpochTerminationCondition(2))
                .build())

    import deeplearning4j_tpu_torch.earlystopping as ES
    jtrain, jval = _jax_iters(J)
    train, val = _iters(np.float64)
    want = J.ES.EarlyStoppingTrainer(conf(J.ES, jval), jnet, jtrain).fit()
    got = EarlyStoppingTrainer(conf(ES, val), net, train).fit()
    assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch) \
        == [0, 1, 2]
    for e, s in want.score_vs_epoch.items():
        assert got.score_vs_epoch[e] == pytest.approx(s, rel=1e-9)
    for field in ("best_model_epoch", "termination_reason",
                  "termination_details", "total_epochs"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.termination_details == "MaxEpochsTerminationCondition(3)"
    assert got.best_model_score == pytest.approx(want.best_model_score,
                                                 rel=1e-9)
    np.testing.assert_allclose(got.best_model.params(),
                               np.asarray(want.best_model.params()),
                               rtol=1e-9, atol=1e-12)


def test_best_model_zip_restores_in_the_reference(J, tmp_path):
    train, val = _iters()
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(DataSetLossCalculator(val))
          .epoch_termination_conditions(MaxEpochsTerminationCondition(2))
          .model_saver(LocalFileModelSaver(tmp_path)).build())
    result = EarlyStoppingTrainer(es, _mln(), train).fit()
    path = tmp_path / "bestModel.bin"
    jbest = J.ser.restore_model(str(path))
    x = _data(16, 9).features
    np.testing.assert_array_equal(np.asarray(jbest.params()),
                                  result.best_model.params())
    np.testing.assert_allclose(np.asarray(jbest.output(x)),
                               result.best_model.output(x), rtol=1e-6,
                               atol=1e-6)


def _recording(saver):
    """Record the parameters the trainer hands `saver` as its best."""
    seen = []
    save = saver.save_best_model

    def save_best_model(net, score):
        seen.append(net.params().copy())
        save(net, score)

    saver.save_best_model = save_best_model
    return seen


def test_sharded_saver_in_early_stopping(tmp_path):
    """As the reference's tests/test_sharded_checkpoint.py:163-185, plus:
    the restored best model holds the best epoch's parameters bit for bit,
    and the latest model the last epoch's."""
    def net_factory():
        return _mln(seed=11, n_in=5, width=16)

    train = ListDataSetIterator(list(_data(64, 1, n_in=5).batch_by(16)))
    val = ListDataSetIterator(list(_data(32, 2, n_in=5).batch_by(16)))
    saver = ShardedModelSaver(str(tmp_path), net_factory)
    seen = _recording(saver)
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(DataSetLossCalculator(val))
          .epoch_termination_conditions(MaxEpochsTerminationCondition(3))
          .model_saver(saver).save_last_model(True).build())
    net = net_factory()
    result = EarlyStoppingTrainer(es, net, train).fit()
    best = result.get_best_model()
    assert best is not None
    assert (tmp_path / "bestModel").exists()
    assert np.asarray(best.output(_data(32, n_in=5).features)).shape == \
        (32, 3)
    assert seen
    np.testing.assert_array_equal(best.params(), seen[-1])
    np.testing.assert_array_equal(saver.get_latest_model().params(),
                                  net.params())


def test_early_stopping_over_training_master():
    def net():
        conf = (NeuralNetConfiguration.Builder().seed(7).updater("adam")
                .learning_rate(0.01).list()
                .layer(0, DenseLayer(n_out=16, activation="relu"))
                .layer(1, OutputLayer(n_out=3, activation="softmax",
                                      loss_function="mcxent"))
                .set_input_type(InputType.feed_forward(5)).build())
        return MultiLayerNetwork(conf, device="cpu").init()

    def data(n, seed):
        r = np.random.default_rng(seed)
        x = r.random((n, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.argmax(x @ r.random((5, 3)), 1)]
        return DataSet(x, y)

    model = net()
    train = data(256, 0)
    holdout = ListDataSetIterator(list(data(96, 1).batch_by(32)))
    tm = (ParameterAveragingTrainingMaster.Builder(batch_size_per_worker=8)
          .averaging_frequency(2).rdd_training_approach("direct").build())
    assert tm.num_workers == 1
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(MasterDataSetLossCalculator(holdout,
                                                        num_shards=4))
          .epoch_termination_conditions(
              MaxEpochsTerminationCondition(8),
              ScoreImprovementEpochTerminationCondition(2, 0.0))
          .build())
    result = TpuEarlyStoppingTrainer(es, tm, model, train).fit()
    assert result.termination_reason == "EpochTerminationCondition"
    assert result.total_epochs <= 8
    assert result.best_model is not None
    assert np.isfinite(result.best_model_score)
    # one epoch is one execute_training pass: 256 rows in rounds of 2
    # batches of 8
    assert model.conf.iteration_count == 32 * result.total_epochs
    best = result.get_best_model()
    holdout.reset()
    assert (MasterDataSetLossCalculator(holdout, num_shards=4)
            .calculate_score(best)) <= result.score_vs_epoch[0] + 1e-6
    assert SparkEarlyStoppingTrainer is TpuEarlyStoppingTrainer


@pytest.mark.parametrize("k", [1, 2])
def test_parallel_trainer_is_the_trainer_on_one_rank(k):
    def run(parallel):
        train, val = _iters()
        es = (EarlyStoppingConfiguration.Builder()
              .score_calculator(DataSetLossCalculator(val))
              .epoch_termination_conditions(MaxEpochsTerminationCondition(3))
              .build())
        net = _mln(seed=5)
        if parallel:
            trainer = EarlyStoppingParallelTrainer(
                es, net, train, averaging_frequency=k)
            assert trainer.wrapper.averaging_frequency == k
        else:
            trainer = EarlyStoppingTrainer(es, net, train)
        return trainer.fit(), net

    (want, wnet), (got, gnet) = run(False), run(True)
    assert got.score_vs_epoch == want.score_vs_epoch
    assert (got.best_model_epoch, got.termination_details,
            got.total_epochs) == (want.best_model_epoch,
                                  want.termination_details, 3)
    np.testing.assert_array_equal(gnet.params(), wnet.params())
    assert gnet.conf.iteration_count == 12


def test_parallel_trainer_tensor_parallel_raises_naming_item_20():
    train, _ = _iters()
    es = EarlyStoppingConfiguration.Builder().build()
    with pytest.raises(NotImplementedError, match="item 20$"):
        EarlyStoppingParallelTrainer(es, _mln(), train, tensor_parallel=True)


@pytest.mark.gpu
def test_local_file_saver_restores_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    conf = _mln().conf
    net = MultiLayerNetwork(conf.clone(), device="cuda").init()
    train, val = _iters()
    es = (EarlyStoppingConfiguration.Builder()
          .score_calculator(DataSetLossCalculator(val))
          .epoch_termination_conditions(MaxEpochsTerminationCondition(2))
          .model_saver(LocalFileModelSaver(tmp_path)).build())
    best = EarlyStoppingTrainer(es, net, train).fit().get_best_model()
    assert best.device.type == "cuda"
