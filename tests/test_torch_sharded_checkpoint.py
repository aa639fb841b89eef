"""The port's training-state checkpoints (`util/sharded_checkpoint.py`,
replicated state: one process's, or a data-parallel group's) held to the
contracts of the reference's tests/test_sharded_checkpoint.py and its
crash-resume flows.

The port's format is its own (`torch.save` of the whole state under a
temporary name, then `os.replace`), not orbax's. Pinned here: a save and a
restore into a fresh net of another seed continue bit for bit (parameters,
Adam's moments and step, BatchNorm's statistics, the counters and the
dropout generator's stream: the net draws dropout masks); re-saving a
fixed path overwrites, `overwrite=False` raises; a ComputationGraph round
trip; `ShardedCheckpointManager`'s retention (`keep_last` plus the best,
in both modes), its metadata reloaded by a new manager, the refusal of
another retention policy, a score-less re-save keeping the score, the
sweep of orphaned checkpoints and of partial saves; a checkpoint of
another architecture refused, naming the mismatched arrays.

On 2 gloo CPU ranks (this file run as a script by a module fixture,
joined through a FileStore; 120 s to finish): `ParallelWrapper` with
`.checkpointing()` in all-reduce mode and with k = 2, and the TrainingMaster
with a checkpoint directory, each crashed by a FaultInjector at a round
("wrapper.round", "master.round"), then re-run on a fresh network over the
same directory: it resumes from the last completed round and ends bit-equal
to the uninterrupted run, on both ranks.
"""
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.common.resilience import (FaultInjected,
                                                        FaultInjector)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BatchNormalization,
                                                    DenseLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, ParameterAveragingTrainingMaster)
from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
    RoundCheckpointer, ShardedCheckpointManager, load_checkpoint,
    save_checkpoint)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 120


def _net(seed=11, n_out=16, dropout=0.8, bn=True):
    b = (NeuralNetConfiguration.Builder().seed(seed).updater("adam")
         .learning_rate(0.05))
    if dropout is not None:
        b = b.dropout(dropout)
    lb = b.list().layer(0, DenseLayer(n_out=n_out, activation="relu"))
    i = 1
    if bn:
        lb = lb.layer(1, BatchNormalization())
        i = 2
    conf = (lb.layer(i, OutputLayer(n_out=3, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=64, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, n)]
    return DataSet(x, y)


def _same(a, b):
    np.testing.assert_array_equal(a.params(), b.params())
    for key, _ in a._keyed_layers():
        for k, st in a._updater_state[key].items():
            for n, t in st.items():
                assert torch.equal(t, b._updater_state[key][k][n])
        for n, t in a._slot(key).state().items():
            assert torch.equal(t, b._slot(key).state()[n])
    assert a.conf.iteration_count == b.conf.iteration_count


def test_exact_resume_round_trip(tmp_path):
    ds = _data()
    a = _net()
    for _ in range(5):
        a.fit(ds)
    save_checkpoint(a, tmp_path / "ck")
    b = load_checkpoint(_net(seed=99), tmp_path / "ck")
    _same(a, b)
    assert float(b._score) == float(a._score)
    assert torch.equal(b._dropout_gen.get_state(), a._dropout_gen.get_state())
    for _ in range(3):
        a.fit(ds)
        b.fit(ds)
        assert float(a._score) == float(b._score)
    _same(a, b)
    assert a.conf.epoch_count == b.conf.epoch_count


def test_fixed_path_periodic_resave(tmp_path):
    ds = _data()
    a = _net()
    a.fit(ds)
    save_checkpoint(a, tmp_path / "latest")
    a.fit(ds)
    save_checkpoint(a, tmp_path / "latest")      # overwrite, no raise
    b = load_checkpoint(_net(seed=2), tmp_path / "latest")
    assert b.conf.iteration_count == a.conf.iteration_count == 2
    with pytest.raises(ValueError):
        save_checkpoint(a, tmp_path / "latest", overwrite=False)
    assert sorted(os.listdir(tmp_path)) == ["latest"]   # no temporary left


def test_unfitted_net_round_trip(tmp_path):
    a = _net()
    save_checkpoint(a, tmp_path / "ck")
    b = load_checkpoint(_net(seed=5), tmp_path / "ck")
    _same(a, b)
    assert b._score is None


def test_computation_graph_round_trip(tmp_path):
    def build(seed=3):
        conf = (NeuralNetConfiguration.Builder().seed(seed)
                .updater("adam").learning_rate(0.05).graph_builder()
                .add_inputs("in")
                .add_layer("d1", DenseLayer(n_out=8, activation="tanh"),
                           "in")
                .add_layer("d2", DenseLayer(n_out=8, activation="relu"),
                           "in")
                .add_vertex("m", MergeVertex(), "d1", "d2")
                .add_layer("out", OutputLayer(
                    n_out=3, activation="softmax",
                    loss_function="mcxent"), "m")
                .set_outputs("out")
                .set_input_types(InputType.feed_forward(5)).build())
        return ComputationGraph(conf, device="cpu").init()

    ds = _data()
    a = build()
    for _ in range(4):
        a.fit(ds)
    save_checkpoint(a, tmp_path / "ck")
    b = load_checkpoint(build(seed=77), tmp_path / "ck")
    for _ in range(2):
        a.fit(ds)
        b.fit(ds)
        assert float(a._score) == float(b._score)
    _same(a, b)


def test_checkpoint_manager_retention(tmp_path):
    ds = _data()
    net = _net()
    mgr = ShardedCheckpointManager(tmp_path / "ckpts", keep_last=2,
                                   mode="min")
    scores = {1: 0.10, 2: 0.50, 3: 0.40, 4: 0.60, 5: 0.70}
    for step, score in scores.items():
        net.fit(ds)
        mgr.save(net, step, score=score)
    assert mgr.steps() == [1, 4, 5]          # the last 2 and the best
    assert mgr.best_step() == 1 and mgr.latest_step() == 5
    kept = sorted(d for d in os.listdir(tmp_path / "ckpts")
                  if d.startswith("ckpt_"))
    assert kept == ["ckpt_1", "ckpt_4", "ckpt_5"]
    b = mgr.restore_latest(_net(seed=2))
    assert b.conf.iteration_count == net.conf.iteration_count
    best = mgr.restore_best(_net(seed=3))
    assert best.conf.iteration_count == 1
    mgr2 = ShardedCheckpointManager(tmp_path / "ckpts", keep_last=2)
    assert mgr2.steps() == [1, 4, 5] and mgr2.best_step() == 1
    with pytest.raises(ValueError, match="mode"):
        ShardedCheckpointManager(tmp_path / "ckpts", keep_last=2,
                                 mode="max")
    with pytest.raises(ValueError, match="keep_last"):
        ShardedCheckpointManager(tmp_path / "ckpts", keep_last=4)
    net.fit(ds)
    mgr2.save(net, 1)                       # score-less re-save
    assert mgr2.best_step() == 1
    # orphans: a checkpoint the metadata does not name (a crash between the
    # metadata write and the delete) and a partial save's temporary
    (tmp_path / "ckpts" / "ckpt_99").write_bytes(b"stale")
    (tmp_path / "ckpts" / "ckpt_7.tmp-4242").write_bytes(b"partial")
    os.makedirs(tmp_path / "ckpts" / "ckpt_98")
    net.fit(ds)
    mgr2.save(net, 6, score=0.8)
    left = sorted(os.listdir(tmp_path / "ckpts"))
    assert left == ["ckpt_1", "ckpt_5", "ckpt_6", "manager.json"]


def test_best_step_in_max_mode(tmp_path):
    ds = _data()
    net = _net()
    mgr = ShardedCheckpointManager(tmp_path / "m", keep_last=1, mode="max")
    for step, score in ((1, 0.9), (2, 0.3), (3, 0.9), (4, None), (5, 0.2)):
        net.fit(ds)
        mgr.save(net, step, score=score)
    assert mgr.best_step() == 3              # the latest wins ties
    assert mgr.steps() == [3, 5]
    empty = ShardedCheckpointManager(tmp_path / "e")
    assert empty.latest_step() is None and empty.best_step() is None
    with pytest.raises(FileNotFoundError):
        empty.restore_latest(net)
    with pytest.raises(FileNotFoundError):
        empty.restore_best(net)
    with pytest.raises(ValueError):
        ShardedCheckpointManager(tmp_path / "x", mode="median")


def test_restore_refuses_another_architecture(tmp_path):
    a = _net(n_out=16)
    save_checkpoint(a, tmp_path / "ck")
    with pytest.raises(ValueError, match=r"target architecture .*params\[0\]"
                                         r"\[W\]: saved \(5, 16\) vs net "
                                         r"\(5, 8\)"):
        load_checkpoint(_net(n_out=8), tmp_path / "ck")
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(_net(bn=False), tmp_path / "ck")


def test_round_checkpointer_resumes_only_a_fresh_net(tmp_path):
    ds = _data()
    net = _net()
    gate = RoundCheckpointer(tmp_path / "r", every=2)
    for _ in range(5):
        assert gate.round_starts()
        net.fit(ds)
        gate.round_done(net)
    assert gate.manager().steps() == [2, 4]
    fresh, warm = _net(seed=3), _net(seed=3)
    warm.fit(ds)
    g2, g3 = RoundCheckpointer(tmp_path / "r"), RoundCheckpointer(
        tmp_path / "r")
    g2.maybe_resume(fresh)
    g3.maybe_resume(warm)            # a warm net continues in process
    assert (g2.resume_round, fresh.conf.iteration_count) == (4, 4)
    assert (g3.resume_round, warm.conf.iteration_count) == (0, 1)
    assert [g2.round_starts() for _ in range(5)] == [False] * 4 + [True]
    plain = RoundCheckpointer(None)
    plain.maybe_resume(fresh)
    assert plain.manager() is None and plain.round_starts()


# ----------------------------------------------------------- 2 gloo ranks

def _crash_and_resume(tmp, name, make_trainer, run):
    """The uninterrupted run's and the resumed run's readings: the resumed
    run crashed before its third round, then ran again on a fresh net over
    the same checkpoint directory."""
    ref = _net(seed=21, dropout=None)
    run(make_trainer(None, None), ref)
    crashed = _net(seed=21, dropout=None)
    try:
        run(make_trainer(tmp / name, 2), crashed)
        raise AssertionError("the injected crash did not happen")
    except FaultInjected:
        pass
    resumed = _net(seed=21, dropout=None)
    run(make_trainer(tmp / name, None), resumed)
    return {"ref": ref.params(), "resumed": resumed.params(),
            "crashed_iterations": crashed.conf.iteration_count,
            "iterations": (ref.conf.iteration_count,
                           resumed.conf.iteration_count)}


def _wrapper_resume(tmp, k):
    batches = list(_data(128, seed=22).batch_by(16))

    def make(ckpt, crash_at):
        def build(net):
            b = ParallelWrapper.Builder(net).workers(
                WORLD).averaging_frequency(k)
            if ckpt is not None:
                b = b.checkpointing(str(ckpt))
            if crash_at is not None:
                b = b.fault_injector(FaultInjector(seed=0).plan(
                    "wrapper.round", on_call=crash_at))
            return b.build()
        return build

    def run(build, net):
        build(net).fit(ListDataSetIterator(batches))

    return _crash_and_resume(tmp, f"pw{k}", make, run)


def _master_resume(tmp):
    ds = _data(128, seed=23)

    def make(ckpt, crash_at):
        b = (ParameterAveragingTrainingMaster.Builder(8).workers(WORLD)
             .averaging_frequency(2).rdd_training_approach("direct"))
        if ckpt is not None:
            b = b.checkpoint_directory(str(ckpt))
        if crash_at is not None:
            b = b.fault_injector(FaultInjector(seed=0).plan(
                "master.round", on_call=crash_at))
        return b

    def run(builder, net):
        builder.build().execute_training(net, ds)

    return _crash_and_resume(tmp, "tm", make, run)


def _rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    tmp = Path(out_dir)
    out = {"wrapper_k1": _wrapper_resume(tmp, 1),
           "wrapper_k2": _wrapper_resume(tmp, 2),
           "master": _master_resume(tmp)}
    with open(tmp / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(tmp / "store"),
         str(tmp)], env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, "\n".join(
        f"rank {r} exit {c}:\n{(tmp / f'rank{r}.log').read_text()[-3000:]}"
        for r, c in enumerate(codes))
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


@pytest.mark.parametrize("case,rounds,steps", [
    ("wrapper_k1", 8, 8), ("wrapper_k2", 4, 8), ("master", 4, 8)])
def test_crash_resume_is_bit_comparable_on_two_ranks(ranks, case, rounds,
                                                     steps):
    for res in ranks:
        r = res[case]
        assert r["iterations"] == (steps, steps)
        # the crash came before round 3 trained: 2 rounds were done
        assert r["crashed_iterations"] == 2 * steps // rounds
        np.testing.assert_array_equal(r["resumed"], r["ref"])
    np.testing.assert_array_equal(ranks[0][case]["resumed"],
                                  ranks[1][case]["resumed"])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
