"""The port's TrainingMaster (`parallel/training_master.py`), its hooks
(`training_hook.py`) and time sources (`time_source.py`) against the JAX
package's.

Two ranks: one module fixture starts 2 gloo CPU processes (a FileStore
under the tmp dir; 60 s group timeout, 120 s to finish, then killed and
failed), each running this file as a script: `TpuDl4jMultiLayer` over a
`ParameterAveragingTrainingMaster` (workers = the group's 2 ranks, 8 rows
a worker, averaging frequency 2), "direct" and "export", two epochs. The
reference runs the same master on 2 of conftest's virtual devices, its
k-step program with shard_map's check_vma=False (see
tests/test_torch_parallel_wrapper.py). Held: the parameters within
tests/test_parallel.py's rtol=2e-4, atol=2e-5 (read: 2.4e-7), the
iteration count equal, both ranks bit-equal, the same export files.

In this process, the reference's contracts (tests/test_training_master.py)
rebuilt on one rank: training and the stats timeline, "export" streaming
from disk without merging the source, masks through the files, iterators
and `evaluate`, the JSON (the port's `to_json` string equals the
reference's), the HTML export, observer hooks around each split, the
parameter-server hook training through the master (direct and export),
and a failed split leaving the network at the last averaged state. The
time sources against the reference's on a localhost SNTP responder. Paths
not ported yet raise naming their ROADMAP.md item.
"""
import json
import os
import pickle
import socket
import struct
import sys
import threading
import time
import types
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParameterAveragingTrainingMaster, ParameterServerTrainingHook,
    TpuComputationGraph, TpuDl4jMultiLayer, TrainingHook)
from deeplearning4j_tpu_torch.parallel import time_source as TS

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 120
RTOL, ATOL = 2e-4, 2e-5


def _net(seed=7):
    """tests/test_training_master.py's net, on the port (CPU)."""
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater("adam").learning_rate(0.01).list()
            .layer(0, L.DenseLayer(n_out=16, activation="relu"))
            .layer(1, L.OutputLayer(n_out=3, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=256, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n, 5)).astype(np.float32)
    w = r.random((5, 3))
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return DataSet(x, y)


def _master(approach="direct", workers=None, export_dir=None, hook=None,
            stats=False):
    b = (ParameterAveragingTrainingMaster.Builder(batch_size_per_worker=8)
         .averaging_frequency(2).rdd_training_approach(approach)
         .collect_training_stats(stats))
    if workers is not None:
        b = b.workers(workers)
    if export_dir is not None:
        b = b.export_directory(str(export_dir))
    if hook is not None:
        b = b.training_hook(hook)
    return b.build()


# ------------------------------------------------------------ two ranks

@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu import (InputType as JInputType,
                                    MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.parallel import training_master as jtm
    from deeplearning4j_tpu.parallel import make_mesh as jmesh
    from deeplearning4j_tpu.parallel import time_source as jts
    return types.SimpleNamespace(jax=jax, Net=JNet, Conf=JConf, L=JL,
                                 InputType=JInputType, DataSet=JDataSet,
                                 tm=jtm, make_mesh=jmesh, ts=jts)


def _reference_net(J, seed=21):
    conf = (J.Conf.Builder().seed(seed).updater("nesterovs")
            .learning_rate(0.05).list()
            .layer(0, J.L.DenseLayer(n_out=16, activation="relu"))
            .layer(1, J.L.OutputLayer(n_out=3, activation="softmax",
                                      loss_function="mcxent"))
            .set_input_type(J.InputType.feed_forward(5)).build())
    return J.Net(conf).init()


def _rank_run(spec, approach, out_dir):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(spec["conf"]),
                            device="cpu").init()
    net.from_jax_params(spec["params"], spec["state"], spec["ustate"])
    tm = _master(approach, export_dir=(Path(out_dir) / f"export_{approach}"
                                       f"_{dist.get_rank()}"
                                       if approach == "export" else None),
                 stats=True)
    TpuDl4jMultiLayer(net, tm).fit(_data(), num_epochs=2)
    return {"params": net.params(), "iterations": net.conf.iteration_count,
            "workers": tm.num_workers,
            "phases": sorted({e["phase"] for e in tm.stats.events}),
            "files": (len(os.listdir(tm.export_dir)) if tm.export_dir
                      else None)}


def _rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    with open(Path(out_dir) / "spec.pkl", "rb") as fh:
        spec = pickle.load(fh)
    res = {a: _rank_run(spec, a, out_dir) for a in ("direct", "export")}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(res, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(J, tmp_path_factory):
    from test_torch_parallel_wrapper import (join_ranks,
                                             reference_kstep_as_written,
                                             start_ranks)
    tmp = tmp_path_factory.mktemp("tm")
    jnets = {a: _reference_net(J) for a in ("direct", "export")}
    tree = lambda t: J.jax.tree.map(np.array, t)  # noqa: E731
    j0 = jnets["direct"]
    with open(tmp / "spec.pkl", "wb") as fh:
        pickle.dump({"conf": j0.conf.to_json(), "params": tree(j0._params),
                     "state": tree(j0._model_state),
                     "ustate": tree(j0._updater_state)}, fh)
    procs, logs = start_ranks(WORLD, tmp, script=__file__)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    ref = {}
    try:
        ds = _data()
        with reference_kstep_as_written():
            for a, jnet in jnets.items():
                tm = (J.tm.ParameterAveragingTrainingMaster.Builder(8)
                      .workers(WORLD).averaging_frequency(2)
                      .rdd_training_approach(a)
                      .mesh(J.make_mesh(n_data=WORLD,
                                        devices=J.jax.devices()[:WORLD])))
                if a == "export":
                    tm = tm.export_directory(str(tmp / "ref_export"))
                tm = tm.build()
                J.tm.TpuDl4jMultiLayer(jnet, tm).fit(
                    J.DataSet(ds.features, ds.labels), num_epochs=2)
                ref[a] = {"params": np.asarray(jnet.params()),
                          "iterations": jnet.conf.iteration_count,
                          "files": (len(os.listdir(tmp / "ref_export"))
                                    if a == "export" else None)}
    finally:
        ranks = join_ranks(procs, logs, tmp, deadline)
    return ref, ranks


@pytest.mark.parametrize("approach", ["direct", "export"])
def test_two_ranks_match_the_reference_master(runs, approach):
    ref, ranks = runs
    port = ranks[0][approach]
    np.testing.assert_array_equal(port["params"], ranks[1][approach]["params"])
    np.testing.assert_allclose(port["params"], ref[approach]["params"],
                               rtol=RTOL, atol=ATOL)
    assert port["iterations"] == ref[approach]["iterations"] == 2 * 16
    assert port["workers"] == WORLD
    assert port["files"] == ref[approach]["files"]
    assert port["phases"] == (["export", "fit"] if approach == "export"
                              else ["fit", "split"])


# ------------------------------------------------------ one rank, here

def test_training_master_trains_and_records_stats():
    net = _net()
    tm = _master(stats=True)
    assert tm.num_workers == 1            # workers=None: the group's size
    ds = _data()
    s0 = net.score(ds)
    TpuDl4jMultiLayer(net, tm).fit(ds, num_epochs=3)
    assert net.score(ds) < s0
    assert {e["phase"] for e in tm.stats.events} == {"split", "fit"}
    assert tm.stats.phase_total("fit") > 0
    # 256 examples, splits of 8 x 2: 16 rounds of 2 steps an epoch
    assert net.conf.iteration_count == 3 * 32


def test_training_master_export_approach_streams_from_disk(tmp_path):
    """The reference's default approach: the source streams once into one
    file per global batch; the whole dataset is never merged in RAM."""
    net = _net()
    tm = (ParameterAveragingTrainingMaster.Builder(batch_size_per_worker=32)
          .averaging_frequency(2).collect_training_stats(True)
          .export_directory(str(tmp_path / "export")).build())
    assert tm.approach == "export"
    full = _data(480, seed=3)
    slices = list(full.batch_by(24))
    produced = {"n": 0}

    class GenIterator:
        def __init__(self):
            self._i = 0

        def reset(self):
            self._i = 0

        def has_next(self):
            return self._i < len(slices)

        def next_batch(self):
            ds = slices[self._i]
            self._i += 1
            produced["n"] += 1
            return ds

    called = []
    orig = ParameterAveragingTrainingMaster._collect_examples
    ParameterAveragingTrainingMaster._collect_examples = staticmethod(
        lambda data: called.append(1) or orig(data))
    try:
        s0 = net.score(full)
        TpuDl4jMultiLayer(net, tm).fit(GenIterator(), num_epochs=3)
    finally:
        ParameterAveragingTrainingMaster._collect_examples = staticmethod(
            orig)
    assert not called
    assert len(os.listdir(tmp_path / "export")) == 15   # 480 / 32
    assert produced["n"] == 20                          # exported once
    assert net.score(full) < s0
    assert {e["phase"] for e in tm.stats.events} == {"export", "fit"}


def test_training_master_export_round_trips_masks(tmp_path):
    ds = DataSet(np.ones((4, 3, 2), np.float32),
                 np.ones((4, 3, 2), np.float32),
                 np.ones((4, 3), np.float32),
                 np.zeros((4, 3), np.float32))
    p = tmp_path / "ds.npz"
    ds.save(p)
    back = DataSet.load(p)
    assert back.features_mask.shape == (4, 3)
    assert back.labels_mask.sum() == 0
    assert DataSet.merge([ds, back]).features_mask.shape == (8, 3)


def test_training_master_iterator_and_eval():
    net = _net()
    master = TpuDl4jMultiLayer(net, _master())
    master.fit(ListDataSetIterator(list(_data().batch_by(64))), num_epochs=3)
    ev = master.evaluate(list(_data(128, seed=9).batch_by(64)))
    assert ev.accuracy() > 0.5
    assert master.get_network() is net and TpuComputationGraph is \
        TpuDl4jMultiLayer


def test_training_master_json_equals_the_reference(J):
    tm = (ParameterAveragingTrainingMaster.Builder(batch_size_per_worker=32)
          .workers(4).averaging_frequency(3).export_directory("/x").build())
    jtm = (J.tm.ParameterAveragingTrainingMaster.Builder(32).workers(4)
           .averaging_frequency(3).export_directory("/x").build())
    assert tm.to_json() == jtm.to_json()
    d = json.loads(tm.to_json())
    tm2 = ParameterAveragingTrainingMaster.from_json(tm.to_json())
    assert (tm2.batch_size, tm2.averaging_frequency, tm2.num_workers) == \
        (32, 3, 4)
    assert d["type"] == "ParameterAveragingTrainingMaster"
    assert tm2.to_json() == J.tm.ParameterAveragingTrainingMaster.from_json(
        jtm.to_json()).to_json()


def test_stats_html_export(tmp_path):
    net = _net()
    tm = _master(stats=True)
    TpuDl4jMultiLayer(net, tm).fit(_data(64))
    p = tmp_path / "stats.html"
    tm.stats.export_html(str(p))
    assert "Training phases" in p.read_text()


def test_observer_hook_fires_around_splits():
    calls = []

    class Recorder(TrainingHook):
        def pre_update(self, mb, model):
            calls.append("pre")

        def post_update(self, mb, model):
            calls.append("post")

    tm = _master(hook=Recorder())
    tm.execute_training(_net(), _data())
    assert calls and calls.count("pre") == calls.count("post") == 16


def test_parameter_server_hook_trains_through_master():
    net = _net()
    hook = ParameterServerTrainingHook(workers=3, queue_size=8,
                                       max_staleness=4)
    tm = _master(workers=4, hook=hook)     # the hook trains: no group
    ds = _data()
    s0 = net.score(ds)
    it_before = net.conf.iteration_count
    tm.execute_training(net, ds)
    assert (net.conf.iteration_count - it_before
            == hook.last_stats["applied"])
    for _ in range(2):
        tm.execute_training(net, ds)
    assert net.score(ds) < s0
    assert hook.last_stats["applied"] > 0


def test_parameter_server_hook_export_path(tmp_path):
    net = _net()
    hook = ParameterServerTrainingHook(workers=2)
    tm = _master("export", workers=4, export_dir=tmp_path / "exp",
                 hook=hook)
    ds = _data()
    s0 = net.score(ds)
    tm.execute_training(net, ds)
    tm.execute_training(net, ds)
    assert net.score(ds) < s0
    assert hook.last_stats["applied"] > 0


def test_split_failure_recovery_semantics():
    """A split that fails leaves the network at the last completed split's
    averaged state (a twin that runs only that split reaches it), and a
    re-run keeps training."""
    net = _net()
    tm = _master()
    ds = _data()
    tm.execute_training(net, ds)
    p_after = net.params().copy()
    it_after = net.conf.iteration_count
    twin = net.clone()

    calls = {"n": 0}
    orig = tm._train_split

    def failing(net_, batches, hook, hook_trains):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected worker failure")
        return orig(net_, batches, hook, hook_trains)

    tm._train_split = failing
    with pytest.raises(RuntimeError, match="injected"):
        tm.execute_training(net, ds)
    assert net.conf.iteration_count > it_after

    tm2 = ParameterAveragingTrainingMaster.from_json(tm.to_json())
    calls2 = {"n": 0}
    orig2 = tm2._train_split

    def one_split(net_, batches, hook, hook_trains):
        calls2["n"] += 1
        if calls2["n"] == 2:
            raise RuntimeError("stop after first split")
        return orig2(net_, batches, hook, hook_trains)

    tm2._train_split = one_split
    with pytest.raises(RuntimeError, match="stop after"):
        tm2.execute_training(twin, ds)
    np.testing.assert_array_equal(net.params(), twin.params())

    tm._train_split = orig
    s_before = net.score(ds)
    tm.execute_training(net, ds)
    assert net.score(ds) < s_before
    assert not np.allclose(net.params(), p_after)


def test_unported_master_paths_raise_with_their_items():
    b = ParameterAveragingTrainingMaster.Builder(8)
    with pytest.raises(NotImplementedError, match="item 20$"):
        b.checkpoint_directory("/unused")
    with pytest.raises(NotImplementedError, match="item 17$"):
        b.health_policy(True)
    with pytest.raises(NotImplementedError, match="item 20$"):
        ParameterAveragingTrainingMaster(checkpoint_dir="/unused")
    with pytest.raises(NotImplementedError, match="item 17$"):
        ParameterAveragingTrainingMaster(health_policy=True)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        _master(workers=2).execute_training(_net(), _data())


# -------------------------------------------------------- time sources

class _SntpResponder:
    """An SNTP server on 127.0.0.1 that answers every request with the
    local clock moved by `offset_s` (RFC 4330 receive/transmit times)."""

    def __init__(self, offset_s):
        self.offset_s = offset_s
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                _, addr = self.sock.recvfrom(512)
            except OSError:
                continue
            t = time.time() + self.offset_s + 2208988800
            s, f = int(t), int((t % 1) * 2 ** 32)
            reply = bytearray(48)
            reply[0] = 0x1C
            reply[32:40] = struct.pack("!II", s, f)
            reply[40:48] = struct.pack("!II", s, f)
            self.sock.sendto(bytes(reply), addr)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.sock.close()


def test_time_sources_match_the_reference(J):
    srv = _SntpResponder(offset_s=12.5)
    try:
        port_off = TS.sntp_offset_millis("127.0.0.1", srv.port)
        ref_off = J.ts.sntp_offset_millis("127.0.0.1", srv.port)
        assert abs(port_off - 12500) < 250 and abs(ref_off - 12500) < 250
        ntp = TS.NTPTimeSource("127.0.0.1", srv.port, timeout=1.0)
        assert abs(ntp.offset_millis() - 12500) < 250
        assert abs(ntp.current_time_millis() - time.time() * 1000
                   - 12500) < 500
    finally:
        srv.close()
    sys_ms = TS.SystemClockTimeSource().currentTimeMillis()
    assert abs(sys_ms - time.time() * 1000) < 1000
    # a server that does not answer: the system clock, offset 0, as the
    # reference falls back
    dead = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dead.bind(("127.0.0.1", 0))
    try:
        quiet = TS.NTPTimeSource("127.0.0.1", dead.getsockname()[1],
                                 timeout=0.2)
        assert quiet.offset_millis() == 0.0
    finally:
        dead.close()
    with pytest.raises(NotImplementedError):
        TS.TimeSource().current_time_millis()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
