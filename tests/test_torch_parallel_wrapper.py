"""The port's ParallelWrapper (`parallel/parallel_wrapper.py`, `sharding.py`,
the containers' `make_grad_fn` / `make_apply_fn` and the group BatchNorm)
against the JAX package's.

The JAX side runs the reference wrapper on 2 of tests/conftest.py's 8
virtual CPU devices (`make_mesh(n_data=2, devices=jax.devices()[:2])`,
passed through `.mesh(...)`). The port runs as real ranks: one module
fixture starts 2 CPU processes, joined in a gloo group through a FileStore
under the test's tmp dir, each running this file as a script. The JAX
package draws every network's weights; the ranks load them with
`from_jax_params` (never re-drawn). Every case trains the same global
batches on both sides: one first round (one batch in all-reduce mode, k
batches in k-step mode), then 3 epochs.

Cases (the nets of tests/test_parallel.py:22-32, 95-107 and variants):
MultiLayerNetwork and ComputationGraph in all-reduce mode and with k = 4;
a dense net with BatchNorm (the fused backward) and a conv net with
BatchNorm (autodiff through two-pass statistics) in all-reduce mode; a
net whose gradients are clipped (ClipL2PerLayer); k = 2 with Nesterov
momentum and `average_updaters(False)`; a ragged k = 4 epoch (a tail batch
padded by wrapping its rows, then a short last round).

The reference's k-step program is run with shard_map's `check_vma=False`
(the `check_rep=False` semantics it was written for). Under JAX 0.9's
default, `check_vma=True`, the transpose of the replicated parameters'
implicit `pvary` psums each local step's gradient over "data": its "k
local steps" become synchronised steps on the SUM of the devices'
gradients (twice the mean at n = 2), and the parameter average a no-op
(ROADMAP.md queue 3 records it). The port keeps the documented contract:
local steps, then the average; on one device the two readings agree.

Held: parameters after the first round within 1e-5; after 3 epochs within
the reference's own rtol=2e-4, atol=2e-5 (tests/test_parallel.py:77-78);
the score within 1e-5; iteration_count and the global batch size equal;
both ranks' parameters bit-equal. Two controls run on the ranks with one
fault put in on purpose, and must miss the reference by more than the
tolerance: the BatchNorm nets with rank-local statistics, and the clipped
net with each rank's gradient clipped before the all-reduce. So these
tests fail if the port's statistics are rank-local or its clip comes first.

In the pytest process: `make_grad_fn` / `make_apply_fn` against the
reference's on one batch (1e-5); a one-rank wrapper is plain `fit`, bit
for bit, in both modes (MultiLayerNetwork with BatchNorm, and a graph);
the fault-injection sites fire as the reference's do; the paths not
ported yet raise naming their ROADMAP.md item.

The group has a 60 s timeout and the ranks 150 s to finish; then they are
killed and the fixture fails, so a hang fails the tests instead of running
the suite into its time limit.
"""
import contextlib
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

from deeplearning4j_tpu_torch.common.resilience import FaultInjector
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
    ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import updaters as U
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.parallel import sharding
from deeplearning4j_tpu_torch.parallel.parameter_server import ps_batch
from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
    RoundCheckpointer

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 150
TOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5            # tests/test_parallel.py:77-78
EPOCHS = 3


# ------------------------------------------------------------------ nets

def blob_data(n, seed=0, n_in=4):
    """tests/test_parallel.py's blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, (3, n_in))
    c = rng.integers(0, 3, n)
    x = (centers[c] + rng.normal(0, 0.5, (n, n_in))).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[c]


def image_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, (n, 6, 6, 2)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


def reference_net(kind, seed):
    """The JAX package's network of a case."""
    from deeplearning4j_tpu import (InputType, MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration)
    from deeplearning4j_tpu.nn.conf import layers as L
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    b = NeuralNetConfiguration.Builder().seed(seed)
    out = L.OutputLayer(n_out=3, activation="softmax", loss_function="mcxent")
    if kind == "cg":
        conf = (b.learning_rate(0.2).updater("sgd").graph_builder()
                .add_inputs("in")
                .add_layer("h", L.DenseLayer(n_out=16, activation="relu"),
                           "in")
                .add_layer("out", out, "h").set_outputs("out")
                .set_input_types(InputType.feed_forward(4)).build())
        return JGraph(conf).init()
    if kind == "mln":
        b = b.learning_rate(0.2).updater("sgd").list().layer(
            0, L.DenseLayer(n_out=16, activation="relu")).layer(1, out)
    elif kind == "bn":
        b = (b.learning_rate(0.1).updater("sgd").list()
             .layer(0, L.DenseLayer(n_out=8, activation="identity"))
             .layer(1, L.BatchNormalization())
             .layer(2, out))
    elif kind == "conv_bn":
        b = (b.learning_rate(0.1).updater("sgd").list()
             .layer(0, L.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                          activation="identity"))
             .layer(1, L.BatchNormalization(fused_backward=False,
                                            use_fast_variance=False))
             .layer(2, out))
    elif kind == "clip":
        b = (b.learning_rate(0.5).updater("sgd")
             .gradient_normalization("ClipL2PerLayer")
             .gradient_normalization_threshold(0.05).list()
             .layer(0, L.DenseLayer(n_out=16, activation="relu"))
             .layer(1, out))
    elif kind == "momentum":
        b = (b.learning_rate(0.1).updater("nesterovs").list()
             .layer(0, L.DenseLayer(n_out=16, activation="relu"))
             .layer(1, out))
    n_in = InputType.convolutional(6, 6, 2) if kind == "conv_bn" else \
        InputType.feed_forward(4)
    return JNet(b.set_input_type(n_in).build()).init()


# name: (net kind, averaging frequency, average updaters, rows, global
# batch, control run on the ranks)
CASES = {
    "mln_allreduce": ("mln", 1, True, 64, 16, None),
    "mln_k4": ("mln", 4, True, 128, 16, None),
    "cg_allreduce": ("cg", 1, True, 64, 16, None),
    "cg_k4": ("cg", 4, True, 128, 16, None),
    "bn_allreduce": ("bn", 1, True, 64, 16, "local_stats"),
    "conv_bn_allreduce": ("conv_bn", 1, True, 32, 8, "local_stats"),
    "clip_allreduce": ("clip", 1, True, 64, 16, "clip_first"),
    "momentum_k2_no_updater_avg": ("momentum", 2, False, 64, 16, None),
    "ragged_k4": ("mln", 4, True, 104, 16, None),
}


def _batches(name):
    kind, k, _, n, gb, _ = CASES[name]
    x, y = image_data(n) if kind == "conv_bn" else blob_data(n)
    all_b = list(DataSet(x, y).batch_by(gb))
    return all_b[:k], all_b


def _tree(J, t):
    return J.jax.tree.map(lambda a: np.array(a), t)


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import types

    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
    from deeplearning4j_tpu.parallel import make_mesh as jmesh
    return types.SimpleNamespace(jax=jax, DataSet=JDataSet, List=JList,
                                 PW=JPW, make_mesh=jmesh)


def _readings(net, score):
    return {"params": np.asarray(net.params(), np.float64),
            "score": float(score), "iterations": net.conf.iteration_count,
            "batch": int(net._last_batch_size)}


def reference_run(J, name, jnet):
    kind, k, avg, *_ = CASES[name]
    first, all_b = _batches(name)
    jds = lambda bs: J.List([J.DataSet(b.features, b.labels) for b in bs])
    mesh = J.make_mesh(n_data=WORLD, devices=J.jax.devices()[:WORLD])
    pw = (J.PW.Builder(jnet).mesh(mesh).averaging_frequency(k)
          .average_updaters(avg).build())
    pw.fit(jds(first))
    out = {"first": _readings(jnet, jnet._score)}
    pw.fit(jds(all_b), num_epochs=EPOCHS)
    out["epochs"] = _readings(jnet, jnet._score)
    return out


# ------------------------------------------------------------------ ranks

def port_net(spec):
    cg = spec["cg"]
    conf = (ComputationGraphConfiguration if cg
            else MultiLayerConfiguration).from_json(spec["conf"])
    net = (ComputationGraph if cg else MultiLayerNetwork)(
        conf, device="cpu").init()
    return net.from_jax_params(spec["params"], spec["state"],
                               spec["ustate"])


def _clip_first(pw):
    """The fault of the clip control: each rank clips its own gradient,
    then the wrapper all-reduces."""
    net = pw.model

    def reduce(grads, score):
        grads = {key: U.normalize_gradients(
            grads[key], layer.gradient_normalization,
            layer.gradient_normalization_threshold or 1.0)
            for key, layer in net._keyed_layers()}
        return ParallelWrapper._reduce(pw, grads, score)
    return reduce


def port_run(name, spec, control=None):
    kind, k, avg, *_ = CASES[name]
    first, all_b = _batches(name)
    net = port_net(spec)
    pw = (ParallelWrapper.Builder(net).averaging_frequency(k)
          .average_updaters(avg).build())
    if control == "local_stats":
        net.batch_stats_over = lambda group: contextlib.nullcontext()
    elif control == "clip_first":
        pw._reduce = _clip_first(pw)
    pw.fit(ListDataSetIterator(first))
    out = {"first": _readings(net, net._score)}
    pw.fit(ListDataSetIterator(all_b), num_epochs=EPOCHS)
    out["epochs"] = _readings(net, net._score)
    return out


def _rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    with open(Path(out_dir) / "cases.pkl", "rb") as fh:
        specs = pickle.load(fh)
    results = {}
    for name, spec in specs.items():
        results[name] = port_run(name, spec)
        control = CASES[name][5]
        if control is not None:
            results[name]["control"] = port_run(name, spec, control)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(results, fh)
    dist.destroy_process_group()


def start_ranks(world, tmp, script=__file__):
    """Start `world` processes running `script` as rank r of a gloo group
    through a FileStore under `tmp`."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(tmp / "store"),
         str(tmp)], env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    return procs, logs


def join_ranks(procs, logs, tmp, deadline):
    """Wait until `deadline`, kill what is left; fail unless all exit 0.
    Returns each rank's results."""
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
    assert codes == [0] * len(procs), "\n".join(
        f"rank {r} exit {c}:\n{(tmp / f'rank{r}.log').read_text()[-3000:]}"
        for r, c in enumerate(codes))
    out = []
    for r in range(len(procs)):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


@contextlib.contextmanager
def reference_kstep_as_written():
    """The reference's shard_map with check_vma=False, for the duration."""
    from deeplearning4j_tpu.common import jax_compat
    shard_map = jax_compat.shard_map
    jax_compat.shard_map = lambda f, **kw: shard_map(
        f, **dict(kw, check_vma=False))
    try:
        yield
    finally:
        jax_compat.shard_map = shard_map


@pytest.fixture(scope="module")
def runs(J, tmp_path_factory):
    """(reference readings, [rank 0 readings, rank 1 readings]) per case.
    The ranks train while the JAX side does."""
    tmp = tmp_path_factory.mktemp("pw")
    jnets, specs = {}, {}
    for i, (name, (kind, *_)) in enumerate(CASES.items()):
        jnet = jnets[name] = reference_net(kind, seed=40 + i)
        specs[name] = {"cg": kind == "cg", "conf": jnet.conf.to_json(),
                       "params": _tree(J, jnet._params),
                       "state": _tree(J, jnet._model_state),
                       "ustate": _tree(J, jnet._updater_state)}
    with open(tmp / "cases.pkl", "wb") as fh:
        pickle.dump(specs, fh)
    procs, logs = start_ranks(WORLD, tmp)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        with reference_kstep_as_written():
            ref = {name: reference_run(J, name, jnet)
                   for name, jnet in jnets.items()}
    finally:
        ranks = join_ranks(procs, logs, tmp, deadline)
    return ref, ranks


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_reference_two_devices(runs, name):
    ref, ranks = runs
    port = ranks[0][name]
    np.testing.assert_array_equal(ranks[0][name]["epochs"]["params"],
                                  ranks[1][name]["epochs"]["params"])
    assert _err(port["first"]["params"], ref[name]["first"]["params"]) \
        <= TOL
    np.testing.assert_allclose(port["epochs"]["params"],
                               ref[name]["epochs"]["params"],
                               rtol=RTOL, atol=ATOL)
    for when in ("first", "epochs"):
        assert port[when]["iterations"] == ref[name][when]["iterations"]
        assert port[when]["batch"] == ref[name][when]["batch"]
        assert abs(port[when]["score"] - ref[name][when]["score"]) <= TOL


def test_counters_advance_as_the_reference_does(runs):
    """iteration_count: one a batch, k a round; ragged: 7 batches a
    epoch in rounds of 4 and 3."""
    ref, _ = runs
    assert ref["mln_allreduce"]["epochs"]["iterations"] == 1 + 3 * 4
    assert ref["mln_k4"]["epochs"]["iterations"] == 4 + 3 * 8
    assert ref["ragged_k4"]["epochs"]["iterations"] == 4 + 3 * 7
    assert ref["mln_allreduce"]["epochs"]["batch"] == 16


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[5]])
def test_controls_miss_the_reference(runs, name):
    """The control's fault (rank-local BatchNorm statistics, or the clip
    before the all-reduce) must move the result past the tolerance the
    port is held to: the parity test above sees it."""
    ref, ranks = runs
    ctrl = ranks[0][name]["control"]
    miss = max(_err(ctrl["first"]["params"], ref[name]["first"]["params"]),
               _err(ctrl["epochs"]["params"], ref[name]["epochs"]["params"])
               - ATOL - RTOL * np.max(np.abs(ref[name]["epochs"]["params"])))
    assert miss > TOL, (name, miss)


# ------------------------------------------------------ in one process

def _same_net(J, kind, seed):
    jnet = reference_net(kind, seed)
    spec = {"cg": kind == "cg", "conf": jnet.conf.to_json(),
            "params": _tree(J, jnet._params),
            "state": _tree(J, jnet._model_state),
            "ustate": _tree(J, jnet._updater_state)}
    return jnet, spec


@pytest.mark.parametrize("kind", ["bn", "cg"])
def test_grad_and_apply_fns_match_the_reference(J, kind):
    jax, jnp = J.jax, J.jax.numpy
    jnet, spec = _same_net(J, kind, seed=5)
    net = port_net(spec)
    x, y = blob_data(16, seed=3)
    jbatch = {"features": jnp.asarray(x), "labels": jnp.asarray(y),
              "rng": jax.random.PRNGKey(0)}
    if kind == "cg":
        jbatch["features"] = {"in": jbatch["features"]}
        jbatch["labels"] = [jbatch["labels"]]
    jg, jscore, jstate, _ = jnet.make_grad_fn()(jnet._params,
                                                jnet._model_state, jbatch)
    jp, _ = jnet.make_apply_fn()(jnet._params, jnet._updater_state, jg,
                                 jnp.float32(0.0))
    params = {key: {k: p.detach().clone() for k, p in per.items()}
              for key, per in net._params.items()}
    g, score, state, _ = net.make_grad_fn()(
        params, None, ps_batch(net, DataSet(x, y), torch.Generator()))
    assert _err(net.flatten_gradients(net._tree(g)),
                jnet.flatten_gradients(jg)) <= TOL
    assert abs(float(score) - float(jscore)) <= TOL
    before = net.params()
    new, _ = net.make_apply_fn()(params, net._updater_state, g, 0)
    assert new is params
    np.testing.assert_array_equal(net.params(), before)   # masters untouched
    want = port_net(spec).from_jax_params(_tree(J, jp))
    with torch.no_grad():
        for key, per in params.items():
            for k, p in per.items():
                net._params[key][k].copy_(p)
    assert _err(net.params(), want.params()) <= TOL
    if kind == "bn":
        np.testing.assert_allclose(state[1]["mean"].numpy(),
                                   np.asarray(jstate[1]["mean"]), atol=TOL)


@pytest.mark.parametrize("kind,k", [("bn", 1), ("bn", 3), ("cg", 1),
                                    ("cg", 3), ("conv_bn", 2)])
def test_one_rank_is_plain_fit_bit_for_bit(J, kind, k):
    _, spec = _same_net(J, kind, seed=9)
    x, y = (image_data(48) if kind == "conv_bn" else blob_data(48))
    batches = list(DataSet(x, y).batch_by(8))
    a, b = port_net(spec), port_net(spec)
    pw = ParallelWrapper.Builder(a).averaging_frequency(k).build()
    assert pw.workers == 1 and pw.mesh.group is None
    pw.fit(ListDataSetIterator(batches), num_epochs=2)
    for _ in range(2):
        for ds in batches:
            b.fit(ds)
    np.testing.assert_array_equal(a.params(), b.params())
    for key in a._updater_state:
        for p, st in a._updater_state[key].items():
            for s, t in st.items():
                assert torch.equal(t, b._updater_state[key][p][s])
    for (n, t), (_, u) in zip(a.named_buffers(), b.named_buffers()):
        assert torch.equal(t, u), n
    assert a.conf.iteration_count == b.conf.iteration_count == 12
    assert a._last_batch_size == 8


@pytest.mark.parametrize("k", [1, 2])
def test_fault_sites_fire_as_the_reference(J, k):
    """"wrapper.round" once a round, "wrapper.batch" once a batch, on both
    packages (the reference on one device); a raise at a round stops the
    fit after the rounds before it."""
    from deeplearning4j_tpu.common.resilience import \
        FaultInjector as JFaultInjector
    jnet, spec = _same_net(J, "mln", seed=3)
    net = port_net(spec)
    x, y = blob_data(40)
    batches = list(DataSet(x, y).batch_by(8))                # 5 batches
    jinj, inj = JFaultInjector(), FaultInjector()
    (J.PW.Builder(jnet).mesh(J.make_mesh(n_data=1,
                                         devices=J.jax.devices()[:1]))
     .averaging_frequency(k).fault_injector(jinj).build()
     .fit(J.List([J.DataSet(b.features, b.labels) for b in batches])))
    (ParallelWrapper.Builder(net).averaging_frequency(k).fault_injector(inj)
     .build().fit(ListDataSetIterator(batches)))
    for site in ("wrapper.round", "wrapper.batch"):
        assert inj.calls(site) == jinj.calls(site)
    assert inj.calls("wrapper.batch") == 5
    assert inj.calls("wrapper.round") == (5 if k == 1 else 3)
    net2 = port_net(spec)
    stop = FaultInjector().plan("wrapper.round", on_call=1)
    with pytest.raises(ConnectionError):
        (ParallelWrapper.Builder(net2).averaging_frequency(k)
         .fault_injector(stop).build().fit(ListDataSetIterator(batches)))
    assert net2.conf.iteration_count == k


def test_unported_paths_raise_with_their_items(tmp_path):
    net = port_net_plain()
    b = ParallelWrapper.Builder(net)
    for call, item in ((lambda: b.tensor_parallel(True), 20),
                       (lambda: b.sharded_updater_state(True), 20),
                       (lambda: b.build().lower_step(None), 20),
                       (lambda: b.build().lower_kstep([]), 20),
                       (lambda: make_mesh(n_model=2, device="cpu"), 20),
                       (lambda: sharding.shard_params(net, make_mesh(
                           device="cpu"), tensor_parallel=True), 20)):
        with pytest.raises(NotImplementedError, match=f"item {item}$"):
            call()
    assert b.tensor_parallel(False) is b
    # item 17 (the watchdog) and item 20a (replicated checkpoints) work
    pw = (b.checkpointing(str(tmp_path / "ck")).health_policy(True)
          .build())
    assert net._health_policy is not None
    assert pw._gate.manager().directory == str(tmp_path / "ck")
    gate = RoundCheckpointer(str(tmp_path / "rc"))
    assert gate.round_starts() and gate.manager().steps() == []


def port_net_plain():
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    return lenet(device="cpu")


def test_no_silent_single_rank_and_batch_split_rules():
    """workers(n > 1) without a group of n raises, never trains on one
    rank; a batch that does not divide over the ranks raises, as
    `jax.device_put` does."""
    net = port_net_plain()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        ParallelWrapper.Builder(net).workers(2).build()
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        make_mesh(n_data=4, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert not sharding.is_multiprocess_mesh(mesh)
    two = sharding.DataMesh(None, 2, 1, "cpu")          # rank 1 of 2
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(sharding.put_sharded(x, two), x[3:])
    with pytest.raises(ValueError, match="divisible by 2"):
        sharding.put_sharded(x[:5], two)
    gate = RoundCheckpointer()
    assert [gate.round_starts() for _ in range(3)] == [True] * 3
    assert gate.round == 3 and gate.resume_round == 0


# ------------------------------------ MagicQueue and distributed helpers

def test_magic_queue_shards_as_the_reference(J):
    """Each global batch split into one shard per device (ceil rows each,
    a ragged tail's last device gets what is left, possibly 0 rows), in
    order, None at the end; the reference's shards on its CPU devices."""
    from deeplearning4j_tpu.parallel.magic_queue import \
        MagicQueue as JMagicQueue

    from deeplearning4j_tpu_torch.parallel import MagicQueue
    x, y = blob_data(27)
    batches = list(DataSet(x, y).batch_by(10))        # 10, 10, 7
    q = MagicQueue(devices=["cpu"] * 3, capacity=2).feed(
        ListDataSetIterator(batches))
    jq = JMagicQueue(devices=J.jax.devices()[:3], capacity=2).feed(
        [J.DataSet(b.features, b.labels) for b in batches])
    try:
        for _ in batches:
            for d in range(3):
                got, want = q.next_for(d), jq.next_for(d)
                np.testing.assert_array_equal(got.features.numpy(),
                                              np.asarray(want.features))
                np.testing.assert_array_equal(got.labels.numpy(),
                                              np.asarray(want.labels))
        assert [q.next_for(d) for d in range(3)] == [None] * 3
    finally:
        q.shutdown()
        jq.shutdown()


def test_magic_queue_surfaces_a_producer_error():
    from deeplearning4j_tpu_torch.parallel import MagicQueue

    def broken():
        yield DataSet(*blob_data(4))
        raise ValueError("bad source")

    q = MagicQueue(devices=["cpu"], capacity=1).feed(broken())
    try:
        with pytest.raises(ValueError, match="bad source"):
            while q.next_for(0, timeout=10) is not None:
                pass
    finally:
        q.shutdown()


def test_distributed_helpers_without_a_group():
    from deeplearning4j_tpu_torch.parallel import distributed
    assert distributed.initialize(num_processes=1) is False
    assert distributed.process_local_batch_slice(16) == slice(0, 16)
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group is None


def _native_threads():
    return len(os.listdir("/proc/self/task"))


@pytest.mark.skipif(not Path("/proc/self/task").is_dir(),
                    reason="counts threads through /proc")
def test_a_mesh_does_not_keep_the_world_group_alive(tmp_path):
    """A mesh (here in a reference cycle, as a network and its wrapper
    form one) must not hold the world group: after destroy_process_group
    gloo's threads end at once, not at the interpreter's shutdown, where
    tearing them down can abort the process. (gloo names its threads only
    once they run, so this counts every thread of the process.)"""
    import gc

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.sharding import make_mesh
    assert not dist.is_initialized()
    before = _native_threads()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        mesh.cycle = mesh
        assert mesh.group is dist.group.WORLD and mesh.size == 1
        assert mesh.via_host() and _native_threads() > before
    finally:
        dist.destroy_process_group()
    assert mesh.group is None and not mesh.via_host()
    assert _native_threads() == before
    del mesh
    gc.collect()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_magic_queue_stages_on_the_card(cuda):
    from deeplearning4j_tpu_torch.parallel import MagicQueue
    x, y = blob_data(20)
    q = MagicQueue(capacity=2).feed(ListDataSetIterator(DataSet(x, y), 10))
    try:
        rows = []
        while (shard := q.next_for(0)) is not None:
            assert shard.features.is_cuda
            rows.append(shard.features.cpu().numpy())
        np.testing.assert_array_equal(np.concatenate(rows), x)
    finally:
        q.shutdown()


@pytest.mark.gpu
def test_one_rank_on_the_card_is_plain_fit_bit_for_bit(cuda):
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    rng = np.random.default_rng(4)
    x = rng.random((32, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]
    batches = list(DataSet(x, y).batch_by(8))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # one algorithm per shape
    try:
        for k in (1, 2):
            a = lenet(device=cuda, data_type="float32")
            b = lenet(device=cuda, data_type="float32")
            ParallelWrapper.Builder(a).averaging_frequency(k).build().fit(
                ListDataSetIterator(batches))
            for ds in batches:
                b.fit(ds)
            np.testing.assert_array_equal(a.params(), b.params())
    finally:
        torch.backends.cudnn.deterministic = det


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
