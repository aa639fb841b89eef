"""The port's asynchronous parameter server (`parallel/parameter_server.py`)
and its TCP transport (`parallel/ps_transport.py`) against the JAX
package's.

The reference's contracts, rebuilt on the port (their bodies follow
tests/test_training_master.py:154-290, tests/test_ps_transport.py and the
PS half of tests/test_fault_tolerance.py): every pushed gradient is
applied; staleness is measured at apply time and `max_staleness` drops the
stale; async training lands in the ballpark of sync training; BatchNorm's
running statistics move through the PS; a worker's error reaches the
caller; a severed push is re-sent and applied at most once; a crashed
worker is reaped; a restarted worker resumes its sequence numbers; a
worker that never connects is reaped. One more pin is the port's own: a
published snapshot never aliases the master parameters, which the port's
updaters write in place.

The wire, byte for byte: `pack_leaves` of f32, i32, i64, f64, 0-d, empty
and bf16 leaves (numpy or torch) equals the reference's packing of the
same values (bf16 through ml_dtypes on the reference's side), and each
side unpacks the other's bytes. A reference `PSClient` pulls from a port
`PSServer` (the leaves equal the reference's own, in its order and
layout) and pushes the reference's gradients, which the port applies as
the reference's apply_fn does (1e-6); a port client (`ps_worker_fit`)
pushes to a reference `PSServer`, whose parameters then equal the port's
own step (1e-6). One `ps_worker_fit` runs in a subprocess against a port
server in this process. Every socket is on 127.0.0.1.
"""
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.common.resilience import (FaultInjector,
                                                        RetryPolicy)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (GradientsAccumulator,
                                               ParameterServerParallelWrapper)
from deeplearning4j_tpu_torch.parallel import ps_transport as T
from deeplearning4j_tpu_torch.parallel.parameter_server import (_ps_fns,
                                                                ps_batch)

REPO = Path(__file__).resolve().parents[1]


def _net(seed=7, bn=False):
    """tests/test_training_master.py's net, on the port (CPU)."""
    b = (NeuralNetConfiguration.Builder().seed(seed).updater("adam")
         .learning_rate(0.01).list()
         .layer(0, L.DenseLayer(n_out=16 if not bn else 8,
                                activation="relu" if not bn else "identity")))
    i = 1
    if bn:
        b = b.layer(1, L.BatchNormalization())
        i = 2
    conf = (b.layer(i, L.OutputLayer(n_out=3, activation="softmax",
                                     loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=256, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n, 5)).astype(np.float32)
    w = r.random((5, 3))
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return DataSet(x, y)


def _wait_applied(acc, n, timeout=30.0):
    t0 = time.time()
    while acc.applied_count() < n:
        if time.time() - t0 > timeout:
            raise TimeoutError(f"applied={acc.applied_count()} never "
                               f"reached {n}")
        time.sleep(0.01)


# ------------------------------------------------ the in-process server

def test_parameter_server_async_training():
    net = _net()
    ds = _data()
    s0 = net.score(ds)
    psw = (ParameterServerParallelWrapper.Builder(net)
           .workers(3).queue_size(4).build())
    psw.fit(ListDataSetIterator(list(ds.batch_by(32))), num_epochs=3)
    assert net.score(ds) < s0
    # every pushed gradient was applied: 8 batches * 3 epochs
    assert net.conf.iteration_count == 24
    stats = psw.last_stats
    assert stats["applied"] == 24
    assert stats["stale_dropped"] == 0
    assert stats["max_staleness_seen"] >= 0


def test_gradients_accumulator_staleness_semantics():
    """A version-0 gradient applied after the master moved on is recorded
    with its true staleness; max_staleness=0 drops it."""
    ds = _data(32)
    net = _net()
    acc = GradientsAccumulator(net, queue_size=4)
    grad_fn = _ps_fns(net)[0]
    batch = ps_batch(net, ds, torch.Generator())
    params, state, v0 = acc.snapshot_params()
    assert v0 == 0
    g, score, new_state, _ = grad_fn(params, state, batch)
    acc.push_gradients(g, score, v0, new_state)
    _wait_applied(acc, 1)
    acc.push_gradients(g, score, v0, new_state)  # stale by 1 now
    _wait_applied(acc, 2)
    acc.shutdown()
    st = acc.stats()
    assert st["applied"] == 2
    assert st["max_staleness_seen"] == 1
    assert net.conf.iteration_count == 2

    net2 = _net()
    acc2 = GradientsAccumulator(net2, queue_size=4, max_staleness=0)
    g2, score2, ns2, _ = grad_fn(*acc2.snapshot_params()[:2], batch)
    acc2.push_gradients(g2, score2, 0, ns2)
    _wait_applied(acc2, 1)
    acc2.push_gradients(g2, score2, 0, ns2)     # stale -> dropped
    params3, state3, v3 = acc2.snapshot_params()
    g3, score3, ns3, _ = grad_fn(params3, state3, batch)
    acc2.push_gradients(g3, score3, v3, ns3)    # fresh -> applied
    _wait_applied(acc2, 2)
    acc2.shutdown()
    st2 = acc2.stats()
    assert st2["applied"] == 2
    assert st2["stale_dropped"] == 1
    assert net2.conf.iteration_count == 2


def test_snapshot_never_aliases_the_master():
    """The port's updaters write the masters in place: a snapshot taken
    before an apply keeps its values, and its tensors are not the
    masters'."""
    net = _net()
    acc = GradientsAccumulator(net, queue_size=4)
    params, state, v0 = acc.snapshot_params()
    before = {k: {n: t.clone() for n, t in per.items()}
              for k, per in params.items()}
    masters = {t.data_ptr() for per in net._params.values()
               for t in per.values()}
    assert not masters & {t.data_ptr() for per in params.values()
                          for t in per.values()}
    g, score, st, _ = _ps_fns(net)[0](
        params, state, ps_batch(net, _data(32), torch.Generator()))
    acc.push_gradients(g, score, v0, st)
    _wait_applied(acc, 1)
    acc.shutdown()
    for k, per in params.items():
        for n, t in per.items():
            assert torch.equal(t, before[k][n])
            assert not torch.equal(net._params[k][n].detach(), t)
    assert acc.snapshot_params()[2] == 1


def test_parameter_server_under_thread_churn_loses_no_update():
    """More workers than cores, a tiny switch interval and a queue of 2:
    every push is applied or counted as dropped, the counters agree, the
    staleness bound holds, and a second fit reuses the same worker
    threads."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        net = _net()
        psw = (ParameterServerParallelWrapper.Builder(net).workers(8)
               .queue_size(2).max_staleness(6).build())
        batches = list(_data(512).batch_by(8))             # 64 pushes
        psw.fit(ListDataSetIterator(batches))
        threads = {t.ident for t in threading.enumerate()
                   if t.name.startswith("ps-worker")}
        st = psw.last_stats
        assert st["applied"] + st["stale_dropped"] == 64
        assert net.conf.iteration_count == st["applied"]
        psw.fit(ListDataSetIterator(batches))
        assert {t.ident for t in threading.enumerate()
                if t.name.startswith("ps-worker")} == threads
        assert psw.last_stats["applied"] + \
            psw.last_stats["stale_dropped"] == 64
        assert all(torch.isfinite(p).all() for p in net.parameters())
    finally:
        sys.setswitchinterval(old)
        psw.close()
    assert not any(t.name.startswith("ps-worker") and t.is_alive()
                   for t in threading.enumerate())


def test_parameter_server_convergence_comparable_to_sync():
    ds = _data(512, seed=3)
    sync_net = _net(seed=11)
    for _ in range(3):
        sync_net.fit(ListDataSetIterator(list(ds.batch_by(32))))
    async_net = _net(seed=11)
    psw = (ParameterServerParallelWrapper.Builder(async_net)
           .workers(3).queue_size(4).build())
    psw.fit(ListDataSetIterator(list(ds.batch_by(32))), num_epochs=3)
    s_sync = sync_net.score(ds)
    s_async = async_net.score(ds)
    assert s_async < 0.9  # initial score ~1.1 for 3-class mcxent
    # the reference's bound: the gap depends on thread scheduling
    assert abs(s_async - s_sync) < 0.5


def test_parameter_server_updates_model_state():
    """BN running stats advance through the async PS path (the worker's
    layer state is published last-writer-wins)."""
    net = _net(bn=True)
    init_mean = net._slot(1).mean.clone()
    psw = (ParameterServerParallelWrapper.Builder(net)
           .workers(2).queue_size(4).build())
    psw.fit(ListDataSetIterator(list(_data().batch_by(32))), num_epochs=2)
    assert not torch.allclose(init_mean, net._slot(1).mean)


def test_parameter_server_worker_error_propagates():
    net = _net()
    good = _data(64)
    bad = DataSet(np.zeros((8, 9), dtype=np.float32),
                  np.zeros((8, 3), dtype=np.float32))  # wrong n_in
    psw = (ParameterServerParallelWrapper.Builder(net)
           .workers(2).queue_size(2).build())
    with pytest.raises(Exception):
        psw.fit(ListDataSetIterator(list(good.batch_by(16)) + [bad]))


# ------------------------------------------------------------- the wire

@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from deeplearning4j_tpu import (InputType as JInputType,
                                    MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.parallel import parameter_server as jps
    from deeplearning4j_tpu.parallel import ps_transport as jt
    return types.SimpleNamespace(jax=jax, ml_dtypes=ml_dtypes, Net=JNet,
                                 DataSet=JDataSet,
                                 Conf=JConf, L=JL, InputType=JInputType,
                                 ps=jps, t=jt)


def _leaf_sets(ml_dtypes):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((4, 7)).astype(np.float32)
    i32 = np.arange(6, dtype=np.int32).reshape(2, 3)
    bf = np.linspace(-2, 2, 8).astype(np.float32)
    return {
        "f32": ([f32], [torch.from_numpy(f32)]),
        "i32": ([i32], [torch.from_numpy(i32)]),
        "bf16": ([bf.astype(ml_dtypes.bfloat16)],
                 [torch.from_numpy(bf).to(torch.bfloat16)]),
        "mixed": ([f32, np.float32(3.25).reshape(()),
                   rng.integers(0, 9, (3,), dtype=np.int64),
                   np.empty((0, 5), np.float32),
                   rng.standard_normal((2, 3, 4)).astype(np.float64),
                   bf.astype(ml_dtypes.bfloat16).reshape(2, 4)],
                  None),
    }


@pytest.mark.parametrize("kind", ["f32", "i32", "bf16", "mixed"])
def test_pack_leaves_byte_equal_to_the_reference(J, kind):
    ref_leaves, torch_leaves = _leaf_sets(J.ml_dtypes)[kind]
    want = J.t.pack_leaves(ref_leaves)
    if torch_leaves is None:      # numpy leaves through the port
        torch_leaves = [l if l.dtype != J.ml_dtypes.bfloat16 else
                        torch.from_numpy(np.asarray(l, np.float32)).to(
                            torch.bfloat16) for l in ref_leaves]
    assert T.pack_leaves(torch_leaves) == want
    # each side reads the other's bytes
    back, off = T.unpack_leaves(want + b"tail")
    assert off == len(want)
    for a, t in zip(ref_leaves, back):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).rsplit(".", 1)[-1] == a.dtype.name
        np.testing.assert_array_equal(t.float().numpy() if t.dtype ==
                                      torch.bfloat16 else t.numpy(),
                                      np.asarray(a, np.float32)
                                      if a.dtype == J.ml_dtypes.bfloat16
                                      else a)
    ref_back, _ = J.t.unpack_leaves(T.pack_leaves(torch_leaves))
    for a, b in zip(ref_leaves, ref_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))


def _twins(J, seed=7):
    """The same network in both packages, the reference's weights."""
    jconf = (J.Conf.Builder().seed(seed).updater("adam").learning_rate(0.01)
             .list()
             .layer(0, J.L.DenseLayer(n_out=8, activation="identity"))
             .layer(1, J.L.BatchNormalization())
             .layer(2, J.L.OutputLayer(n_out=3, activation="softmax",
                                       loss_function="mcxent"))
             .set_input_type(J.InputType.feed_forward(5)).build())
    jnet = J.Net(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    tree = lambda t: J.jax.tree.map(np.array, t)  # noqa: E731
    net.from_jax_params(tree(jnet._params), tree(jnet._model_state),
                        tree(jnet._updater_state))
    return jnet, net


def _flat(leaves):
    return np.concatenate([np.asarray(l, np.float64).ravel()
                           for l in leaves])


def test_reference_client_pushes_to_a_port_server(J):
    jax = J.jax
    jnet, net = _twins(J)
    ds = _data(16, seed=5)
    srv = T.PSServer(net, queue_size=4, n_workers=1)
    try:
        c = J.t.PSClient("127.0.0.1", srv.port)
        pleaves, sleaves, version = c.pull()
        # the port serves the reference's leaves: order, layout, values
        want = jax.tree_util.tree_leaves(jnet._params)
        assert [l.shape for l in pleaves] == [l.shape for l in want]
        np.testing.assert_array_equal(_flat(pleaves), _flat(want))
        assert len(sleaves) == len(jax.tree_util.tree_leaves(
            jnet._model_state))
        grad_fn, apply_fn = J.ps._jitted_ps_fns(jnet)
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jnet._params), pleaves)
        batch = J.ps.ps_batch(J.DataSet(ds.features, ds.labels),
                              jax.random.PRNGKey(0))
        grads, score, new_state, _ = grad_fn(params, jnet._model_state,
                                             batch)
        c.push([np.asarray(l) for l in jax.tree_util.tree_leaves(grads)],
               float(score), version,
               [np.asarray(l) for l in jax.tree_util.tree_leaves(new_state)])
        c.done()
        stats = srv.wait(timeout=60)
    finally:
        srv.stop()
    assert stats["applied"] == 1 and stats["workers_done"] == 1
    jp, _ = apply_fn(jnet._params, jnet._updater_state, grads,
                     J.jax.numpy.float32(0.0))
    want = _twins(J)[1].from_jax_params(J.jax.tree.map(np.array, jp))
    assert np.max(np.abs(net.params() - want.params())) <= 1e-6
    np.testing.assert_allclose(net._slot(1).mean.numpy(),
                               np.asarray(new_state[1]["mean"]), atol=1e-6)


def test_port_worker_pushes_to_a_reference_server(J):
    jnet, net = _twins(J)
    ds = _data(32, seed=6)
    srv = J.t.PSServer(jnet, queue_size=4, n_workers=1)
    try:
        stats = T.ps_worker_fit(net, "127.0.0.1", srv.port,
                                ListDataSetIterator([ds]), num_epochs=1)
        final = srv.wait(timeout=60)
    finally:
        srv.stop()
    assert stats["applied"] + stats["stale_dropped"] <= 1
    assert final["applied"] == 1 and final["workers_done"] == 1
    # the port's own step from the same weights (the worker's generator)
    twin = _twins(J)[1]
    g, score, st, _ = twin.make_grad_fn()(
        twin._params, None, ps_batch(twin, ds, torch.Generator()))
    twin.make_apply_fn()(twin._params, twin._updater_state, g, 0)
    assert np.max(np.abs(np.asarray(jnet.params()) - twin.params())) \
        <= 1e-6


# ------------------------------------------------- resilience on the wire

def _zero_push(c):
    pleaves, _s, version = c.pull()
    c.push([torch.zeros_like(l) for l in pleaves], 1.0, version)


def test_severed_connection_reconnects_and_push_applies_once():
    net = _net()
    ds = _data(96)
    s0 = float(net.score(ds))
    srv = T.PSServer(net, queue_size=4, n_workers=1)
    client = None
    try:
        inj = FaultInjector(seed=0)
        inj.plan("client.push.sent", on_call=1, sever=True)
        inj.plan("client.pull.sent", on_call=3, sever=True)
        pol = RetryPolicy(max_retries=8, base_delay=0.01, max_delay=0.1,
                          seed=1)
        client = T.PSClient("127.0.0.1", srv.port, retry_policy=pol,
                            fault_injector=inj)
        worker = _net(seed=9)          # architecture donor only
        grad_fn = _ps_fns(worker)[0]
        batches = list(ds.batch_by(16))          # 6 logical pushes
        for j, b in enumerate(batches):
            pleaves, _sleaves, version = client.pull()
            params = T.params_from_leaves(worker, pleaves)
            grads, score, _state, _ = grad_fn(
                params, None, ps_batch(worker, b, torch.Generator()))
            client.push(T.param_leaves(worker, grads), float(score), version)
        client.done()
        final = srv.wait(timeout=120)
    finally:
        srv.stop()
        if client is not None:
            client.close()
    assert len(inj.fired()) == 2
    assert client.reconnects >= 2
    assert final["dup_pushes"] >= 1
    assert final["applied"] == len(batches)
    assert float(net.score(ds)) < s0


def test_dead_worker_is_reaped_and_survivors_finish():
    net = _net()
    srv = T.PSServer(net, queue_size=4, n_workers=2, heartbeat_timeout=1.0)
    alive = dead = None
    try:
        alive = T.PSClient("127.0.0.1", srv.port, heartbeat_interval=0.1)
        dead = T.PSClient("127.0.0.1", srv.port, heartbeat_interval=0.1)
        assert alive.worker_id != dead.worker_id
        _zero_push(dead)
        dead.kill()
        for _ in range(3):
            _zero_push(alive)
        alive.done()
        stats = srv.wait(timeout=60)
    finally:
        srv.stop()
        for c in (alive, dead):
            if c is not None:
                c.close()
    assert stats["workers_reaped"] == 1
    assert stats["workers_done"] == 1
    assert stats["applied"] == 4


def test_restarted_worker_reusing_id_resumes_seq_numbering():
    net = _net()
    srv = T.PSServer(net, queue_size=4, n_workers=1)
    try:
        first = T.PSClient("127.0.0.1", srv.port, worker_id=3)
        for _ in range(3):
            _zero_push(first)
        first.kill()
        second = T.PSClient("127.0.0.1", srv.port, worker_id=3)
        assert second._push_seq == 3
        for _ in range(2):
            _zero_push(second)
        second.done()
        final = srv.wait(timeout=60)
    finally:
        srv.stop()
    assert final["dup_pushes"] == 0
    assert final["applied"] == 5


def test_worker_that_never_connects_is_reaped():
    net = _net()
    srv = T.PSServer(net, queue_size=4, n_workers=2, heartbeat_timeout=0.6)
    c = None
    try:
        c = T.PSClient("127.0.0.1", srv.port, heartbeat_interval=0.1)
        c.done()
        stats = srv.wait(timeout=60)
    finally:
        srv.stop()
        if c is not None:
            c.close()
    assert stats["workers_done"] == 1
    assert stats["workers_reaped"] == 1


def test_worker_fit_survives_random_severs_with_exact_accounting():
    net = _net()
    ds = _data(256, seed=4)
    srv = T.PSServer(net, queue_size=4, n_workers=1, heartbeat_timeout=5.0)
    try:
        inj = FaultInjector(seed=7)
        inj.plan("client.push.sent", prob=0.25, times=4, sever=True)
        inj.plan("client.pull", prob=0.2, times=3, sever=True)
        pol = RetryPolicy(max_retries=10, base_delay=0.01, max_delay=0.05,
                          seed=2)
        T.ps_worker_fit(_net(seed=3), "127.0.0.1", srv.port,
                        ListDataSetIterator(list(ds.batch_by(32))),
                        num_epochs=2, retry_policy=pol,
                        heartbeat_interval=0.2, fault_injector=inj)
        final = srv.wait(timeout=240)
    finally:
        srv.stop()
    assert final["applied"] + final["stale_dropped"] == 16
    assert final["workers_reaped"] == 0
    assert len(inj.fired()) >= 1


def test_client_errors_are_loud():
    import socket
    with pytest.raises(OSError):
        T.PSClient("127.0.0.1", 1, connect_timeout=1)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def accept_close():
        conn, _ = srv.accept()
        conn.close()

    t = threading.Thread(target=accept_close, daemon=True)
    t.start()
    with pytest.raises(ConnectionError):
        T.PSClient("127.0.0.1", port, connect_timeout=5)
    t.join(timeout=5)
    srv.close()


def test_server_on_fresh_net_accepts_push():
    conf = (NeuralNetConfiguration.Builder().seed(3).updater("adam")
            .learning_rate(0.01).list()
            .layer(0, L.DenseLayer(n_out=8, activation="relu"))
            .layer(1, L.OutputLayer(n_out=2, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu")    # NOT .init()'ed
    assert net.slots is None
    srv = T.PSServer(net, n_workers=1)
    try:
        c = T.PSClient("127.0.0.1", srv.port)
        leaves, _state, version = c.pull()
        assert len(leaves) > 0
        c.push([torch.zeros_like(l) for l in leaves], 1.0, version)
        c.done()
        assert srv.wait(timeout=60)["applied"] == 1
    finally:
        srv.stop()


# ------------------------------------------------ a worker in a process

_WORKER = """
import sys
import numpy as np
from tests.test_torch_parameter_server import _data, _net
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.parallel.ps_transport import ps_worker_fit
ds = _data(256, seed=int(sys.argv[2]))
ps_worker_fit(_net(seed=5), "127.0.0.1", int(sys.argv[1]),
              ListDataSetIterator(list(ds.batch_by(32))), num_epochs=2,
              seed=int(sys.argv[2]), heartbeat_interval=0.5)
print("worker done")
"""


def test_ps_worker_fit_in_a_subprocess_trains_the_server():
    net = _net()
    ds = _data(256, seed=1)
    s0 = float(net.score(ds))
    srv = T.PSServer(net, queue_size=4, n_workers=1, heartbeat_timeout=30.0)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    try:
        p = subprocess.run([sys.executable, "-c", _WORKER, str(srv.port),
                            "1"], cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=120)
        assert p.returncode == 0, p.stdout + p.stderr
        final = srv.wait(timeout=60)
    finally:
        srv.stop()
    assert final["applied"] + final["stale_dropped"] == 16
    assert final["workers_done"] == 1 and final["workers_reaped"] == 0
    assert net.conf.iteration_count == final["applied"]
    assert float(net.score(ds)) < s0


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_leaves_pack_as_their_host_copies(cuda):
    rng = np.random.default_rng(2)
    host = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
            torch.arange(7, dtype=torch.int64),
            torch.linspace(-1, 1, 6).to(torch.bfloat16).reshape(2, 3),
            torch.tensor(2.5)]
    mixed = [t.to(cuda) if i % 2 == 0 else t for i, t in enumerate(host)]
    assert T.pack_leaves(mixed) == T.pack_leaves(host)
    back, _ = T.unpack_leaves(T.pack_leaves(mixed))
    for a, b in zip(host, back):
        assert torch.equal(a, b)
