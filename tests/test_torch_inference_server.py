"""The port's `serving.InferenceServer` against the JAX package's, and the
reference's serving pins (tests/test_serving.py) rebuilt inside the port.

Across the packages (the same weights through `from_jax_params`, the same
requests): each result to 1e-5 in f32, for a MultiLayerNetwork (an MLP and
LeNet) and a ComputationGraph (one output, a list per result).

Inside the port, as the reference states them: a request's result is
bit-identical solo, co-batched and bucket-padded; a mixed-size stream
creates at most len(buckets) programs; requests of different structures
are partitioned, not failed; a hot swap under concurrent load drops
nothing and each result is the output of the version that served it; a
swap rejects another architecture; `swap_from_path`; a transient batch
fault is retried, an unretryable one fails its requests loudly and the
server survives; deadline shed; queue-full backpressure; NaN rows screened
out alone; max_batch=1 keeps the bucket floor of 2.

The cross-bucket bit pin (a row's bits equal at every batch size from 2
up) holds on torch's CPU for these networks: measured for the MLP and
LeNet, f32 and bf16, at M = 2, 3, 4, 6, 8, 16, 32 (M = 1 differs for
LeNet, as XLA:CPU's does), so the tests here assert it. On the card cuDNN
searches a plan per shape and per thread: a row served by another bucket,
or `output` on another thread, agrees within bf16's rounding, which
`chip_smoke.py` phase 21 measures (PERF.md section 2).

Tests marked `gpu` run on the card and skip without one.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.common.resilience import (FaultInjected,
                                                        FaultInjector,
                                                        RetryPolicy)
from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (DeadlineExceededError,
                                              InferenceServer,
                                              ServerOverloadedError,
                                              UnhealthyOutputError)
from deeplearning4j_tpu_torch.util import model_serializer as TS

TOL = 1e-5


def _mln(seed=7, n_in=6, n_out=4, device="cpu"):
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater("adam").learning_rate(0.01).list()
            .layer(0, DenseLayer(n_out=16, activation="relu"))
            .layer(1, OutputLayer(n_out=n_out, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(n_in))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _cg(seed=7, device="cpu"):
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater("sgd").learning_rate(0.1).graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss_function="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(5))
            .build())
    return ComputationGraph(conf, device=device).init()


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# Against the reference's InferenceServer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import importlib

    from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOut
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.graph.computation_graph import \
        ComputationGraph as JCG
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.serving import InferenceServer as JServer
    jlenet = importlib.import_module("deeplearning4j_tpu.models.zoo.lenet")

    def mln():
        conf = (JNNC.Builder().seed(7).updater("adam").learning_rate(0.01)
                .list().layer(0, JDense(n_out=16, activation="relu"))
                .layer(1, JOut(n_out=4, activation="softmax",
                               loss_function="mcxent"))
                .set_input_type(JIT.feed_forward(6)).build())
        return JNet(conf).init()

    def cg():
        conf = (JNNC.Builder().seed(7).updater("sgd").learning_rate(0.1)
                .graph_builder().add_inputs("in")
                .add_layer("d", JDense(n_out=8, activation="tanh"), "in")
                .add_layer("out", JOut(n_out=3, activation="softmax",
                                       loss_function="mcxent"), "d")
                .set_outputs("out").set_input_types(JIT.feed_forward(5))
                .build())
        return JCG(conf).init()

    return types.SimpleNamespace(
        jax=jax, Server=JServer, CG=JCG,
        nets={"mlp": (mln, (6,)), "cg": (cg, (5,)),
              "lenet": (lambda: JNet(jlenet.lenet_conf()).init(), (784,))})


def _port_of(J, net):
    np_tree = lambda t: J.jax.tree.map(np.array, t)  # noqa: E731
    if isinstance(net, J.CG):
        ours = ComputationGraph(ComputationGraphConfiguration.from_json(
            net.conf.to_json()), device="cpu")
    else:
        ours = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            net.conf.to_json()), device="cpu")
    return ours.init().from_jax_params(np_tree(net._params),
                                       np_tree(net._model_state))


def _serve(server_cls, net, xs, **kw):
    with server_cls(net, max_batch=8, max_wait_ms=20.0, **kw) as srv:
        futs = [srv.submit(x) for x in xs]
        return [f.result(60) for f in futs]


@pytest.mark.parametrize("name", ["mlp", "cg", "lenet"])
def test_results_equal_reference_server(J, name):
    make, shape = J.nets[name]
    ref = make()
    ours = _port_of(J, ref)
    xs = np.random.default_rng(0).random((11,) + shape, dtype=np.float32)
    got = _serve(InferenceServer, ours, xs)
    want = _serve(J.Server, ref, xs)
    for g, w in zip(got, want):
        if name == "cg":
            assert isinstance(g, list) and len(g) == len(w) == 1
            g, w = g[0], w[0]
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# (a) determinism pins
# ---------------------------------------------------------------------------

def test_cobatched_bit_identical_to_batch1():
    net = _mln()
    xs = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    with InferenceServer(net, max_batch=8, max_wait_ms=20.0) as srv:
        futs = [srv.submit(x) for x in xs]       # coalesce into one batch
        batched = [f.result(30) for f in futs]
        solo = srv.predict(xs[0], timeout=30)    # a bucket-2 dispatch
    assert _bits_equal(solo, batched[0])


@pytest.mark.parametrize("data_type", ["float32", "bfloat16"])
def test_bucket_padded_bit_identical_to_unpadded(data_type):
    """3 requests pad to bucket 4; rows match the raw batch-3 forward and
    the batch-16 one bit for bit (LeNet: convolutions, pooling, dense)."""
    net = lenet(device="cpu", data_type=data_type)
    xs = np.random.default_rng(1).random((16, 784), dtype=np.float32)
    with InferenceServer(net, max_batch=4, max_wait_ms=20.0,
                         buckets=(2, 4)) as srv:
        futs = [srv.submit(x) for x in xs[:3]]
        rows = [f.result(30) for f in futs]
    direct3, direct16 = net.output(xs[:3]), net.output(xs)
    for i in range(3):
        assert _bits_equal(rows[i], direct3[i])
        assert _bits_equal(rows[i], direct16[i])


def test_computation_graph_served():
    cg = _cg()
    xs = np.random.default_rng(2).standard_normal((4, 5)).astype(np.float32)
    with InferenceServer(cg, max_batch=4, max_wait_ms=20.0) as srv:
        futs = [srv.submit(x) for x in xs]
        rows = [f.result(30) for f in futs]
    direct = cg.output(xs)[0]
    for i in range(4):
        assert isinstance(rows[i], list) and len(rows[i]) == 1
        assert _bits_equal(rows[i][0], direct[i])


# ---------------------------------------------------------------------------
# (b) bounded program set
# ---------------------------------------------------------------------------

def test_mixed_sizes_compile_at_most_num_buckets():
    net = _mln()
    xs = np.random.default_rng(3).standard_normal((64, 6)).astype(np.float32)
    with InferenceServer(net, max_batch=8, max_wait_ms=1.0,
                         buckets=(2, 4, 8), max_queue=128) as srv:
        futs = []
        i = 0
        for burst in (1, 3, 8, 2, 5, 7, 4, 6, 1, 8, 3, 2):
            for _ in range(burst):
                futs.append(srv.submit(xs[i % 64]))
                i += 1
            time.sleep(0.01)
        rows = [f.result(30) for f in futs]
    assert 1 <= len(srv.compiled_programs) <= 3
    direct = net.output(xs[:len(rows)])
    for i, r in enumerate(rows):
        assert _bits_equal(r, direct[i % 64])


def test_heterogeneous_structures_partition_not_fail():
    net = _mln(7, n_in=6)
    rng = np.random.default_rng(18)
    xa = rng.standard_normal((3, 6)).astype(np.float32)
    xb = rng.standard_normal((3, 6)).astype(np.float64)  # other dtype
    with InferenceServer(net, max_batch=8, max_wait_ms=30.0) as srv:
        futs = [srv.submit(x) for x in xa] + [srv.submit(x) for x in xb]
        rows = [f.result(30) for f in futs]
    da, db = net.output(xa), net.output(xb)
    for i in range(3):
        assert _bits_equal(rows[i], da[i])
        np.testing.assert_array_equal(rows[3 + i], db[i])
    assert srv.metrics.snapshot().get("failed", 0) == 0
    assert {k[1] for k in srv.compiled_programs} == {
        (None, (((6,), "float32"),)), (None, (((6,), "float64"),))}


# ---------------------------------------------------------------------------
# (d) hot swap
# ---------------------------------------------------------------------------

def test_microbatch_swap_zero_dropped():
    """Concurrent clients submit across a swap: every future resolves, and
    each result is bit-equal to the output of one version (the one that
    served it); requests after the swap get the new one."""
    net1, net2 = _mln(7), _mln(99)
    xs = np.random.default_rng(8).standard_normal((32, 6)).astype(np.float32)
    outs = {v: [n.output(np.stack([x, x]))[0] for x in xs]
            for v, n in ((1, net1), (2, net2))}
    srv = InferenceServer(net1, max_batch=4, max_wait_ms=1.0,
                          max_queue=512).start()
    futs = []

    def client():
        for i in range(150):
            futs.append((i % 32, srv.submit(xs[i % 32])))
            time.sleep(0.0004)

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.02)
    srv.swap(net2)
    t.join()
    served = {1: 0, 2: 0}
    for i, f in futs:
        r = f.result(60)                      # raises on any failure
        v = [v for v in (1, 2) if _bits_equal(r, outs[v][i])]
        assert len(v) == 1
        served[v[0]] += 1
    assert sum(served.values()) == 150 and served[1] and served[2]
    assert srv.metrics.snapshot().get("failed", 0) == 0
    after = srv.predict(xs[0], timeout=30)
    srv.stop()
    assert _bits_equal(after, outs[2][0])


def test_swap_rejects_architecture_mismatch():
    srv = InferenceServer(_mln(7)).start()
    try:
        with pytest.raises(ValueError, match="swap rejected"):
            srv.swap(_mln(7, n_in=6, n_out=7))     # another output width
        with pytest.raises(ValueError, match="swap rejected"):
            srv.swap(_cg())                         # another container
        with pytest.raises(ValueError, match="swap rejected"):
            net = _mln(7)                           # another compute type
            net.compute_dtype = torch.bfloat16
            srv.swap(net)
        assert srv.metrics.snapshot().get("swaps", 0) == 0
    finally:
        srv.stop()


def test_serving_snapshot_is_not_the_training_net():
    """The server serves the parameters it was given: training the
    network afterwards does not change its results until a swap."""
    net = _mln(7)
    x = np.random.default_rng(4).standard_normal(6).astype(np.float32)
    before = net.output(np.stack([x, x]))[0]
    with InferenceServer(net, max_wait_ms=1.0) as srv:
        net.fit(np.stack([x, x]), np.eye(4, dtype=np.float32)[[0, 1]])
        assert _bits_equal(srv.predict(x, timeout=30), before)
        srv.swap(net)
        assert _bits_equal(srv.predict(x, timeout=30),
                           net.output(np.stack([x, x]))[0])


def test_swap_from_serializer_path(tmp_path):
    net1, net2 = _mln(7), _mln(99)
    path = str(tmp_path / "model.zip")
    TS.write_model(net2, path)
    x = np.random.default_rng(9).standard_normal((6,)).astype(np.float32)
    with InferenceServer(net1, max_wait_ms=1.0) as srv:
        srv.swap_from_path(path)
        got = srv.predict(x, timeout=30)
    assert srv.metrics.snapshot().get("swaps") == 1
    assert _bits_equal(got, net2.output(np.stack([x, x]))[0])


def test_swap_from_golden_zip(tmp_path):
    """A LeNet server swapped to the JAX package's golden LeNet zip
    answers as that zip's io["y"] (1e-5: the zip's outputs are the JAX
    package's CPU f32)."""
    import os
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fixtures", "golden")
    io = np.load(os.path.join(golden, "lenet_io.npz"))
    with InferenceServer(lenet(device="cpu"), max_batch=8,
                         max_wait_ms=20.0) as srv:
        srv.swap_from_path(os.path.join(golden, "lenet.zip"))
        futs = [srv.submit(x) for x in io["x"]]
        got = np.stack([f.result(30) for f in futs])
    np.testing.assert_allclose(got, io["y"], rtol=0, atol=TOL)
    # swap_from_checkpoint: a fresh net from the factory, restored from
    # the manager's latest step, answers as the saved net
    from deeplearning4j_tpu_torch.util.sharded_checkpoint import \
        ShardedCheckpointManager
    saved = lenet(device="cpu")
    saved.fit(io["x"][:4], np.eye(10, dtype=np.float32)[:4])
    ShardedCheckpointManager(str(tmp_path)).save(saved, 5)
    with InferenceServer(lenet(device="cpu"), max_batch=8,
                         max_wait_ms=20.0) as srv:
        srv.swap_from_checkpoint(str(tmp_path),
                                 lambda: lenet(device="cpu", seed=99))
        got = np.stack([srv.submit(x).result(30) for x in io["x"][:3]])
    np.testing.assert_allclose(got, np.asarray(saved.output(io["x"][:3])),
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# (e) faults, deadlines, backpressure, screening
# ---------------------------------------------------------------------------

def test_retry_recovers_transient_batch_fault():
    net = _mln()
    inj = FaultInjector(seed=1).plan("serve.batch", on_call=0,
                                     exc=FaultInjected)
    rp = RetryPolicy(max_retries=3, base_delay=0.001,
                     retryable=(ConnectionError,))
    x = np.random.default_rng(11).standard_normal((6,)).astype(np.float32)
    with InferenceServer(net, max_wait_ms=1.0, fault_injector=inj,
                         retry_policy=rp) as srv:
        got = srv.predict(x, timeout=30)
    snap = srv.metrics.snapshot()
    assert snap.get("retries") == 1 and snap.get("failed", 0) == 0
    assert inj.fired("serve.batch")
    assert _bits_equal(got, net.output(np.stack([x, x]))[0])


def test_unretryable_batch_fault_fails_requests_loudly():
    net = _mln()
    inj = FaultInjector(seed=2).plan("serve.batch", on_call=0,
                                     exc=FaultInjected)
    x = np.random.default_rng(12).standard_normal((6,)).astype(np.float32)
    with InferenceServer(net, max_wait_ms=1.0, fault_injector=inj) as srv:
        f = srv.submit(x)
        with pytest.raises(FaultInjected):
            f.result(30)
        assert srv.predict(x, timeout=30) is not None     # survives
    assert srv.metrics.snapshot().get("failed") == 1


def test_deadline_shed_before_dispatch():
    net = _mln()
    x = np.random.default_rng(13).standard_normal((6,)).astype(np.float32)
    with InferenceServer(net, max_batch=2, max_wait_ms=50.0) as srv:
        f = srv.submit(x, deadline_ms=0.001)
        with pytest.raises(DeadlineExceededError):
            f.result(30)
    assert srv.metrics.snapshot().get("shed_deadline") == 1


def test_queue_full_backpressure():
    net = _mln()
    xs = np.random.default_rng(14).standard_normal((32, 6)).astype(
        np.float32)
    srv = InferenceServer(net, max_batch=2, max_wait_ms=100.0,
                          max_queue=2).start()
    try:
        with pytest.raises(ServerOverloadedError):
            for i in range(16):
                srv.submit(xs[i])
        assert srv.metrics.snapshot().get("shed_queue_full", 0) >= 1
    finally:
        srv.stop()


def test_corrupt_request_screened_not_fatal():
    net = _mln()
    inj = FaultInjector(seed=3).plan("serve.request", on_call=0,
                                     corrupt="nan")
    xs = np.random.default_rng(15).standard_normal((3, 6)).astype(np.float32)
    with InferenceServer(net, max_batch=4, max_wait_ms=20.0,
                         fault_injector=inj, screen_outputs=True) as srv:
        f_bad = srv.submit(xs[0])        # poisoned
        f_ok = [srv.submit(x) for x in xs[1:]]
        with pytest.raises(UnhealthyOutputError):
            f_bad.result(30)
        rows = [f.result(30) for f in f_ok]
        assert srv.predict(xs[0], timeout=30) is not None   # keeps serving
    assert srv.metrics.snapshot().get("unhealthy_outputs") == 1
    direct = net.output(xs)
    for i, r in enumerate(rows):
        assert _bits_equal(r, direct[i + 1])


def test_max_batch_one_keeps_bucket_floor():
    net = _mln()
    x = np.random.default_rng(21).standard_normal((6,)).astype(np.float32)
    with InferenceServer(net, max_batch=1, max_wait_ms=1.0) as srv:
        assert srv.buckets == (2,)
        got = srv.predict(x, timeout=30)
    assert _bits_equal(got, net.output(np.stack([x, x]))[0])


def test_request_spans_nest():
    """With a tracer on, each request has its queue-wait and request spans,
    and each dispatch sits inside its batch span."""
    tracer = obs.Tracer(enabled=True)
    xs = np.random.default_rng(5).standard_normal((4, 6)).astype(np.float32)
    with InferenceServer(_mln(), max_batch=4, max_wait_ms=20.0,
                         tracer=tracer) as srv:
        for f in [srv.submit(x) for x in xs]:
            f.result(30)
    names = [s.name for s in tracer.spans()]
    assert names.count("serve.request") == names.count(
        "serve.queue_wait") == 4
    batches = tracer.spans("serve.batch")
    for d in tracer.spans("serve.dispatch"):
        assert any(b.t0_ns <= d.t0_ns and d.t0_ns + d.dur_ns
                   <= b.t0_ns + b.dur_ns for b in batches)


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_card_lenet_bf16_within_bucket_bits(cuda):
    """On the card: the same images served twice by bucket 8 in other
    company are bit-equal (one thread, one cuDNN plan); against `output`
    of the same padded batch on this thread (its own cuDNN search) and
    against the CPU, within bf16's rounding (1e-2 on probabilities)."""
    net = lenet(device="cuda", data_type="bfloat16")
    cpu = lenet(device="cpu", data_type="bfloat16")
    xs = np.random.default_rng(6).random((16, 784), dtype=np.float32)
    with InferenceServer(net, max_batch=8, buckets=(2, 4, 8),
                         max_wait_ms=50.0) as srv:
        first = [f.result(60) for f in [srv.submit(x) for x in xs[:8]]]
        mixed = [f.result(60) for f in
                 [srv.submit(x) for x in np.concatenate([xs[8:12],
                                                         xs[:4]])]]
    for i in range(4):
        assert _bits_equal(first[i], mixed[4 + i])
    np.testing.assert_allclose(np.stack(first), net.output(xs[:8]),
                               atol=1e-2, rtol=0)
    np.testing.assert_allclose(np.stack(first), cpu.output(xs[:8]),
                               atol=1e-2, rtol=0)
