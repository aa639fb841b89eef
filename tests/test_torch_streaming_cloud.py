"""The port's `streaming/` and `cloud/` against the JAX package's: the npz
wire serde, the brokers, the streaming pipelines, the object stores and
their DataSet iterator, and cluster provisioning.

Held, on the CPU:
  - serde: each package decodes the other's array and DataSet payloads to
    equal arrays (every dtype numpy keeps, masks included); a DataSet that
    holds tensors encodes as its numpy arrays, unpermuted; records are the
    same bytes;
  - the pipelines, on a small Dense net whose weights the reference drew
    (`from_jax_params`): the training pipeline's scores and the parameters
    after it, and the inference pipeline's outputs, within 1e-5 of the
    reference's pipelines; the inference rows equal the port's own
    `output()`; a worker's error is raised by `stop()` (and `error()`);
  - the Kafka broker: the same gate message without `kafka-python`, and
    the same calls on a stub of its client;
  - the object stores: the same keys, bytes and refusals (LocalFS, and S3
    and GCS over injected clients; the same gate messages without their
    packages); the iterator decodes either package's objects lazily, and
    `fit` over it equals a fit over the same DataSets in memory bit for bit
    and the reference's per-batch fits within 1e-5;
  - provisioning: the same setup runs and failures; every launch command
    carries the reference's variables with the reference's values, plus
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT from the same spec, and
    nothing else differs; `create_instances_command` renders the same text.

Tests marked `gpu` run on the card and skip without one:
    python -m pytest --noconftest tests/test_torch_streaming_cloud.py -m gpu
"""
import io
import shlex
import sys
import time
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.cloud import (ClusterProvisioner, ClusterSpec,
                                            GCSObjectStore, LocalCommandRunner,
                                            LocalFSObjectStore,
                                            ObjectStoreDataSetIterator,
                                            S3ObjectStore, SSHCommandRunner,
                                            create_instances_command)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.streaming import (InMemoryBroker, KafkaBroker,
                                                StreamingInferencePipeline,
                                                StreamingTrainingPipeline,
                                                serde)

TOL = 1e-5
CPU = "cpu"
NEW_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@pytest.fixture(scope="module")
def R():
    jax = pytest.importorskip("jax")
    import importlib
    import deeplearning4j_tpu as D
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    mods = {n: importlib.import_module(f"deeplearning4j_tpu.{n}")
            for n in ("streaming", "streaming.serde", "cloud",
                      "cloud.provision", "datasets.dataset")}
    return types.SimpleNamespace(
        jax=jax, D=D, Dense=DenseLayer, Output=OutputLayer,
        streaming=mods["streaming"], serde=mods["streaming.serde"],
        cloud=mods["cloud"], provision=mods["cloud.provision"],
        DataSet=mods["datasets.dataset"].DataSet)


def _nets(R, device=CPU):
    """tests/test_streaming_cloud.py's net (Dense 4-8 relu, softmax 2, Adam
    lr 0.02, seed 3): the reference's, and the port's with its weights."""
    D = R.D
    conf = (D.NeuralNetConfiguration.Builder().seed(3)
            .updater("adam").learning_rate(0.02).list()
            .layer(0, R.Dense(n_out=8, activation="relu"))
            .layer(1, R.Output(n_out=2, activation="softmax",
                               loss_function="mcxent"))
            .set_input_type(D.InputType.feed_forward(4)).build())
    ref = D.MultiLayerNetwork(conf).init()
    ours = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device=device).init()
    ours.from_jax_params(R.jax.tree.map(np.array, ref._params))
    return ref, ours


def _batches(n, seed=1, rows=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((rows, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x.sum(1) > 2).astype(int)]
        out.append((x, y))
    return out


def _collect(sub, n, timeout=60.0):
    got, deadline = [], time.time() + timeout
    while len(got) < n and time.time() < deadline:
        p = sub.get(timeout=0.05)
        if p is not None:
            got.append(p)
    assert len(got) == n, f"{len(got)} of {n} messages"
    return got


# ---------------------------------------------------------------------------
# serde
# ---------------------------------------------------------------------------

ARRAYS = {
    "f32": np.random.default_rng(0).random((3, 4)).astype(np.float32),
    "f64": np.random.default_rng(1).standard_normal((2, 3, 5)),
    "i32": np.arange(12, dtype=np.int32).reshape(3, 4),
    "bool": np.array([True, False, True]),
    "scalar": np.float32(2.5),
    "nhwc": np.random.default_rng(2).random((2, 5, 5, 3)).astype(np.float16),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_array_payloads_cross_decode(R, name):
    a = ARRAYS[name]
    for enc, dec in ((serde.encode_array, R.serde.decode_array),
                     (R.serde.encode_array, serde.decode_array),
                     (serde.encode_array, serde.decode_array)):
        got = dec(enc(a))
        assert got.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(got, a)
    t = torch.from_numpy(np.array(a))
    got = R.serde.decode_array(serde.encode_array(t))
    np.testing.assert_array_equal(got, a)    # a tensor as it is, unpermuted


@pytest.mark.parametrize("masks", ["none", "features", "both"])
def test_dataset_payloads_cross_decode(R, masks):
    rng = np.random.default_rng(3)
    x = rng.random((4, 3, 2)).astype(np.float32)
    y = rng.random((4, 2)).astype(np.float32)
    fm = np.ones((4, 3), np.float32) if masks != "none" else None
    lm = (rng.random((4, 3)) > 0.5).astype(np.float32) \
        if masks == "both" else None
    arrays = [x, y, fm, lm]
    as_tensors = DataSet(*[None if a is None else torch.from_numpy(a)
                           for a in arrays])
    for payload in (serde.encode_dataset(DataSet(*arrays)),
                    serde.encode_dataset(as_tensors),
                    R.serde.encode_dataset(R.DataSet(*arrays))):
        for dec in (serde.decode_dataset, R.serde.decode_dataset):
            ds = dec(payload)
            for got, want in zip((ds.features, ds.labels, ds.features_mask,
                                  ds.labels_mask), arrays):
                if want is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, want)
    assert type(serde.decode_dataset(serde.encode_dataset(
        DataSet(x, None)))) is DataSet
    assert serde.decode_dataset(serde.encode_dataset(
        DataSet(x, None))).labels is None


@pytest.mark.parametrize("values", [[1.5, -2.0, 3.25], [0, 1e-30, 7],
                                    [float("inf")], []])
def test_records_are_the_same_bytes(R, values):
    b = serde.encode_record(values)
    assert b == R.serde.encode_record(values)
    assert serde.decode_record(b) == R.serde.decode_record(b)


# ---------------------------------------------------------------------------
# brokers
# ---------------------------------------------------------------------------

def test_in_memory_broker_fans_out_in_order():
    broker = InMemoryBroker()
    a, b = broker.subscribe("t"), broker.subscribe("t")
    other = broker.subscribe("u")
    for i in range(5):
        broker.publish("t", bytes([i]))
    assert [a.get(timeout=1) for _ in range(5)] == [bytes([i])
                                                    for i in range(5)]
    assert b.drain() == [bytes([i]) for i in range(5)]
    assert other.get(timeout=0.01) is None and a.drain() == []


def test_kafka_gate_message_is_the_reference_s(R):
    msgs = []
    for cls in (KafkaBroker, R.streaming.KafkaBroker):
        with pytest.raises(ImportError, match="kafka-python") as e:
            cls()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_kafka_broker_protocol_contract(monkeypatch):
    """tests/test_streaming_cloud.py's stub of the kafka-python API."""
    sent, flushed, closed, consumers = [], [], [], []

    class FakeProducer:
        def __init__(self, bootstrap_servers=None):
            sent.append(("init", bootstrap_servers))

        def send(self, topic, payload):
            sent.append((topic, payload))

        def flush(self):
            flushed.append(True)

        def close(self):
            closed.append(True)

    class FakeConsumer:
        def __init__(self, topic, bootstrap_servers=None,
                     auto_offset_reset=None):
            consumers.append((topic, bootstrap_servers, auto_offset_reset))

        def __iter__(self):
            return iter([types.SimpleNamespace(value=b"m1"),
                         types.SimpleNamespace(value=b"m2")])

    fake = types.ModuleType("kafka")
    fake.KafkaProducer, fake.KafkaConsumer = FakeProducer, FakeConsumer
    monkeypatch.setitem(sys.modules, "kafka", fake)
    b = KafkaBroker(bootstrap_servers="broker:9092")
    b.publish("ndarray-topic", b"payload")
    assert sent == [("init", "broker:9092"), ("ndarray-topic", b"payload")]
    assert not flushed
    b.flush()
    sub = b.subscribe("ndarray-topic")
    assert consumers == [("ndarray-topic", "broker:9092", "earliest")]
    assert {sub.get(timeout=2), sub.get(timeout=2)} == {b"m1", b"m2"}
    b.close()
    assert closed == [True] and len(flushed) == 2


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

def _train_through(mod, net, batches, encode, DS):
    broker = mod.InMemoryBroker()
    pipe = mod.StreamingTrainingPipeline(net, broker, score_topic="scores")
    scores = broker.subscribe("scores")
    pipe.start()
    try:
        for x, y in batches:
            broker.publish("train", encode(DS(x, y)))
        got = _collect(scores, len(batches))
    finally:
        pipe.stop()
    assert pipe.batches_fit == len(batches)
    return [float(np.frombuffer(p, np.float64)[0]) for p in got]


def test_training_pipeline_matches_reference(R):
    ref, ours = _nets(R)
    batches = _batches(10)
    want = _train_through(R.streaming, ref, batches, R.serde.encode_dataset,
                          R.DataSet)
    got = _train_through(sys.modules["deeplearning4j_tpu_torch.streaming"],
                         ours, batches, serde.encode_dataset, DataSet)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours.params(), np.asarray(ref.params()),
                               rtol=TOL, atol=TOL)
    assert ours.conf.iteration_count == 10 and got[-1] < got[0]


def _infer_through(mod, net, xs, encode, decode):
    broker = mod.InMemoryBroker()
    out = broker.subscribe("predictions")
    pipe = mod.StreamingInferencePipeline(net, broker).start()
    try:
        for x in xs:
            broker.publish("features", encode(x))
        got = [decode(p) for p in _collect(out, len(xs))]
    finally:
        pipe.stop()
    assert pipe.processed == len(xs) and pipe.error() is None
    return got


def test_inference_pipeline_matches_reference(R):
    ref, ours = _nets(R)
    xs = [x for x, _ in _batches(4, seed=5, rows=5)]
    want = _infer_through(R.streaming, ref, xs, R.serde.encode_array,
                          R.serde.decode_array)
    got = _infer_through(sys.modules["deeplearning4j_tpu_torch.streaming"],
                         ours, xs, serde.encode_array, serde.decode_array)
    for g, w, x in zip(got, want, xs):
        assert g.shape == (5, 2) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(g, ours.output(x))


@pytest.mark.parametrize("kind", ["inference", "training"])
def test_pipeline_errors_are_raised_not_swallowed(R, kind):
    _, ours = _nets(R)
    broker = InMemoryBroker()
    cls = (StreamingInferencePipeline if kind == "inference"
           else StreamingTrainingPipeline)
    topic = "features" if kind == "inference" else "train"
    pipe = cls(ours, broker).start()
    broker.publish(topic, b"definitely not npz")
    deadline = time.time() + 20
    while pipe._error is None and time.time() < deadline:
        time.sleep(0.02)
    if kind == "inference":
        assert pipe.error() is pipe._error is not None
    with pytest.raises(Exception) as e:
        pipe.stop()
    assert e.value is pipe._error


# ---------------------------------------------------------------------------
# the object stores
# ---------------------------------------------------------------------------

def _store_ops(store):
    store.put("data/a.bin", b"hello")
    store.put("data/b.bin", b"world")
    store.put("other/c.bin", b"!")
    out = [store.get("data/a.bin"), store.list_keys("data/"),
           store.list_keys()]
    store.delete("data/a.bin")
    out.append(store.list_keys("data/"))
    return out


def test_local_store_equal(R, tmp_path):
    assert (_store_ops(LocalFSObjectStore(tmp_path / "ours"))
            == _store_ops(R.cloud.LocalFSObjectStore(tmp_path / "ref")))
    for cls in (LocalFSObjectStore, R.cloud.LocalFSObjectStore):
        with pytest.raises(ValueError, match="escapes"):
            cls(tmp_path / "x").put("../evil", b"x")
    store = LocalFSObjectStore(tmp_path / "files")
    src = tmp_path / "src.bin"
    src.write_bytes(b"\x00\x01payload")
    store.upload_file(str(src), "up/src.bin")
    store.download_file("up/src.bin", str(tmp_path / "deep" / "back.bin"))
    assert (tmp_path / "deep" / "back.bin").read_bytes() == b"\x00\x01payload"


class FakeS3:
    def __init__(self):
        self.objs = {}

    def put_object(self, Bucket, Key, Body):
        self.objs[(Bucket, Key)] = Body

    def get_object(self, Bucket, Key):
        return {"Body": io.BytesIO(self.objs[(Bucket, Key)])}

    def list_objects_v2(self, Bucket, Prefix):
        return {"Contents": [{"Key": k} for (b, k) in self.objs
                             if b == Bucket and k.startswith(Prefix)]}

    def delete_object(self, Bucket, Key):
        del self.objs[(Bucket, Key)]


class FakeGCS:
    """The google-cloud-storage calls GCSObjectStore makes."""

    def __init__(self):
        self.objs = {}

    def bucket(self, name):
        client = self

        class Blob:
            def __init__(self, key):
                self.name = key

            def upload_from_string(self, data):
                client.objs[(name, self.name)] = data

            def download_as_bytes(self):
                return client.objs[(name, self.name)]

            def delete(self):
                del client.objs[(name, self.name)]

        return types.SimpleNamespace(name=name, blob=Blob)

    def list_blobs(self, bucket, prefix=""):
        return [types.SimpleNamespace(name=k) for (b, k) in self.objs
                if b == bucket.name and k.startswith(prefix)]


@pytest.mark.parametrize("kind,fake", [("S3ObjectStore", FakeS3),
                                       ("GCSObjectStore", FakeGCS)])
def test_cloud_stores_with_injected_clients_equal(R, kind, fake):
    ours = _store_ops(getattr(sys.modules["deeplearning4j_tpu_torch.cloud"],
                              kind)("bkt", client=fake()))
    assert ours == _store_ops(getattr(R.cloud, kind)("bkt", client=fake()))
    assert ours[1] == ["data/a.bin", "data/b.bin"]


def test_cloud_store_gates_are_the_reference_s(R, monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    monkeypatch.setitem(sys.modules, "google.cloud", None)
    for port_cls, ref_cls, name in (
            (S3ObjectStore, R.cloud.S3ObjectStore, "boto3"),
            (GCSObjectStore, R.cloud.GCSObjectStore, "google-cloud-storage")):
        msgs = []
        for cls in (port_cls, ref_cls):
            with pytest.raises(ImportError, match=name) as e:
                cls("bkt")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


class _CountingStore(LocalFSObjectStore):
    gets = 0

    def get(self, key):
        type(self).gets += 1
        return super().get(key)


def test_object_store_iterator_decodes_either_package_lazily(R, tmp_path):
    store = _CountingStore(tmp_path / "store")
    batches = _batches(4, seed=7, rows=4)
    for i, (x, y) in enumerate(batches):
        enc = serde.encode_dataset if i % 2 else R.serde.encode_dataset
        DS = DataSet if i % 2 else R.DataSet
        store.put(f"ds/batch_{i}.npz", enc(DS(x, y)))
    store.put("ds/readme.txt", b"not a batch")
    it = ObjectStoreDataSetIterator(store, "ds/")
    assert it.keys == R.cloud.ObjectStoreDataSetIterator(store, "ds/").keys
    assert _CountingStore.gets == 0            # listed, nothing read yet
    first = it.next()
    assert _CountingStore.gets == 1 and type(first) is DataSet
    np.testing.assert_array_equal(first.features, batches[0][0])
    got = list(it)                             # __iter__ resets
    assert len(got) == 4 and _CountingStore.gets == 5
    for ds, (x, y) in zip(got, batches):
        np.testing.assert_array_equal(ds.features, x)
        np.testing.assert_array_equal(ds.labels, y)
    it.reset()
    assert it.has_next()

    def double(ds):
        ds.features = ds.features * 2
    it.set_pre_processor(double)               # a for-loop applies it too
    for ds, (x, _) in zip(it, batches):
        np.testing.assert_array_equal(ds.features, x * 2)


def test_fit_over_the_object_store(R, tmp_path):
    """`fit(ObjectStoreDataSetIterator)` equals a fit over the same
    DataSets in memory bit for bit, and the reference's per-batch fits
    (its `fit` takes no such iterator) within 1e-5."""
    store = LocalFSObjectStore(tmp_path / "store")
    batches = _batches(6, seed=9)
    for i, (x, y) in enumerate(batches):
        store.put(f"train/{i:03d}.npz", serde.encode_dataset(DataSet(x, y)))
    ref, from_store = _nets(R)
    _, in_memory = _nets(R)
    from_store.fit(ObjectStoreDataSetIterator(store, "train/"))
    in_memory.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    np.testing.assert_array_equal(from_store.params(), in_memory.params())
    assert from_store.score() == in_memory.score()
    for x, y in batches:
        ref.fit(R.DataSet(x, y))
    np.testing.assert_allclose(from_store.params(), np.asarray(ref.params()),
                               rtol=TOL, atol=TOL)
    assert from_store.conf.iteration_count == 6


# ---------------------------------------------------------------------------
# provisioning
# ---------------------------------------------------------------------------

def _env_of(command):
    words = shlex.split(command)
    assert words[0] == "env"
    env = {}
    for w in words[1:]:
        if "=" not in w:
            break
        k, v = w.split("=", 1)
        env[k] = v
    return env


@pytest.mark.parametrize("hosts,port", [
    (["hostA", "hostB"], 8476), (["10.0.0.7", "10.0.0.8", "10.0.0.9"], 29500),
    (["127.0.0.1"], 1234)])
def test_launch_commands_add_the_torch_distributed_variables(R, hosts, port):
    extra = {"EXTRA": "1", "QUOTED": "a b"}
    ours = ClusterProvisioner(ClusterSpec(hosts, coordinator_port=port,
                                          env=extra)
                              ).launch_commands("python worker.py --x 1")
    ref = R.cloud.ClusterProvisioner(R.cloud.ClusterSpec(
        hosts, coordinator_port=port, env=extra)).launch_commands(
            "python worker.py --x 1")
    assert [h for h, _ in ours] == [h for h, _ in ref] == hosts
    for rank, ((_, mine), (_, theirs)) in enumerate(zip(ours, ref)):
        env, want = _env_of(mine), _env_of(theirs)
        assert set(env) == set(want) | set(NEW_KEYS)
        assert {k: env[k] for k in want} == want
        assert {k: env[k] for k in NEW_KEYS} == {
            "MASTER_ADDR": hosts[0], "MASTER_PORT": str(port),
            "RANK": str(rank), "WORLD_SIZE": str(len(hosts))}
        assert env["DL4J_TPU_COORDINATOR"] == f"{hosts[0]}:{port}"
        stripped = " ".join(w for w in mine.split(" ")
                            if w.split("=", 1)[0] not in NEW_KEYS)
        assert stripped == theirs
        assert mine.endswith("python worker.py --x 1")


def test_provision_runs_and_fails_alike(R, tmp_path):
    def run(cloud, marker):
        spec = cloud.ClusterSpec(["hostA", "hostB"],
                                 setup_commands=[f"echo ok >> {marker}",
                                                 "echo done"])
        prov = cloud.ClusterProvisioner(
            spec, runner_factory=lambda host: cloud.LocalCommandRunner())
        out = prov.provision()
        bad = cloud.ClusterProvisioner(
            cloud.ClusterSpec(["h"], setup_commands=["exit 3"]),
            runner_factory=lambda host: cloud.LocalCommandRunner())
        with pytest.raises(RuntimeError, match="provisioning h failed") as e:
            bad.provision()
        return out, marker.read_text(), str(e.value)
    mod = sys.modules["deeplearning4j_tpu_torch.cloud"]
    assert run(mod, tmp_path / "a") == run(R.cloud, tmp_path / "b")


def test_runners_and_instance_commands_equal(R, tmp_path):
    for kw in ({}, {"user": "me", "key_file": "k.pem",
                    "ssh_options": ("-p", "22")}):
        a, b = SSHCommandRunner("h", **kw), R.cloud.SSHCommandRunner("h", **kw)
        assert (a.target, a.key_args, a.extra) == (b.target, b.key_args,
                                                   b.extra)
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.write_text("x")
    LocalCommandRunner().copy_to(str(src), str(dst))
    assert dst.read_text() == "x"
    assert LocalCommandRunner().run("echo hi; echo err >&2") == (0,
                                                                 "hi\nerr\n")
    for kw in ({}, {"accelerator_type": "v5e-8", "count": 2},
               {"count": 3, "image_family": "ubuntu"}):
        assert (create_instances_command("trainer", "us-central2-b", **kw)
                == R.cloud.create_instances_command("trainer",
                                                    "us-central2-b", **kw))


# ---------------------------------------------------------------------------
# Card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_serde_of_a_dataset_on_the_card(cuda):
    rng = np.random.default_rng(11)
    x = rng.random((2, 5, 5, 3)).astype(np.float32)
    y = rng.random((2, 4)).astype(np.float32)
    ds = serde.decode_dataset(serde.encode_dataset(
        DataSet(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda))))
    np.testing.assert_array_equal(ds.features, x)
    np.testing.assert_array_equal(ds.labels, y)


def _port_net(device):
    """The same net built by the port alone (the card's machine has no
    JAX)."""
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    conf = (NeuralNetConfiguration.Builder().seed(3)
            .updater("adam").learning_rate(0.02).list()
            .layer(0, DenseLayer(n_out=8, activation="relu"))
            .layer(1, OutputLayer(n_out=2, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device=device).init()


@pytest.mark.gpu
def test_pipelines_on_the_card_match_the_cpu(cuda):
    T = sys.modules["deeplearning4j_tpu_torch.streaming"]
    batches = _batches(10)
    cpu = _port_net(CPU)
    card = _port_net(cuda)
    card.set_params(cpu.params())
    got = _train_through(T, card, batches, serde.encode_dataset, DataSet)
    for x, y in batches:
        cpu.fit(DataSet(x, y))
    np.testing.assert_allclose(card.params(), cpu.params(), rtol=TOL,
                               atol=TOL)
    assert abs(got[-1] - cpu.score()) <= TOL
    xs = [x for x, _ in _batches(3, seed=5, rows=5)]
    for g, x in zip(_infer_through(T, card, xs, serde.encode_array,
                                   serde.decode_array), xs):
        np.testing.assert_allclose(g, cpu.output(x), rtol=TOL, atol=TOL)
