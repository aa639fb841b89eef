"""Message transport for streaming pipelines.

The port's copy of deeplearning4j_tpu/streaming/broker.py, held against it
by tests/test_torch_streaming_cloud.py; the text below is the reference's.

TPU-native equivalent of reference dl4j-streaming's Kafka layer
(streaming/kafka/NDArrayPublisher.java, NDArrayConsumer.java over Camel
routes): a minimal Broker SPI with
- InMemoryBroker: in-process topics (the EmbeddedKafkaCluster role the
  reference uses in tests — SURVEY §4.6),
- KafkaBroker: real Kafka via kafka-python, import-gated (this image ships
  no Kafka client; the class raises a clear error at construction).
Payloads are opaque bytes; serde.py handles array/DataSet encoding.
"""
from __future__ import annotations

import queue
import threading


class Broker:
    def publish(self, topic, payload: bytes):
        raise NotImplementedError

    def subscribe(self, topic):
        """Returns a Subscription with get(timeout) -> bytes | None."""
        raise NotImplementedError


class Subscription:
    def __init__(self):
        self._q = queue.Queue()

    def get(self, timeout=None):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _deliver(self, payload):
        self._q.put(payload)

    def drain(self):
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out


class InMemoryBroker(Broker):
    """Topic fan-out to every subscriber (Kafka consumer-group-per-
    subscription semantics, which is how the reference's routes use it)."""

    def __init__(self):
        self._subs = {}
        self._lock = threading.Lock()

    def publish(self, topic, payload):
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for s in subs:
            s._deliver(payload)

    def subscribe(self, topic):
        s = Subscription()
        with self._lock:
            self._subs.setdefault(topic, []).append(s)
        return s


class KafkaBroker(Broker):
    """Real Kafka transport (reference KafkaUriBuilder/NDArrayPublisher
    path). Requires the `kafka-python` package, which is not baked into
    this environment — constructing without it raises with instructions
    rather than failing deep inside a pipeline."""

    def __init__(self, bootstrap_servers="localhost:9092"):
        try:
            from kafka import KafkaConsumer, KafkaProducer  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "KafkaBroker needs the 'kafka-python' package; install it "
                "or use InMemoryBroker (the embedded-broker test "
                "transport)") from e
        from kafka import KafkaProducer
        self.bootstrap = bootstrap_servers
        self._producer = KafkaProducer(bootstrap_servers=bootstrap_servers)

    def publish(self, topic, payload):
        # async send — Kafka batches; flush() is explicit (a per-message
        # flush would serialize every publish behind a broker round-trip)
        self._producer.send(topic, payload)

    def flush(self):
        self._producer.flush()

    def close(self):
        self._producer.flush()
        self._producer.close()

    def subscribe(self, topic):
        from kafka import KafkaConsumer
        consumer = KafkaConsumer(topic, bootstrap_servers=self.bootstrap,
                                 auto_offset_reset="earliest")
        sub = Subscription()

        def pump():
            for msg in consumer:
                sub._deliver(msg.value)

        threading.Thread(target=pump, daemon=True).start()
        return sub
