"""Streaming: port of deeplearning4j_tpu/streaming/ (the npz wire serde,
the in-memory and Kafka brokers, and the inference and training pipelines
over the port's containers)."""
from . import serde
from .broker import Broker, InMemoryBroker, KafkaBroker, Subscription
from .pipelines import StreamingInferencePipeline, StreamingTrainingPipeline

__all__ = ["Broker", "InMemoryBroker", "KafkaBroker",
           "StreamingInferencePipeline", "StreamingTrainingPipeline",
           "Subscription", "serde"]
