"""Serving: port of deeplearning4j_tpu/serving/ (so far `InferenceServer`,
the micro-batching server over a MultiLayerNetwork or ComputationGraph,
its error types and `ServingMetrics`). The decode server, the fleet and
the wire come with ROADMAP.md queue 1 items 1-6."""
from .metrics import ServingMetrics
from .server import (DeadlineExceededError, InferenceServer,
                     PoisonPillError, ReplicaDeadError,
                     RequestDrainedError, RequestMigratedError,
                     ServerClosedError, ServerOverloadedError,
                     ServingError, UnhealthyOutputError)

__all__ = [
    "InferenceServer", "ServingMetrics",
    "ServingError", "ServerOverloadedError", "DeadlineExceededError",
    "UnhealthyOutputError", "ServerClosedError", "RequestMigratedError",
    "RequestDrainedError", "PoisonPillError", "ReplicaDeadError",
]
