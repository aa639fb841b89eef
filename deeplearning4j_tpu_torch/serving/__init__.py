"""Serving: port of deeplearning4j_tpu/serving/ (so far `InferenceServer`,
the micro-batching server over a MultiLayerNetwork or ComputationGraph;
`ContinuousDecodeServer`, the continuous-batching decode server over a
TransformerLM with fixed-slot and paged KV caches, chunked prefill,
deadline-aware admission, brownout and fused decode windows; the block
pool, the KV artifacts, the load generator, their error types and
`ServingMetrics`; speculative decoding's draft sources; durable KV state:
preemption, migration and the prefix cache on disk). The fleet and the
wire come with ROADMAP.md queue 1 item 6."""
from .admission import (AdmissionController, BrownoutPolicy,
                        ServiceRateEstimator)
from .metrics import ServingMetrics
from .server import (DeadlineExceededError, InferenceServer,
                     PoisonPillError, ReplicaDeadError,
                     RequestDrainedError, RequestMigratedError,
                     ServerClosedError, ServerOverloadedError,
                     ServingError, UnhealthyOutputError)
from .decode import ContinuousDecodeServer
from .kvpool import BlockPool, PagedAllocation
from .kvstate import (KVStateError, KVStateVersionError,
                      PrefixCacheArtifact, RequestArtifact)
from .loadgen import (CHAOS_ACTIONS, ChaosSchedule, ClosedLoop,
                      DecodeSizeMix, InferenceSizeMix, OnOffProcess,
                      PoissonProcess, Schedule, SharedPrefixMix,
                      build_chaos_schedule, build_schedule, run_load)
from .speculate import DraftSource, ModelDraft, NGramDraft, Speculator

__all__ = [
    "InferenceServer", "ContinuousDecodeServer", "ServingMetrics",
    "ServingError", "ServerOverloadedError", "DeadlineExceededError",
    "UnhealthyOutputError", "ServerClosedError",
    "BlockPool", "PagedAllocation",
    "RequestArtifact", "PrefixCacheArtifact", "KVStateError",
    "KVStateVersionError", "RequestMigratedError",
    "ReplicaDeadError", "RequestDrainedError", "PoisonPillError",
    "AdmissionController", "BrownoutPolicy", "ServiceRateEstimator",
    "Speculator", "DraftSource", "NGramDraft", "ModelDraft",
    "PoissonProcess", "OnOffProcess", "ClosedLoop",
    "DecodeSizeMix", "SharedPrefixMix", "InferenceSizeMix", "Schedule",
    "build_schedule", "run_load",
    "ChaosSchedule", "CHAOS_ACTIONS", "build_chaos_schedule",
]
