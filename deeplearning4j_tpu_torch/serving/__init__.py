"""Serving: port of deeplearning4j_tpu/serving/ (so far `InferenceServer`,
the micro-batching server over a MultiLayerNetwork or ComputationGraph;
`ContinuousDecodeServer`, the continuous-batching decode server over a
TransformerLM with fixed-slot and paged KV caches, chunked prefill,
deadline-aware admission, brownout and fused decode windows; the block
pool, the KV artifacts, the load generator, their error types and
`ServingMetrics`; speculative decoding's draft sources; durable KV state:
preemption, migration and the prefix cache on disk; the fleet:
`FleetManager` over N replicas with its write-ahead `FleetJournal` and
`recover`, and the replica wire protocol, `ReplicaServer` /
`RemoteReplica` / `run_replica_server`)."""
from .admission import (AdmissionController, BrownoutPolicy,
                        ServiceRateEstimator)
from .metrics import ServingMetrics
from .server import (DeadlineExceededError, InferenceServer,
                     PoisonPillError, ReplicaDeadError,
                     RequestDrainedError, RequestMigratedError,
                     ServerClosedError, ServerOverloadedError,
                     ServingError, UnhealthyOutputError)
from .decode import ContinuousDecodeServer
from .fleet import (BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN, DEAD,
                    DEGRADED, DRAINING, HEALTHY, FleetManager,
                    RoundRobinSplitter)
from .fleetjournal import (FleetJournal, JournalBrokenError,
                           JournalCorruptError, fold_records,
                           replay_journal)
from .kvpool import BlockPool, PagedAllocation
from .kvstate import (KVStateError, KVStateVersionError,
                      PrefixCacheArtifact, RequestArtifact)
from .loadgen import (CHAOS_ACTIONS, ChaosSchedule, ClosedLoop,
                      DecodeSizeMix, InferenceSizeMix, OnOffProcess,
                      PoissonProcess, Schedule, SharedPrefixMix,
                      build_chaos_schedule, build_schedule, run_load)
from .speculate import DraftSource, ModelDraft, NGramDraft, Speculator
from .wire import (RemoteReplica, ReplicaServer, StaleEpochError,
                   WireProtocolError, WireRemoteError,
                   run_replica_server)

__all__ = [
    "InferenceServer", "ContinuousDecodeServer", "ServingMetrics",
    "ServingError", "ServerOverloadedError", "DeadlineExceededError",
    "UnhealthyOutputError", "ServerClosedError",
    "BlockPool", "PagedAllocation",
    "RequestArtifact", "PrefixCacheArtifact", "KVStateError",
    "KVStateVersionError", "RequestMigratedError",
    "FleetManager", "RoundRobinSplitter", "ReplicaDeadError",
    "RequestDrainedError", "PoisonPillError",
    "HEALTHY", "DEGRADED", "DRAINING", "DEAD",
    "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN",
    "AdmissionController", "BrownoutPolicy", "ServiceRateEstimator",
    "Speculator", "DraftSource", "NGramDraft", "ModelDraft",
    "PoissonProcess", "OnOffProcess", "ClosedLoop",
    "DecodeSizeMix", "SharedPrefixMix", "InferenceSizeMix", "Schedule",
    "build_schedule", "run_load",
    "ChaosSchedule", "CHAOS_ACTIONS", "build_chaos_schedule",
    "ReplicaServer", "RemoteReplica", "WireProtocolError",
    "WireRemoteError", "run_replica_server", "StaleEpochError",
    "FleetJournal", "JournalBrokenError", "JournalCorruptError",
    "fold_records", "replay_journal",
]
