"""Parallel training: port of deeplearning4j_tpu/parallel/.

Data-parallel training over a `torch.distributed` process group
(`ParallelWrapper` in all-reduce and k-local-steps modes, `sharding`'s data
mesh, `distributed`, `MagicQueue`), the asynchronous parameter server
(`GradientsAccumulator`, `ParameterServerParallelWrapper`, its TCP transport
`PSServer` / `PSClient` / `ps_worker_fit`, `ParameterServerTrainingHook`),
the `TrainingMaster` and its facades, early stopping over the wrapper and
the master (`early_stopping`), the time sources, ring attention (sequence
parallelism) and `pipeline.sgd_momentum_update`.

Not ported yet: the names below raise NotImplementedError naming their
ROADMAP.md queue 1 item: the pipeline schedule, MoE and the sharded
updater state (item 20), and the ParallelWrapper command line (`main`,
item 22, with `util/model_guesser.py` and `ui/`).
"""
from . import distributed, early_stopping
from .early_stopping import (EarlyStoppingParallelTrainer,
                             MasterDataSetLossCalculator,
                             SparkEarlyStoppingTrainer,
                             TpuEarlyStoppingTrainer)
from .magic_queue import MagicQueue
from .parallel_wrapper import ParallelWrapper
from .parameter_server import (GradientsAccumulator,
                               ParameterServerParallelWrapper)
from .ps_transport import PSClient, PSServer, ps_worker_fit
from .ring_attention import blockwise_attention, ring_self_attention
from .sharding import make_mesh, not_ported, shard_params
from .time_source import NTPTimeSource, SystemClockTimeSource, TimeSource
from .training_hook import ParameterServerTrainingHook, TrainingHook
from .training_master import (ParameterAveragingTrainingMaster,
                              TpuComputationGraph, TpuDl4jMultiLayer,
                              TrainingMasterStats)

_NOT_PORTED = {
    **dict.fromkeys(("PipelineParallel", "gpipe", "make_pipeline_mesh",
                     "init_moe", "make_expert_mesh", "moe_mlp_dense",
                     "moe_mlp_sharded", "shard_moe_params",
                     "zero_state_sharding", "mesh_cost", "moe"), 20),
    "main": 22,
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise not_ported(f"parallel.{name}", _NOT_PORTED[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["EarlyStoppingParallelTrainer", "GradientsAccumulator",
           "MagicQueue", "MasterDataSetLossCalculator", "NTPTimeSource",
           "ParallelWrapper", "ParameterAveragingTrainingMaster",
           "ParameterServerParallelWrapper", "ParameterServerTrainingHook",
           "PSClient", "PSServer", "ps_worker_fit",
           "SparkEarlyStoppingTrainer", "SystemClockTimeSource",
           "TimeSource", "TpuComputationGraph", "TpuDl4jMultiLayer",
           "TpuEarlyStoppingTrainer",
           "TrainingHook", "TrainingMasterStats", "blockwise_attention",
           "distributed", "early_stopping", "make_mesh", "ring_self_attention",
           "shard_params"]
