"""Parallel training: port of deeplearning4j_tpu/parallel/.

Data-parallel training over a `torch.distributed` process group
(`ParallelWrapper` in all-reduce and k-local-steps modes, `sharding`'s data
mesh, `distributed`, `MagicQueue`), the asynchronous parameter server
(`GradientsAccumulator`, `ParameterServerParallelWrapper`, its TCP transport
`PSServer` / `PSClient` / `ps_worker_fit`, `ParameterServerTrainingHook`),
the `TrainingMaster` and its facades, early stopping over the wrapper and
the master (`early_stopping`), the time sources, ring attention (sequence
parallelism), and model parallelism: the named-axis mesh, tensor
parallelism and the ZeRO-style updater state (`sharding`, the wrapper),
GPipe (`pipeline`), expert-parallel MoE (`moe`) and the collective cost
recorder (`mesh_cost`), and the ParallelWrapper command line (`main`:
`python -m deeplearning4j_tpu_torch.parallel.main`).
"""
from . import distributed, early_stopping
from .early_stopping import (EarlyStoppingParallelTrainer,
                             MasterDataSetLossCalculator,
                             SparkEarlyStoppingTrainer,
                             TpuEarlyStoppingTrainer)
from . import mesh_cost, moe
from .magic_queue import MagicQueue
from .moe import (init_moe, make_expert_mesh, moe_mlp_dense, moe_mlp_sharded,
                  shard_moe_params)
from .parallel_wrapper import ParallelWrapper
from .parameter_server import (GradientsAccumulator,
                               ParameterServerParallelWrapper)
from .ps_transport import PSClient, PSServer, ps_worker_fit
from .pipeline import PipelineParallel, gpipe, make_pipeline_mesh
from .ring_attention import blockwise_attention, ring_self_attention
from .sharding import make_mesh, shard_params, zero_state_sharding
from .time_source import NTPTimeSource, SystemClockTimeSource, TimeSource
from .training_hook import ParameterServerTrainingHook, TrainingHook
from .training_master import (ParameterAveragingTrainingMaster,
                              TpuComputationGraph, TpuDl4jMultiLayer,
                              TrainingMasterStats)

__all__ = ["EarlyStoppingParallelTrainer", "GradientsAccumulator",
           "MagicQueue", "PipelineParallel", "gpipe", "make_pipeline_mesh",
           "init_moe", "make_expert_mesh", "moe_mlp_dense",
           "moe_mlp_sharded", "shard_moe_params", "mesh_cost", "moe",
           "zero_state_sharding", "MasterDataSetLossCalculator", "NTPTimeSource",
           "ParallelWrapper", "ParameterAveragingTrainingMaster",
           "ParameterServerParallelWrapper", "ParameterServerTrainingHook",
           "PSClient", "PSServer", "ps_worker_fit",
           "SparkEarlyStoppingTrainer", "SystemClockTimeSource",
           "TimeSource", "TpuComputationGraph", "TpuDl4jMultiLayer",
           "TpuEarlyStoppingTrainer",
           "TrainingHook", "TrainingMasterStats", "blockwise_attention",
           "distributed", "early_stopping", "make_mesh", "ring_self_attention",
           "shard_params"]
