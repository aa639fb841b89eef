"""PyTorch/CUDA port of `deeplearning4j_tpu`, for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here is held
against its counterpart by a parity test on the CPU. This package imports
neither JAX nor anything of `deeplearning4j_tpu`; it keeps its own copies of
what it needs.

Importing it is light: no kernel is built and CUDA need not be present.
Kernels are compiled with `nvcc` on first use (`ops/_build.py`).

Ported so far: the TransformerLM zoo model, training (`fit_batch`) and
inference (`models.zoo.transformer`), the flash-attention kernels it runs,
forward and backward (`ops.flash_attention`), the SGD-with-momentum
update (`parallel.pipeline`), ring attention (`parallel.ring_attention`),
and the training core: the configuration DSL, the LeNet and ResNet-50
layers, the updaters, `MultiLayerNetwork` and `ComputationGraph` (`nn`),
the model zips (`util.model_serializer`) and the LeNet and ResNet-50 zoo
models; the data and serving path: the datasets, iterators and
normalizers, `AsyncDataSetIterator` staging on CUDA streams (`datasets`),
`fit` over iterators, `evaluate` (`eval`), `InferenceServer` (`serving`),
and the stdlib halves they use (`obs`, `common.resilience`); the
TransformerLM's continuous-batching decode server (`serving.
ContinuousDecodeServer`, its serving programs in `models.zoo.transformer`,
and the block pool, admission control, KV artifacts and load generator it
uses); the recurrent path and the char-RNN; the embeddings; data-parallel
and parameter-server training (`parallel`); fused steps, K optimizer steps
as one CUDA graph replay (`nn.fused`), the training-health watchdog
(`common.health`) and the checkpoints of replicated training state its
rollback restores (`util.sharded_checkpoint`); the fleet and the wire:
`serving.FleetManager` over decode replicas, its journal and recovery, the
replica wire protocol (`serving.wire`) and the fleet plane (`obs.fleet`);
the training tools: listeners, the profiler and the full-batch solvers
(`optimize`), early stopping (`earlystopping`, and over the wrapper and
the master in `parallel`), gradient checks (`gradientcheck`); the classic
CNNs of the zoo (AlexNet, VGG-16, GoogLeNet) and `graft_entry`, the
ResNet-50 inference forward; layerwise pretraining and Keras import; model
parallelism; the training UI (`ui`: the stats listener over the step's own
activation summaries, the storages, `UIServer`), t-SNE (`plot`), k-means
and the spatial trees (`clustering`), the model guesser and the
ParallelWrapper command line (`parallel.main`). ROADMAP.md queues the
rest.

The package exports the reference's six names beside `resolve_device`.
"""
from .common.device import resolve_device
from .nn.conf.computation_graph_configuration import \
    ComputationGraphConfiguration
from .nn.conf.input_type import InputType
from .nn.conf.neural_net_configuration import (MultiLayerConfiguration,
                                               NeuralNetConfiguration)
from .nn.graph import ComputationGraph
from .nn.multilayer import MultiLayerNetwork

__all__ = [
    "ComputationGraph",
    "ComputationGraphConfiguration",
    "InputType",
    "MultiLayerConfiguration",
    "NeuralNetConfiguration",
    "MultiLayerNetwork",
    "resolve_device",
]
