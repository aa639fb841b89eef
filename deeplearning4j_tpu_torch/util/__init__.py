"""Utilities: port of deeplearning4j_tpu/util/ (the model zips,
`model_serializer`, the training-state checkpoints of replicated state,
`sharded_checkpoint`, and `model_guesser`, which loads whichever model or
configuration a file holds). The reference's twelve names, in its order;
`ModelGuesser` and `ModelSerializer` are the modules. Each submodule
imports only the standard library, numpy and torch when it is imported
(the containers when a function runs), so `common.health`, which imports
`util.model_serializer`, can import this package first."""
from . import model_guesser as ModelGuesser  # noqa: N812
from . import model_serializer as ModelSerializer  # noqa: N812
from .model_guesser import load_config_guess, load_model_guess
from .model_serializer import (restore_computation_graph, restore_model,
                               restore_multi_layer_network, write_model)
from .sharded_checkpoint import (ShardedCheckpointManager,
                                 ShardedModelSaver,
                                 load_checkpoint, save_checkpoint)

__all__ = ["ModelGuesser", "ModelSerializer",
           "ShardedCheckpointManager", "ShardedModelSaver",
           "load_checkpoint",
           "save_checkpoint", "load_config_guess",
           "load_model_guess", "restore_computation_graph", "restore_model",
           "restore_multi_layer_network", "write_model"]
