from . import keras_import as KerasModelImport
from .keras_import import (import_keras_model_and_weights,
                           import_keras_model_configuration,
                           import_keras_sequential_model_and_weights)
from .server import DeepLearning4jEntryPoint, KerasBridgeServer

__all__ = ["DeepLearning4jEntryPoint", "KerasBridgeServer",
           "KerasModelImport", "import_keras_model_and_weights",
           "import_keras_model_configuration",
           "import_keras_sequential_model_and_weights"]
