from .attention import SelfAttentionLayer
from .base import LAYER_REGISTRY, NOT_PORTED, LayerConf, register_layer
from .convolution import (ConvolutionLayer, GlobalPoolingLayer,
                          SubsamplingLayer, ZeroPaddingLayer)
from .feedforward import (ActivationLayer, DenseLayer, DropoutLayer,
                          EmbeddingLayer, LossLayer, OutputLayer,
                          RnnOutputLayer)
from .normalization import BatchNormalization, LocalResponseNormalization
from .recurrent import (BaseRecurrentLayer, GravesBidirectionalLSTM,
                        GravesLSTM, SimpleRnn)


def _not_ported_class(name, layer_type):
    def __init__(self, *args, **kwargs):
        from .base import not_ported
        raise not_ported(layer_type)
    return type(name, (), {"__init__": __init__, "layer_type": layer_type})


# The reference's other layers: constructing one raises, naming its
# ROADMAP.md item.
RBM = _not_ported_class("RBM", "rbm")
VariationalAutoencoder = _not_ported_class("VariationalAutoencoder", "vae")
AutoEncoder = _not_ported_class("AutoEncoder", "autoencoder")

__all__ = [
    "LAYER_REGISTRY", "NOT_PORTED", "LayerConf", "register_layer",
    "ActivationLayer", "DenseLayer", "DropoutLayer", "EmbeddingLayer",
    "LossLayer", "OutputLayer",
    "ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer",
    "GlobalPoolingLayer", "BatchNormalization", "LocalResponseNormalization",
    "BaseRecurrentLayer", "GravesLSTM", "GravesBidirectionalLSTM",
    "SimpleRnn", "RnnOutputLayer",
    "SelfAttentionLayer", "RBM", "VariationalAutoencoder", "AutoEncoder",
]
