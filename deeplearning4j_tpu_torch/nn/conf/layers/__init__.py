from .base import LAYER_REGISTRY, NOT_PORTED, LayerConf, register_layer
from .convolution import (ConvolutionLayer, GlobalPoolingLayer,
                          SubsamplingLayer, ZeroPaddingLayer)
from .feedforward import (ActivationLayer, DenseLayer, DropoutLayer,
                          EmbeddingLayer, LossLayer, OutputLayer)
from .normalization import BatchNormalization, LocalResponseNormalization


def _not_ported_class(name, layer_type):
    def __init__(self, *args, **kwargs):
        from .base import not_ported
        raise not_ported(layer_type)
    return type(name, (), {"__init__": __init__, "layer_type": layer_type})


# The reference's other layers: constructing one raises, naming its
# ROADMAP.md item.
GravesLSTM = _not_ported_class("GravesLSTM", "graveslstm")
GravesBidirectionalLSTM = _not_ported_class("GravesBidirectionalLSTM",
                                            "gravesbidirectionallstm")
SimpleRnn = _not_ported_class("SimpleRnn", "simplernn")
RnnOutputLayer = _not_ported_class("RnnOutputLayer", "rnnoutput")
SelfAttentionLayer = _not_ported_class("SelfAttentionLayer", "selfattention")
RBM = _not_ported_class("RBM", "rbm")
VariationalAutoencoder = _not_ported_class("VariationalAutoencoder", "vae")
AutoEncoder = _not_ported_class("AutoEncoder", "autoencoder")

__all__ = [
    "LAYER_REGISTRY", "NOT_PORTED", "LayerConf", "register_layer",
    "ActivationLayer", "DenseLayer", "DropoutLayer", "EmbeddingLayer",
    "LossLayer", "OutputLayer",
    "ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer",
    "GlobalPoolingLayer", "BatchNormalization", "LocalResponseNormalization",
    "GravesLSTM", "GravesBidirectionalLSTM", "SimpleRnn", "RnnOutputLayer",
    "SelfAttentionLayer", "RBM", "VariationalAutoencoder", "AutoEncoder",
]
