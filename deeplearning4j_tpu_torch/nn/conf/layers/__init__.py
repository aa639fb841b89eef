from .attention import SelfAttentionLayer
from .base import LAYER_REGISTRY, LayerConf, register_layer
from .convolution import (ConvolutionLayer, GlobalPoolingLayer,
                          SubsamplingLayer, ZeroPaddingLayer)
from .feedforward import (ActivationLayer, AutoEncoder, DenseLayer,
                          DropoutLayer, EmbeddingLayer, LossLayer, OutputLayer,
                          RnnOutputLayer)
from .normalization import BatchNormalization, LocalResponseNormalization
from .rbm import RBM
from .recurrent import (BaseRecurrentLayer, GravesBidirectionalLSTM,
                        GravesLSTM, SimpleRnn)
from .variational import (BernoulliReconstructionDistribution,
                          GaussianReconstructionDistribution,
                          VariationalAutoencoder)

__all__ = [
    "LAYER_REGISTRY", "LayerConf", "register_layer",
    "ActivationLayer", "AutoEncoder", "DenseLayer", "DropoutLayer",
    "EmbeddingLayer", "LossLayer", "OutputLayer", "RnnOutputLayer",
    "ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer",
    "GlobalPoolingLayer", "BatchNormalization", "LocalResponseNormalization",
    "BaseRecurrentLayer", "GravesLSTM", "GravesBidirectionalLSTM", "SimpleRnn",
    "SelfAttentionLayer", "RBM", "VariationalAutoencoder",
    "BernoulliReconstructionDistribution",
    "GaussianReconstructionDistribution",
]
