"""LeNet, the BASELINE.md configuration #1: port of
deeplearning4j_tpu/models/zoo/lenet.py (the same configuration, the
classic DL4J LeNet-MNIST example), trained by MultiLayerNetwork.fit().
"""
from __future__ import annotations

from ...nn.conf.input_type import InputType
from ...nn.conf.layers import (ConvolutionLayer, DenseLayer, OutputLayer,
                               SubsamplingLayer)
from ...nn.conf.neural_net_configuration import NeuralNetConfiguration


def lenet_conf(height=28, width=28, channels=1, num_classes=10, seed=123,
               learning_rate=0.01, updater="nesterovs", momentum=0.9,
               data_type="float32"):
    return (NeuralNetConfiguration.Builder()
            .seed(seed)
            .updater(updater)
            .momentum(momentum)
            .learning_rate(learning_rate)
            .weight_init("xavier")
            .data_type(data_type)
            .list()
            .layer(0, ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                       stride=(1, 1), activation="identity"))
            .layer(1, SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                       stride=(2, 2)))
            .layer(2, ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                       stride=(1, 1), activation="identity"))
            .layer(3, SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                       stride=(2, 2)))
            .layer(4, DenseLayer(n_out=500, activation="relu"))
            .layer(5, OutputLayer(n_out=num_classes, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.convolutional_flat(height, width, channels))
            .build())


def lenet(device=None, **kwargs):
    """An initialised LeNet MultiLayerNetwork, on the card unless `device`
    says otherwise; keyword arguments go to `lenet_conf`."""
    from ...nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(lenet_conf(**kwargs), device=device).init()
