"""The classic CNNs of the zoo, AlexNet, VGG-16 and GoogLeNet: port of
deeplearning4j_tpu/models/zoo/classic_cnns.py (the same configurations:
the dl4j model zoo's AlexNet.java / VGG16.java / GoogLeNet.java shapes on
the layer stack the reference's examples wire by hand). AlexNet and VGG-16
are sequential MultiLayerConfigurations, GoogLeNet a multi-branch
ComputationGraph (nine Inception modules, each joined by a channel
MergeVertex). NHWC at the API, bf16 by default; cuDNN runs the
convolutions (channels_last), and the builders take `device=` as `lenet`
does (None: the card).
"""
from __future__ import annotations

from ...nn.conf.input_type import InputType
from ...nn.conf.layers import (ConvolutionLayer, DenseLayer,
                               LocalResponseNormalization, OutputLayer,
                               SubsamplingLayer)
from ...nn.conf.neural_net_configuration import NeuralNetConfiguration


def alexnet_conf(height=224, width=224, channels=3, num_classes=1000,
                 seed=123, learning_rate=0.01, data_type="bfloat16"):
    """AlexNet (2012): 5 convs with LRN + maxpool, 3 dense with dropout."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed).updater("nesterovs").momentum(0.9)
         .learning_rate(learning_rate).weight_init("relu")
         .data_type(data_type)
         .list())
    li = 0

    def add(layer):
        nonlocal li
        b.layer(li, layer)
        li += 1

    add(ConvolutionLayer(n_out=96, kernel_size=(11, 11), stride=(4, 4),
                         convolution_mode="same", activation="relu"))
    add(LocalResponseNormalization())
    add(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                         stride=(2, 2)))
    add(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                         convolution_mode="same", activation="relu"))
    add(LocalResponseNormalization())
    add(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                         stride=(2, 2)))
    add(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                         convolution_mode="same", activation="relu"))
    add(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                         convolution_mode="same", activation="relu"))
    add(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                         convolution_mode="same", activation="relu"))
    add(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                         stride=(2, 2)))
    add(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
    add(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
    add(OutputLayer(n_out=num_classes, activation="softmax",
                    loss_function="mcxent"))
    return (b.set_input_type(InputType.convolutional(height, width,
                                                     channels)).build())


_VGG16_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def vgg16_conf(height=224, width=224, channels=3, num_classes=1000,
               seed=123, learning_rate=0.01, data_type="bfloat16"):
    """VGG-16: 13 3x3 convs in 5 blocks + 3 dense."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed).updater("nesterovs").momentum(0.9)
         .learning_rate(learning_rate).weight_init("relu")
         .data_type(data_type)
         .list())
    li = 0

    def add(layer):
        nonlocal li
        b.layer(li, layer)
        li += 1

    for width_, convs in _VGG16_PLAN:
        for _ in range(convs):
            add(ConvolutionLayer(n_out=width_, kernel_size=(3, 3),
                                 convolution_mode="same",
                                 activation="relu"))
        add(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                             stride=(2, 2)))
    add(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
    add(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
    add(OutputLayer(n_out=num_classes, activation="softmax",
                    loss_function="mcxent"))
    return (b.set_input_type(InputType.convolutional(height, width,
                                                     channels)).build())


def alexnet(device=None, **kwargs):
    """An initialised AlexNet MultiLayerNetwork, on the card unless
    `device` says otherwise; keyword arguments go to `alexnet_conf`."""
    from ...nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(alexnet_conf(**kwargs), device=device).init()


def vgg16(device=None, **kwargs):
    """An initialised VGG-16 MultiLayerNetwork, on the card unless
    `device` says otherwise; keyword arguments go to `vgg16_conf`."""
    from ...nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(vgg16_conf(**kwargs), device=device).init()


def googlenet_conf(height=224, width=224, channels=3, num_classes=1000,
                   seed=123, learning_rate=0.01, data_type="bfloat16"):
    """GoogLeNet / Inception-v1 (2014): nine Inception modules — each a
    four-branch DAG (1x1 / 1x1->3x3 / 1x1->5x5 / maxpool->1x1) joined by
    a MergeVertex on the channel axis — the era's classic multi-branch
    ComputationGraph (reference model-zoo GoogLeNet.java shape; auxiliary
    classifier heads omitted — they exist to aid 2014-era optimizers)."""
    from ...nn.conf.graph_vertices import MergeVertex
    from ...nn.conf.layers import GlobalPoolingLayer

    b = (NeuralNetConfiguration.Builder()
         .seed(seed).updater("nesterovs").momentum(0.9)
         .learning_rate(learning_rate).weight_init("relu")
         .data_type(data_type))
    gb = b.graph_builder().add_inputs("input")

    def conv(name, inp, n_out, k, stride=1):
        gb.add_layer(name, ConvolutionLayer(
            n_out=n_out, kernel_size=(k, k), stride=(stride, stride),
            convolution_mode="same", activation="relu"), inp)
        return name

    def inception(name, inp, c1, c3r, c3, c5r, c5, cp):
        """One four-branch module; returns the merge vertex name."""
        b1 = conv(f"{name}_1x1", inp, c1, 1)
        b3 = conv(f"{name}_3x3", conv(f"{name}_3x3r", inp, c3r, 1), c3, 3)
        b5 = conv(f"{name}_5x5", conv(f"{name}_5x5r", inp, c5r, 1), c5, 5)
        gb.add_layer(f"{name}_pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(1, 1),
            convolution_mode="same"), inp)
        bp = conv(f"{name}_poolproj", f"{name}_pool", cp, 1)
        gb.add_vertex(f"{name}_out", MergeVertex(), b1, b3, b5, bp)
        return f"{name}_out"

    x = conv("stem1", "input", 64, 7, stride=2)
    gb.add_layer("stem1_pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), x)
    gb.add_layer("stem1_lrn", LocalResponseNormalization(), "stem1_pool")
    x = conv("stem3", conv("stem2", "stem1_lrn", 64, 1), 192, 3)
    gb.add_layer("stem3_lrn", LocalResponseNormalization(), x)
    gb.add_layer("stem3_pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), "stem3_lrn")
    x = "stem3_pool"

    # (c1, c3r, c3, c5r, c5, pool-proj) per module — the v1 paper table
    plan = [("3a", 64, 96, 128, 16, 32, 32), ("3b", 128, 128, 192, 32, 96, 64),
            ("pool", ),
            ("4a", 192, 96, 208, 16, 48, 64), ("4b", 160, 112, 224, 24, 64, 64),
            ("4c", 128, 128, 256, 24, 64, 64), ("4d", 112, 144, 288, 32, 64, 64),
            ("4e", 256, 160, 320, 32, 128, 128),
            ("pool2", ),
            ("5a", 256, 160, 320, 32, 128, 128),
            ("5b", 384, 192, 384, 48, 128, 128)]
    for spec in plan:
        if len(spec) == 1:
            gb.add_layer(f"incep_{spec[0]}", SubsamplingLayer(
                pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
                convolution_mode="same"), x)
            x = f"incep_{spec[0]}"
        else:
            x = inception(f"incep_{spec[0]}", x, *spec[1:])

    gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    # DL4J dropout semantics: the value is the RETAIN probability
    # (Dropout.java DropOutInverted) — the paper's "40% dropout" = 0.6
    gb.add_layer("fc", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss_function="mcxent",
                                   dropout=0.6), "avgpool")
    return (gb.set_outputs("fc")
            .set_input_types(InputType.convolutional(height, width,
                                                     channels)).build())


def googlenet(device=None, **kwargs):
    """An initialised GoogLeNet ComputationGraph, on the card unless
    `device` says otherwise; keyword arguments go to `googlenet_conf`."""
    from ...nn.graph import ComputationGraph
    return ComputationGraph(googlenet_conf(**kwargs), device=device).init()
