"""ResNet-50 as a ComputationGraph, the BASELINE.md configuration #2:
port of deeplearning4j_tpu/models/zoo/resnet.py (the same configuration
and helpers).

Standard ResNet-50 v1 topology: conv7x7/2 + maxpool3x3/2, then bottleneck
stages [3, 4, 6, 3] with widths (64,128,256,512)*expansion-4, global average
pool, softmax head. cuDNN runs its convolutions (bf16, channels_last);
BatchNorm trains through `_BNTrain`.
"""
from __future__ import annotations

from ...nn.conf.graph_vertices import ElementWiseVertex
from ...nn.conf.input_type import InputType
from ...nn.conf.layers import (ActivationLayer, BatchNormalization,
                               ConvolutionLayer, GlobalPoolingLayer,
                               OutputLayer, SubsamplingLayer)
from ...nn.conf.neural_net_configuration import NeuralNetConfiguration

EXPANSION = 4
STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def _conv_bn(gb, name, inp, n_out, kernel, stride, activation=None):
    # has_bias=False: BN's beta subsumes the conv bias
    gb.add_layer(f"{name}_conv",
                 ConvolutionLayer(n_out=n_out, kernel_size=kernel,
                                  stride=stride, convolution_mode="same",
                                  activation="identity", has_bias=False),
                 inp)
    gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
    out = f"{name}_bn"
    if activation:
        gb.add_layer(f"{name}_act", ActivationLayer(activation=activation),
                     f"{name}_bn")
        out = f"{name}_act"
    return out


def _bottleneck(gb, name, inp, width, stride, project):
    """1x1 (stride) -> 3x3 -> 1x1*4 with identity/projection shortcut."""
    x = _conv_bn(gb, f"{name}_a", inp, width, (1, 1), (stride, stride), "relu")
    x = _conv_bn(gb, f"{name}_b", x, width, (3, 3), (1, 1), "relu")
    x = _conv_bn(gb, f"{name}_c", x, width * EXPANSION, (1, 1), (1, 1))
    if project:
        sc = _conv_bn(gb, f"{name}_sc", inp, width * EXPANSION, (1, 1),
                      (stride, stride))
    else:
        sc = inp
    gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
    gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                 f"{name}_add")
    return f"{name}_out"


def resnet50_conf(height=224, width=224, channels=3, num_classes=1000,
                  seed=123, learning_rate=0.1, updater="nesterovs",
                  momentum=0.9, data_type="bfloat16",
                  updater_state_dtype=None):
    b = (NeuralNetConfiguration.Builder()
         .seed(seed)
         .updater(updater)
         .momentum(momentum)
         .learning_rate(learning_rate)
         .weight_init("relu")          # He init for relu nets
         .data_type(data_type))
    if updater_state_dtype:
        b = b.updater_state_dtype(updater_state_dtype)
    gb = b.graph_builder().add_inputs("input")
    x = _conv_bn(gb, "stem", "input", 64, (7, 7), (2, 2), "relu")
    gb.add_layer("stem_pool",
                 SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                  stride=(2, 2), convolution_mode="same"), x)
    x = "stem_pool"
    for si, (blocks, width_) in enumerate(STAGES):
        stride = 1 if si == 0 else 2
        for bi in range(blocks):
            x = _bottleneck(gb, f"s{si + 2}b{bi}", x, width_,
                            stride if bi == 0 else 1, bi == 0)
    gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    gb.add_layer("fc", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss_function="mcxent"), "avgpool")
    return (gb.set_outputs("fc")
            .set_input_types(InputType.convolutional(height, width, channels))
            .build())


def resnet50(device=None, remat=False, **kwargs):
    """An initialised ResNet-50 ComputationGraph, on the card unless
    `device` says otherwise; keyword arguments go to `resnet50_conf`.
    remat=True recomputes the training forward in segments cut at the
    residual adds (17 segments: 16 bottlenecks and the head)."""
    from ...nn.graph import ComputationGraph
    return ComputationGraph(resnet50_conf(**kwargs), remat_segments=remat,
                            device=device).init()
