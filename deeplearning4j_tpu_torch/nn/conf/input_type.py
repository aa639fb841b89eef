"""Input type shape inference: a copy of
deeplearning4j_tpu/nn/conf/input_type.py (no JAX in it).

Equivalent of the DL4J InputType
(reference: nn/conf/inputs/InputType.java — kinds FF/RNN/CNN/CNNFlat), used by
layer configs to infer nIn and by the container builder to insert preprocessors
(reference: MultiLayerConfiguration.Builder.setInputType ->
 Layer.getPreProcessorForInputType / getOutputType).

Layouts (the reference's, where they differ from DL4J's):
- feedforward: [batch, size]                     (same as reference)
- recurrent:   [batch, time, size]               (reference uses [batch, size, time];
                                                  time as axis 1)
- convolutional: [batch, height, width, channels] (NHWC; DL4J uses NCHW)

The types describe the networks' NHWC inputs and outputs. Inside, the
port runs images as NCHW tensors in the channels_last memory format
(the same bytes as NHWC); the containers convert at their boundary.
"""
from __future__ import annotations

from dataclasses import dataclass


class InputType:
    @staticmethod
    def feed_forward(size):
        return FeedForwardInputType(int(size))

    @staticmethod
    def recurrent(size, time_series_length=-1):
        return RecurrentInputType(int(size), int(time_series_length))

    @staticmethod
    def convolutional(height, width, channels):
        return ConvolutionalInputType(int(height), int(width), int(channels))

    @staticmethod
    def convolutional_flat(height, width, depth):
        return ConvolutionalFlatInputType(int(height), int(width), int(depth))

    # --- serde ------------------------------------------------------------
    def to_dict(self):
        raise NotImplementedError

    @staticmethod
    def from_dict(d):
        kind = d["kind"]
        if kind == "feedforward":
            return InputType.feed_forward(d["size"])
        if kind == "recurrent":
            return InputType.recurrent(d["size"], d.get("timeSeriesLength", -1))
        if kind == "convolutional":
            return InputType.convolutional(d["height"], d["width"], d["channels"])
        if kind == "convolutionalflat":
            return InputType.convolutional_flat(d["height"], d["width"], d["depth"])
        raise ValueError(f"Unknown InputType kind {kind}")


@dataclass(frozen=True)
class FeedForwardInputType(InputType):
    size: int

    def to_dict(self):
        return {"kind": "feedforward", "size": self.size}


@dataclass(frozen=True)
class RecurrentInputType(InputType):
    size: int
    time_series_length: int = -1

    def to_dict(self):
        return {"kind": "recurrent", "size": self.size,
                "timeSeriesLength": self.time_series_length}


@dataclass(frozen=True)
class ConvolutionalInputType(InputType):
    height: int
    width: int
    channels: int

    def to_dict(self):
        return {"kind": "convolutional", "height": self.height,
                "width": self.width, "channels": self.channels}


@dataclass(frozen=True)
class ConvolutionalFlatInputType(InputType):
    """Flattened image input [batch, h*w*depth] (e.g. raw MNIST vectors).

    reference: InputType.InputTypeConvolutionalFlat."""
    height: int
    width: int
    depth: int

    @property
    def flattened_size(self):
        return self.height * self.width * self.depth

    def to_dict(self):
        return {"kind": "convolutionalflat", "height": self.height,
                "width": self.width, "depth": self.depth}
