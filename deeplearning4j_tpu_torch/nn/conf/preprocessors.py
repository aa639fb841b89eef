"""Input preprocessors, shape adapters between layer families: port of
deeplearning4j_tpu/nn/conf/preprocessors.py (same classes, names and
serialisation; `pre_process` on tensors, autograd for the backward).

Layouts: the port's images are NCHW tensors (channels_last in memory);
RNN activations are [batch, time, size]. Flattening follows the
reference's NHWC order, so a dense layer's weight rows stay in (h, w, c)
order and carry over from the reference unchanged: for a channels_last
tensor that flatten is a view.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .input_type import InputType

PREPROC_REGISTRY = {}


def to_nhwc(x):
    """The port's NCHW image as the reference's NHWC (a view)."""
    return x.permute(0, 2, 3, 1)


def from_nhwc(x):
    """An NHWC image as the port's NCHW (a view; channels_last when `x`
    is contiguous)."""
    return x.permute(0, 3, 1, 2)


def register_preproc(name):
    def deco(cls):
        PREPROC_REGISTRY[name] = cls
        cls.preproc_type = name
        return cls
    return deco


class InputPreProcessor:
    def pre_process(self, x):
        raise NotImplementedError

    def get_output_type(self, input_type):
        raise NotImplementedError

    def to_dict(self):
        d = {"type": self.preproc_type}
        d.update({k: v for k, v in self.__dict__.items()})
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        typ = d.pop("type")
        return PREPROC_REGISTRY[typ](**d)


@register_preproc("cnn_to_ff")
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B,C,H,W] -> [B, H*W*C], flattened in NHWC order."""
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def pre_process(self, x):
        if x.ndim == 4:
            x = to_nhwc(x)
        return x.reshape(x.shape[0], -1)

    def get_output_type(self, input_type):
        return InputType.feed_forward(
            self.input_height * self.input_width * self.num_channels)


@register_preproc("ff_to_cnn")
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[B, H*W*C] (NHWC order) -> [B,C,H,W]."""
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def pre_process(self, x):
        if x.ndim == 4:
            return x
        return from_nhwc(x.reshape(x.shape[0], self.input_height,
                                   self.input_width, self.num_channels))

    def get_output_type(self, input_type):
        return InputType.convolutional(self.input_height, self.input_width,
                                       self.num_channels)


@register_preproc("ff_to_rnn")
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """Identity on tensors (dense layers broadcast over time); kept for
    configuration parity."""

    def pre_process(self, x):
        return x

    def get_output_type(self, input_type):
        from .input_type import FeedForwardInputType
        if isinstance(input_type, FeedForwardInputType):
            return InputType.recurrent(input_type.size)
        return input_type


@register_preproc("rnn_to_ff")
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """Identity (time axis broadcasting); configuration parity only."""

    def pre_process(self, x):
        return x

    def get_output_type(self, input_type):
        from .input_type import RecurrentInputType
        if isinstance(input_type, RecurrentInputType):
            return InputType.feed_forward(input_type.size)
        return input_type


@register_preproc("cnn_to_rnn")
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B,T,H,W,C] -> [B,T,F]."""
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def pre_process(self, x):
        return x.reshape(x.shape[0], x.shape[1], -1)

    def get_output_type(self, input_type):
        return InputType.recurrent(
            self.input_height * self.input_width * self.num_channels)


@register_preproc("rnn_to_cnn")
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[B,T,H*W*C] -> [B,T,H,W,C], for time-distributed layers."""
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def pre_process(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.input_height,
                         self.input_width, self.num_channels)

    def get_output_type(self, input_type):
        return InputType.convolutional(self.input_height, self.input_width,
                                       self.num_channels)


@register_preproc("reshape")
@dataclass
class ReshapePreProcessor(InputPreProcessor):
    """Reshape the trailing dims, in the reference's NHWC terms."""
    target_shape: tuple = field(default_factory=tuple)

    def pre_process(self, x):
        shape = tuple(self.target_shape)
        if x.ndim == 4:
            x = to_nhwc(x)
        x = x.reshape((x.shape[0],) + shape)
        return from_nhwc(x) if x.ndim == 4 else x

    def get_output_type(self, input_type):
        shape = tuple(self.target_shape)
        if len(shape) == 1:
            return InputType.feed_forward(shape[0])
        if len(shape) == 2:
            return InputType.recurrent(shape[1])
        if len(shape) == 3:
            return InputType.convolutional(shape[0], shape[1], shape[2])
        return input_type

    def to_dict(self):
        return {"type": "reshape", "target_shape": list(self.target_shape)}


@register_preproc("composable")
class ComposableInputPreProcessor(InputPreProcessor):
    def __init__(self, processors=()):
        self.processors = [p if isinstance(p, InputPreProcessor)
                           else InputPreProcessor.from_dict(p) for p in processors]

    def pre_process(self, x):
        for p in self.processors:
            x = p.pre_process(x)
        return x

    def get_output_type(self, input_type):
        for p in self.processors:
            input_type = p.get_output_type(input_type)
        return input_type

    def to_dict(self):
        return {"type": "composable",
                "processors": [p.to_dict() for p in self.processors]}
