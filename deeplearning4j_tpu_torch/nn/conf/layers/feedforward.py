"""Feed-forward layer configs: port of
deeplearning4j_tpu/nn/conf/layers/feedforward.py (Dense, Output, Loss,
Activation, Dropout, Embedding).

Forward math as the reference: preOutput = x @ W + b with W [n_in, n_out],
the activation on top; cuBLAS runs the product. RnnOutputLayer and
AutoEncoder are not ported yet (`base.NOT_PORTED`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import activations, losses, weights
from ..input_type import (ConvolutionalFlatInputType, ConvolutionalInputType,
                          FeedForwardInputType, InputType, RecurrentInputType)
from .base import LayerConf, apply_input_dropout, register_layer


def _dense_params(conf, gen, dtype):
    w = weights.init(gen, (conf.n_in, conf.n_out), conf.n_in, conf.n_out,
                     conf.weight_init, conf.dist, dtype)
    b = torch.full((conf.n_out,), float(conf.bias_init or 0.0), dtype=dtype)
    return {"W": w, "b": b}


@register_layer("dense")
@dataclass
class DenseLayer(LayerConf):
    n_in: int = None
    n_out: int = None

    def set_n_in(self, input_type, override=True):
        if self.n_in is None or override:
            self.n_in = _ff_size(input_type)

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        return _dense_params(self, gen, dtype)

    def preout(self, params, x, *, train=False, rng=None):
        x = apply_input_dropout(self, x, train, rng)
        return x @ params["W"] + params["b"]

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        return activations.get(self.activation)(
            self.preout(params, x, train=train, rng=rng))


@register_layer("output")
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head."""
    loss_function: str = "mcxent"

    def compute_score_per_example(self, params, x, labels, *, train=False,
                                  rng=None, mask=None):
        pre = self.preout(params, x, train=train, rng=rng)
        return losses.get(self.loss_function)(labels, pre, self.activation, mask)


@register_layer("loss")
@dataclass
class LossLayer(LayerConf):
    """Parameterless loss head (activation + loss only)."""
    loss_function: str = "mcxent"

    def set_n_in(self, input_type, override=True):
        return

    def get_output_type(self, input_type):
        return input_type

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        return activations.get(self.activation)(x)

    def preout(self, params, x, *, train=False, rng=None):
        return x

    def compute_score_per_example(self, params, x, labels, *, train=False,
                                  rng=None, mask=None):
        return losses.get(self.loss_function)(labels, x, self.activation, mask)


@register_layer("activation")
@dataclass
class ActivationLayer(LayerConf):

    def get_output_type(self, input_type):
        return input_type

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        return activations.get(self.activation)(x)


@register_layer("dropoutlayer")
@dataclass
class DropoutLayer(LayerConf):
    """Standalone dropout layer."""

    def get_output_type(self, input_type):
        return input_type

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        return apply_input_dropout(self, x, train, rng)


@register_layer("embedding")
@dataclass
class EmbeddingLayer(LayerConf):
    """Integer-index lookup table; input [batch] or [batch, 1] of ids. Adds
    the bias and the activation, as the reference."""
    n_in: int = None   # vocab size
    n_out: int = None

    def set_n_in(self, input_type, override=True):
        if self.n_in is None or override:
            self.n_in = _ff_size(input_type)

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        return _dense_params(self, gen, dtype)

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        idx = x
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        emb = params["W"][idx.long()] + params["b"]
        return activations.get(self.activation)(emb)


def _ff_size(input_type):
    if isinstance(input_type, (FeedForwardInputType, RecurrentInputType)):
        return input_type.size
    if isinstance(input_type, ConvolutionalFlatInputType):
        return input_type.flattened_size
    if isinstance(input_type, ConvolutionalInputType):
        return input_type.height * input_type.width * input_type.channels
    raise ValueError(f"Cannot infer feed-forward size from {input_type}")
