"""Feed-forward layer configs: port of
deeplearning4j_tpu/nn/conf/layers/feedforward.py (Dense, Output, RnnOutput,
Loss, Activation, Dropout, Embedding, AutoEncoder).

Forward math as the reference: preOutput = x @ W + b with W [n_in, n_out],
the activation on top; cuBLAS runs the product.
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
        return self.score_of_preout(
            self.preout(params, x, train=train, rng=rng), labels, mask)

    def score_of_preout(self, pre, labels, mask=None):
        """The per-example loss of the pre-activation `pre`."""
        return losses.get(self.loss_function)(labels, pre, self.activation, mask)


@register_layer("rnnoutput")
@dataclass
class RnnOutputLayer(OutputLayer):
    """Output layer over [batch, time, size] sequences: the dense head
    broadcasts over the time axis, and the loss sums each example's time
    steps and features. A 2-D [batch, time] label mask applies per step."""

    def set_n_in(self, input_type, override=True):
        if isinstance(input_type, RecurrentInputType):
            if self.n_in is None or override:
                self.n_in = input_type.size
        else:
            super().set_n_in(input_type, override)

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out)

    def score_of_preout(self, pre, labels, mask=None):
        if mask is not None and mask.ndim == 2:
            mask = mask[:, :, None]
        return super().score_of_preout(pre, labels, mask)


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

    def preout(self, params, x, *, train=False, rng=None):
        idx = x
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        return params["W"][idx.long()] + params["b"]

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        return activations.get(self.activation)(self.preout(params, x))


@register_layer("autoencoder")
@dataclass
class AutoEncoder(LayerConf):
    """Denoising autoencoder, a pretrain layer: encode with W, b; decode
    with Wᵀ, vb; `forward` is `encode`. Its corruption keeps each input
    where a uniform draw is below 1 - corruption_level (as
    jax.random.bernoulli); the draws come from `pretrain_draws` on a
    torch.Generator, or are handed in as `draws`."""
    n_in: int = None
    n_out: int = None
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss_function: str = "mse"

    def set_n_in(self, input_type, override=True):
        if self.n_in is None or override:
            self.n_in = _ff_size(input_type)

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        w = weights.init(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         self.weight_init, self.dist, dtype)
        return {"W": w, "b": torch.zeros(self.n_out, dtype=dtype),
                "vb": torch.zeros(self.n_in, dtype=dtype)}

    def preout(self, params, x, *, train=False, rng=None):
        return x @ params["W"] + params["b"]

    def encode(self, params, x):
        return activations.get(self.activation)(self.preout(params, x))

    def decode(self, params, h):
        return activations.get(self.activation)(
            h @ params["W"].T + params["vb"])

    def forward(self, params, x, *, train=False, rng=None, mask=None,
                state=None):
        return self.encode(params, x)

    def pretrain_draws(self, x, gen):
        """The corruption's uniforms for the batch `x`, from the
        torch.Generator `gen`; None when there is no corruption (no
        generator, or corruption_level 0), as the reference corrupts only
        when given a key."""
        if gen is None or not self.corruption_level > 0:
            return None
        return torch.rand(x.shape, generator=gen, dtype=x.dtype,
                          device=x.device)

    def pretrain_loss(self, params, x, *, rng=None, draws=None):
        """The reconstruction loss of the corrupted input, the mean over
        examples. `draws`: the corruption's uniforms (drawn from `rng`
        when None)."""
        if draws is None:
            draws = self.pretrain_draws(x, rng)
        xc = x if draws is None else x * (draws < 1.0 - self.corruption_level)
        recon = self.decode(params, self.encode(params, xc))
        return losses.get(self.loss_function)(x, recon, "identity",
                                              None).mean()


def _ff_size(input_type):
    if isinstance(input_type, (FeedForwardInputType, RecurrentInputType)):
        return input_type.size
    if isinstance(input_type, ConvolutionalFlatInputType):
        return input_type.flattened_size
    if isinstance(input_type, ConvolutionalInputType):
        return input_type.height * input_type.width * input_type.channels
    raise ValueError(f"Cannot infer feed-forward size from {input_type}")
