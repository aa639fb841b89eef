"""Normalization layers: port of
deeplearning4j_tpu/nn/conf/layers/normalization.py (BatchNormalization,
LocalResponseNormalization).

BatchNorm's running mean and var are state the containers hold as module
buffers; training normalises with the batch statistics and returns the
EMA update with `decay`, inference uses the running statistics, cast to
the compute type first. The statistics reduce every axis but the channel:
(0, 2, 3) of the port's NCHW images, all but the last otherwise.

Training with `fused_backward=True` (the default) goes through `_BNTrain`,
the port of the reference's `_bn_train_fused` custom VJP: one-pass E[x]
and E[x²] statistics accumulated in f32 (or the two-pass variance with
`use_fast_variance=False`), and the closed-form backward with its two
reductions. `F.batch_norm` is not used: its two-pass variance is another
function than the default one-pass one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..input_type import (ConvolutionalInputType, FeedForwardInputType,
                          InputType, RecurrentInputType)
from .base import LayerConf, register_layer


def _stat_dims(x):
    return (0, 2, 3) if x.ndim == 4 else tuple(range(x.ndim - 1))


def _channel_shape(x):
    """Shape that broadcasts a per-channel vector against `x`."""
    return (1, -1, 1, 1) if x.ndim == 4 else (-1,)


def _acc_type(dtype):
    return torch.promote_types(dtype, torch.float32)


def _batch_stats(xf, dims, fast_var):
    mean = xf.mean(dim=dims)
    if fast_var:
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
    else:
        var = xf.var(dim=dims, unbiased=False)
    return mean, var


class _BNTrain(torch.autograd.Function):
    """Batch norm in training: y = (x - mean)·rstd·gamma + beta over the
    batch statistics, computed in f32 (at least) and rounded once to x's
    type. Returns (y, mean, var); mean and var feed the EMA and carry no
    gradient.

    Backward, the closed form of the reference's `_bn_train_fused`:
        dx = gamma·rstd·(dy - s1/n - (x - mean)·rstd²·s2/n),
        dgamma = s2·rstd, dbeta = s1,
    with s1 = Σ dy and s2 = Σ dy·(x - mean), both in f32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, fast_var):
        dims, shape = _stat_dims(x), _channel_shape(x)
        acc = _acc_type(x.dtype)
        xf = x.to(acc)
        mean, var = _batch_stats(xf, dims, fast_var)
        rstd = torch.rsqrt(var + eps)
        y = ((xf - mean.view(shape)) * (rstd * gamma.to(acc)).view(shape)
             + beta.to(acc).view(shape)).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, rstd = ctx.saved_tensors
        dims, shape = _stat_dims(x), _channel_shape(x)
        acc = _acc_type(x.dtype)
        n = x.numel() // x.shape[1 if x.ndim == 4 else -1]
        dyf = dy.to(acc)
        xc = x.to(acc) - mean.view(shape)
        s1 = dyf.sum(dim=dims)
        s2 = (dyf * xc).sum(dim=dims)
        g = gamma.to(acc)
        dx = (g * rstd).view(shape) * (
            dyf - (s1 / n).view(shape)
            - xc * (rstd * rstd * (s2 / n)).view(shape))
        return (dx.to(x.dtype), (s2 * rstd).to(gamma.dtype),
                s1.to(gamma.dtype), None, None)


@register_layer("batchnorm")
@dataclass
class BatchNormalization(LayerConf):
    decay: float = 0.9
    eps: float = 1e-5
    is_mini_batch: bool = True
    lock_gamma_beta: bool = False
    gamma_init: float = 1.0
    beta_init: float = 0.0
    n_out: int = None  # feature count, inferred
    # one-pass E[x^2]-E[x]^2 statistics; False for the two-pass variance
    # when |mean| can be orders of magnitude above the spread (the
    # one-pass form then cancels to 0 and normalises by rsqrt(eps))
    use_fast_variance: bool = True
    # the closed-form backward (_BNTrain); False: autograd through the
    # statistics
    fused_backward: bool = True

    def set_n_in(self, input_type, override=True):
        if self.n_out is None or override:
            if isinstance(input_type, ConvolutionalInputType):
                self.n_out = input_type.channels
            elif isinstance(input_type, (FeedForwardInputType,
                                         RecurrentInputType)):
                self.n_out = input_type.size

    def get_output_type(self, input_type):
        return input_type

    def init_params(self, gen, dtype=torch.float32):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((self.n_out,), float(self.gamma_init),
                                    dtype=dtype),
                "beta": torch.full((self.n_out,), float(self.beta_init),
                                   dtype=dtype)}

    def has_state(self):
        return True

    def init_state(self):
        return {"mean": torch.zeros((self.n_out,), dtype=torch.float32),
                "var": torch.ones((self.n_out,), dtype=torch.float32)}

    def _ema(self, state, mean, var):
        d = self.decay
        return {"mean": d * state["mean"] + (1 - d) * mean.detach(),
                "var": d * state["var"] + (1 - d) * var.detach()}

    def forward_with_state(self, params, x, state, *, train=False, rng=None,
                           mask=None):
        """(y, new_state); new_state is `state` itself at inference."""
        shape = _channel_shape(x)
        if train and self.fused_backward and params \
                and not self.lock_gamma_beta:
            y, mean, var = _BNTrain.apply(x, params["gamma"], params["beta"],
                                          self.eps, self.use_fast_variance)
            return y, self._ema(state, mean, var)
        if train:
            mean, var = _batch_stats(x.to(_acc_type(x.dtype)), _stat_dims(x),
                                     self.use_fast_variance)
            new_state = self._ema(state, mean, var)
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        mean = mean.to(x.dtype).view(shape)
        var = var.to(x.dtype).view(shape)
        xn = (x - mean) / torch.sqrt(var + self.eps)
        if not self.lock_gamma_beta and params:
            xn = xn * params["gamma"].view(shape) + params["beta"].view(shape)
        # no activation, as the reference's BatchNormalization.activate
        return xn, new_state

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        out, _ = self.forward_with_state(params, x, state or self.init_state(),
                                         train=train, rng=rng, mask=mask)
        return out


@register_layer("lrn")
@dataclass
class LocalResponseNormalization(LayerConf):
    """Across-channel LRN: out = x / (k + alpha·Σ_{j in window} x_j²)^beta
    over the channel axis (dim 1 of the port's NCHW images)."""
    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75

    def get_output_type(self, input_type):
        return input_type

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        half = int(self.n) // 2
        dim = 1 if x.ndim == 4 else x.ndim - 1
        c = x.shape[dim]
        sq = (x * x).movedim(dim, -1)
        padded = torch.nn.functional.pad(sq, (half, half))
        acc = sum(padded[..., i:i + c] for i in range(int(self.n)))
        denom = (self.k + self.alpha * acc.movedim(-1, dim)) ** self.beta
        return x / denom
