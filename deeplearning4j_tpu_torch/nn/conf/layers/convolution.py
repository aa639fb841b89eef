"""Convolutional layer configs: port of
deeplearning4j_tpu/nn/conf/layers/convolution.py (Convolution,
Subsampling, ZeroPadding, GlobalPooling).

Images run as NCHW tensors in the channels_last memory format, the layout
cuDNN's tensor-core convolutions take in bf16; kernels are OIHW
(channels_last too), where the reference holds HWIO (`to_reference`).
cuDNN runs the convolutions and the pooling, as XLA does for the
reference: the port writes no kernel for them.

Padding. `convolution_mode="truncate"` pads `padding` on both sides;
"same" is XLA's SAME: out = ceil(in / stride), and the total padding
max((out - 1)·stride + k - in, 0) splits with the extra cell after (the
ResNet stem's 7×7/2 conv on 224 pads (2, 3), its 3×3/2 max pool on 112
pads (0, 1)). torch's own `padding="same"` refuses stride 2, so the port
pads explicitly. Max pooling pads with −inf; SAME average pooling divides
by the count of real cells in each window.

Max-pool backward: `pool_backprop="select_scatter"` (the default) is
torch's own max-pool backward, which, like XLA's select-and-scatter,
sends each window's gradient to one maximum. "argmax_gather" is the
reference's hand-derived VJP (`_maxpool_gather`): every tied maximum of a
window receives the window's whole gradient.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ... import activations, weights
from ..input_type import ConvolutionalInputType, InputType, RecurrentInputType
from .base import LayerConf, apply_input_dropout, register_layer


def _pair(v):
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _conv_out_size(size, k, s, p, mode):
    if mode == "same":
        return -(-size // s)  # ceil
    return (size + 2 * p - k) // s + 1


def same_pads(size, k, s):
    """XLA's SAME padding of one spatial axis: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(x, kernel, stride, padding, mode):
    """((top, bottom), (left, right)) for an NCHW `x`."""
    if str(mode).lower() == "same":
        return (same_pads(x.shape[2], kernel[0], stride[0]),
                same_pads(x.shape[3], kernel[1], stride[1]))
    ph, pw = padding
    return (ph, ph), (pw, pw)


def _pad(x, pads, value=0.0):
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return F.pad(x, (l, r, t, b), value=value)


class _MaxPoolGather(torch.autograd.Function):
    """Max pooling whose backward gathers from max-position equality
    (reference `_maxpool_gather`): dx[i] = Σ over windows w containing i of
    dy[w]·[x[i] == y[w]]. Away from ties this is torch's max-pool
    backward; within a window every tied maximum receives dy[w]."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pads):
        y = F.max_pool2d(_pad(x, pads, float("-inf")), kernel, stride)
        ctx.save_for_backward(x, y)
        ctx.meta = (kernel, stride, pads)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        (kh, kw), (sh, sw), pads = ctx.meta
        (top, _), (left, _) = pads
        xp = _pad(x, pads, float("-inf"))
        oh, ow = y.shape[2], y.shape[3]
        acc = torch.zeros(xp.shape, dtype=dy.dtype, device=dy.device)
        zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
        # window (a, b) reads padded cell (a·sh + u, b·sw + v): one strided
        # add of an output-sized term per offset in the window
        for u in range(kh):
            for v in range(kw):
                cells = (slice(None), slice(None),
                         slice(u, u + oh * sh, sh), slice(v, v + ow * sw, sw))
                acc[cells] += torch.where(xp[cells] == y, dy, zero)
        h, w = x.shape[2], x.shape[3]
        return acc[:, :, top:top + h, left:left + w], None, None, None


def maxpool_gather(x, kernel, stride, pads):
    return _MaxPoolGather.apply(x, kernel, stride, pads)


def _sum_pool(x, kernel, stride, pads):
    return F.avg_pool2d(_pad(x, pads), kernel, stride, divisor_override=1)


@register_layer("convolution")
@dataclass
class ConvolutionLayer(LayerConf):
    """2-D convolution. The port holds the kernel OIHW ([outC, inC, kh,
    kw]); the reference and its zips hold HWIO ([kh, kw, inC, outC])."""
    n_in: int = None          # input channels
    n_out: int = None         # output channels
    kernel_size: tuple = (5, 5)
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)
    convolution_mode: str = "truncate"   # 'truncate' | 'same'
    cudnn_algo_mode: str = None          # accepted for config compat; ignored
    # has_bias=False drops the per-channel bias (a conv feeding BatchNorm,
    # whose beta subsumes it)
    has_bias: bool = True

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def set_n_in(self, input_type, override=True):
        if isinstance(input_type, ConvolutionalInputType):
            if self.n_in is None or override:
                self.n_in = input_type.channels

    def get_output_type(self, input_type):
        if not isinstance(input_type, ConvolutionalInputType):
            raise ValueError(f"ConvolutionLayer needs CNN input, got {input_type}")
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        mode = str(self.convolution_mode).lower()
        oh = _conv_out_size(input_type.height, kh, sh, ph, mode)
        ow = _conv_out_size(input_type.width, kw, sw, pw, mode)
        return InputType.convolutional(oh, ow, self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        kh, kw = self.kernel_size
        w = weights.init(gen, (self.n_out, self.n_in, kh, kw),
                         self.n_in * kh * kw, self.n_out * kh * kw,
                         self.weight_init, self.dist, dtype)
        w = w.contiguous(memory_format=torch.channels_last)
        if not self.has_bias:
            return {"W": w}
        b = torch.full((self.n_out,), float(self.bias_init or 0.0),
                       dtype=dtype)
        return {"W": w, "b": b}

    def to_reference(self, key, t):
        return t.permute(2, 3, 1, 0) if key == "W" else t      # OIHW -> HWIO

    def from_reference(self, key, t):
        if key != "W":
            return t
        return t.permute(3, 2, 0, 1).contiguous(                 # HWIO -> OIHW
            memory_format=torch.channels_last)

    def preout(self, params, x, *, train=False, rng=None):
        x = apply_input_dropout(self, x, train, rng)
        (t, b), (l, r) = pads = _pads(x, self.kernel_size, self.stride,
                                      self.padding, self.convolution_mode)
        if t != b or l != r:
            x, pads = _pad(x, pads), ((0, 0), (0, 0))
        return F.conv2d(x, params["W"], params.get("b"), self.stride,
                        (pads[0][0], pads[1][0]))

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        return activations.get(self.activation)(
            self.preout(params, x, train=train, rng=rng))


@register_layer("subsampling")
@dataclass
class SubsamplingLayer(LayerConf):
    """Pooling: MAX / AVG / SUM / PNORM."""
    pooling_type: str = "max"
    kernel_size: tuple = (2, 2)
    stride: tuple = (2, 2)
    padding: tuple = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2
    # max-pool backward: 'select_scatter' (torch's max-pool backward) or
    # 'argmax_gather' (_MaxPoolGather); see the module docstring
    pool_backprop: str = "select_scatter"

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def get_output_type(self, input_type):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        mode = str(self.convolution_mode).lower()
        oh = _conv_out_size(input_type.height, kh, sh, ph, mode)
        ow = _conv_out_size(input_type.width, kw, sw, pw, mode)
        return InputType.convolutional(oh, ow, input_type.channels)

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        k, s = self.kernel_size, self.stride
        pads = _pads(x, k, s, self.padding, self.convolution_mode)
        pt = str(self.pooling_type).lower()
        if pt == "max":
            if self.pool_backprop == "argmax_gather":
                return maxpool_gather(x, k, s, pads)
            return F.max_pool2d(_pad(x, pads, float("-inf")), k, s)
        if pt in ("avg", "average", "mean"):
            total = _sum_pool(x, k, s, pads)
            if str(self.convolution_mode).lower() == "same":
                ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                  device=x.device)
                return total / _sum_pool(ones, k, s, pads)
            return total / (k[0] * k[1])
        if pt == "sum":
            return _sum_pool(x, k, s, pads)
        if pt == "pnorm":
            p = float(self.pnorm)
            return _sum_pool(x.abs() ** p, k, s, pads) ** (1.0 / p)
        raise ValueError(f"Unknown pooling type {self.pooling_type}")


@register_layer("zeropadding")
@dataclass
class ZeroPaddingLayer(LayerConf):
    """Explicit zero padding of H and W."""
    pad: tuple = (1, 1)

    def __post_init__(self):
        self.pad = _pair(self.pad)

    def get_output_type(self, input_type):
        ph, pw = self.pad
        return InputType.convolutional(input_type.height + 2 * ph,
                                       input_type.width + 2 * pw,
                                       input_type.channels)

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        ph, pw = self.pad
        return F.pad(x, (pw, pw, ph, ph))


@register_layer("globalpooling")
@dataclass
class GlobalPoolingLayer(LayerConf):
    """Global pooling over the spatial axes ([B,C,H,W] -> [B,C]) or time
    ([B,T,F] -> [B,F], with the time mask)."""
    pooling_type: str = "avg"

    def get_output_type(self, input_type):
        if isinstance(input_type, ConvolutionalInputType):
            return InputType.feed_forward(input_type.channels)
        if isinstance(input_type, RecurrentInputType):
            return InputType.feed_forward(input_type.size)
        return input_type

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        dims = (2, 3) if x.ndim == 4 else tuple(range(1, x.ndim - 1))
        pt = str(self.pooling_type).lower()
        if pt not in ("max", "avg", "average", "mean", "sum"):
            raise ValueError(f"Unknown pooling type {self.pooling_type}")
        if not dims:
            return x
        seq_mask = mask is not None and x.ndim == 3
        if pt == "max":
            if seq_mask:
                x = x.masked_fill(mask[:, :, None] <= 0, float("-inf"))
            return x.amax(dim=dims)
        if pt == "sum":
            if seq_mask:
                x = x * mask[:, :, None]
            return x.sum(dim=dims)
        if seq_mask:
            m = mask[:, :, None]
            return (x * m).sum(dim=dims) / torch.clamp(m.sum(dim=1), min=1e-9)
        return x.mean(dim=dims)
