"""Plain ResNet v1 (He et al. 2016, arXiv:1512.03385, Table 1), float32:
the reference the benchmark holds the port's ResNet cells against.

The 7x7/2 stem, BatchNorm and ReLU, a 3x3/2 max pool, then bottleneck
stages: 1x1 (carrying the stage's stride, as v1 does) -> 3x3 -> 1x1 x
expansion, each convolution followed by BatchNorm, a projection shortcut
(1x1 with the stride, then BatchNorm) on each stage's first block, the
sum, ReLU; global average pooling and a dense softmax head. Convolutions
have no bias and pad SAME. Parameters are keyed (vertex, name) as the
DL4J graph names its vertices, kernels HWIO, the head's W [in, out].

Imports nothing of the measured program.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import common as C


def blocks(config):
    """(block name, width, stride, projects) of every bottleneck."""
    out = []
    for si, (n_blocks, width) in enumerate(config["stages"]):
        for bi in range(n_blocks):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            out.append((f"s{si + 2}b{bi}", width, stride, bi == 0))
    return out


def _out(hw, stride):
    return (-(-hw[0] // stride), -(-hw[1] // stride))


def _convs(config):
    """(vertex prefix, kernel, in channels, out channels, stride, input
    height and width) of every convolution in forward order, the stem
    first; and the head's width."""
    c, e = config["stem_width"], config["expansion"]
    hw = (config["height"], config["width"])
    out = [("stem", 7, config["channels"], c, 2, hw)]
    hw = _out(_out(hw, 2), 2)           # the stem, then the max pool
    for name, width, stride, project in blocks(config):
        out.append((f"{name}_a", 1, c, width, stride, hw))
        inner = _out(hw, stride)
        out.append((f"{name}_b", 3, width, width, 1, inner))
        out.append((f"{name}_c", 1, width, width * e, 1, inner))
        if project:
            out.append((f"{name}_sc", 1, c, width * e, stride, hw))
        c, hw = width * e, inner
    return out, c


def leaves(config):
    """(vertex, name, shape, init, std) of every parameter: He's normal
    (std sqrt(2 / fan_in)) for the convolutions and the head, BatchNorm's
    gamma 1 and beta 0, the head's bias 0."""
    convs, c = _convs(config)
    out = []
    for prefix, k, c_in, c_out, _, _ in convs:
        out.append((f"{prefix}_conv", "W", (k, k, c_in, c_out), "normal",
                    (2.0 / (k * k * c_in)) ** 0.5))
        out.append((f"{prefix}_bn", "gamma", (c_out,), "ones", None))
        out.append((f"{prefix}_bn", "beta", (c_out,), "zeros", None))
    n = config["num_classes"]
    out.append(("fc", "W", (c, n), "normal", (2.0 / c) ** 0.5))
    out.append(("fc", "b", (n,), "zeros", None))
    return out


def batch_norms(config):
    """The vertex names of every BatchNorm."""
    return [f"{prefix}_bn" for prefix, *_ in _convs(config)[0]]


def products(config, batch):
    """The products of a forward over `batch` images: ("conv", batch, out
    height, out width, out channels, in channels, kernel) for each
    convolution, in forward order, and ("dense", batch, in, out) for the
    head."""
    convs, c = _convs(config)
    out = []
    for _, k, c_in, c_out, stride, hw in convs:
        oh, ow = _out(hw, stride)
        out.append(("conv", batch, oh, ow, c_out, c_in, k))
    out.append(("dense", batch, c, config["num_classes"]))
    return out


class Model:
    """The forward of one configuration over parameters {(vertex, name):
    tensor}. `num` rounds the products' inputs (`common.Numerics`)."""

    def __init__(self, config, num=C.F32):
        self.config = config
        self.num = num
        self.eps = config["batch_norm"]["eps"]

    def _conv_bn(self, p, x, prefix, stride, relu, train, stats, running):
        y = C.conv2d(x, p[(f"{prefix}_conv", "W")], stride, self.num)
        bn = f"{prefix}_bn"
        g, b = p[(bn, "gamma")], p[(bn, "beta")]
        g, b = self.num.hold(g), self.num.hold(b)
        if train:
            y, mean, var = C.batch_norm_train(y, g, b, self.eps)
            stats[bn] = (mean, var)     # a recompute writes the same values
            y = self.num.hold(y)
        else:
            y = C.batch_norm_infer(y, g, b, *running[bn], self.eps,
                                   self.num)
        return torch.relu(y) if relu else y

    def _block(self, p, x, name, stride, project, train, stats, running):
        cb = self._conv_bn
        y = cb(p, x, f"{name}_a", stride, True, train, stats, running)
        y = cb(p, y, f"{name}_b", 1, True, train, stats, running)
        y = cb(p, y, f"{name}_c", 1, False, train, stats, running)
        sc = (cb(p, x, f"{name}_sc", stride, False, train, stats, running)
              if project else x)
        return torch.relu(self.num.hold(y + sc))

    def step_inputs(self, batch, gen, device):
        """What a training step draws: nothing."""
        return {}

    def logits(self, p, x, *, train, stats=None, running=None,
               recompute=False, masks=None):
        """The head's pre-softmax output for NCHW float32 `x`. Training
        takes the batch statistics and writes them, per BatchNorm, into
        `stats`; inference takes `running` {vertex: (mean, var)}.
        `recompute` keeps only each block's input for the backward and
        runs the block again there (for batches whose activations do not
        fit)."""
        stats = {} if stats is None else stats
        x = self.num.hold(x)
        x = self._conv_bn(p, x, "stem", 2, True, train, stats, running)
        x = C.max_pool_same(x, 3, 2)
        for name, _, stride, project in blocks(self.config):
            if recompute:
                x = checkpoint(self._block, p, x, name, stride, project,
                               train, stats, running, use_reentrant=False)
            else:
                x = self._block(p, x, name, stride, project, train, stats,
                                running)
        x = self.num.hold(x.mean(dim=(2, 3)))
        return C.dense(x, p[("fc", "W")], p[("fc", "b")], self.num)
