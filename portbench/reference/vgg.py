"""Plain VGG (Simonyan and Zisserman 2014, arXiv:1409.1556, Table 1),
float32: the reference the benchmark holds the port's VGG cells against.

Blocks of 3x3 SAME convolutions with a bias and ReLU, each block closed by
a 2x2/2 max pool; the last pool's output flattened in (height, width,
channel) order, as DL4J flattens NHWC images; dense layers with ReLU, each
taking inverted dropout on its input in training (the configured value is
the probability of keeping an activation, as DL4J's); a dense softmax
head. Parameters are keyed (layer index, name) in DL4J's layer order
(pools count as layers), kernels HWIO, dense W [in, out].

Dropout's keep masks: `keep_masks(gen)` draws them as the measured program
draws its own, from a generator on the device seeded from the run's seed,
`rand(shape) < keep` for each dense layer's input, in forward order, one
draw per layer per step. The reference does not read the program's masks;
it draws the same ones again from the same seed.

Imports nothing of the measured program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as C


def _layers(config):
    """("conv", c_in, c_out, in height, in width) | ("pool",) | ("dense",
    n_in, n_out, dropout) | ("output", n_in, n_out) in layer order."""
    out = []
    c = config["channels"]
    h, w = config["height"], config["width"]
    for width, convs in config["plan"]:
        for _ in range(convs):
            out.append(("conv", c, width, h, w))
            c = width
        out.append(("pool",))
        h, w = h // 2, w // 2
    n = h * w * c
    for d in config["dense"]:
        out.append(("dense", n, d, config["dropout_keep"]))
        n = d
    out.append(("output", n, config["num_classes"]))
    return out


def leaves(config):
    """(layer index, name, shape, init, std) of every parameter:
    torchvision's recipe for VGG from scratch, He's normal over the
    fan-out (std sqrt(2 / (9 c_out))) for the convolutions, a normal of
    std 0.01 for the dense layers, biases 0."""
    out = []
    for i, spec in enumerate(_layers(config)):
        if spec[0] == "conv":
            _, c_in, c_out, _, _ = spec
            out.append((i, "W", (3, 3, c_in, c_out), "normal",
                        (2.0 / (9 * c_out)) ** 0.5))
            out.append((i, "b", (c_out,), "zeros", None))
        elif spec[0] in ("dense", "output"):
            n_in, n_out = spec[1], spec[2]
            out.append((i, "W", (n_in, n_out), "normal",
                        config["dense_init_std"]))
            out.append((i, "b", (n_out,), "zeros", None))
    return out


def n_layers(config):
    return len(_layers(config))


def batch_norms(config):
    return []


def products(config, batch):
    """("conv", batch, out height, out width, out channels, in channels,
    kernel) and ("dense", batch, in, out) of a forward, in order."""
    out = []
    for spec in _layers(config):
        if spec[0] == "conv":
            _, c_in, c_out, h, w = spec
            out.append(("conv", batch, h, w, c_out, c_in, 3))
        elif spec[0] in ("dense", "output"):
            out.append(("dense", batch, spec[1], spec[2]))
    return out


def keep_masks(config, batch, gen, device):
    """One step's dropout keep masks, one per dense layer, in forward
    order."""
    masks = []
    for spec in _layers(config):
        if spec[0] == "dense" and 0.0 < spec[3] < 1.0:
            masks.append(torch.rand((batch, spec[1]), generator=gen,
                                    device=device) < spec[3])
    return masks


class Model:
    """The forward of one configuration over parameters {(index, name):
    tensor}."""

    def __init__(self, config, num=C.F32):
        self.config = config
        self.num = num

    def step_inputs(self, batch, gen, device):
        """What a training step draws: its keep masks."""
        return {"masks": keep_masks(self.config, batch, gen, device)}

    def logits(self, p, x, *, train, masks=None, stats=None, running=None,
               recompute=False):
        """The head's pre-softmax output for NCHW float32 `x`; in training
        `masks` are the step's keep masks (`keep_masks`). VGG has no
        BatchNorm (`stats`, `running`) and nothing to recompute."""
        masks = list(masks or [])
        x = self.num.hold(x)
        for i, spec in enumerate(_layers(self.config)):
            kind = spec[0]
            if kind == "conv":
                x = torch.relu(C.conv2d(x, p[(i, "W")], 1, self.num,
                                        bias=p[(i, "b")]))
            elif kind == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                if x.ndim == 4:
                    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
                keep = spec[3] if kind == "dense" else 0.0
                if train and 0.0 < keep < 1.0:
                    x = torch.where(masks.pop(0), x / keep,
                                    torch.zeros((), device=x.device))
                x = C.dense(x, p[(i, "W")], p[(i, "b")], self.num)
                if kind == "dense":
                    x = torch.relu(x)
        return x
