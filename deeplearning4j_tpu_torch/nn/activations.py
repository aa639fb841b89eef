"""Activation functions: port of deeplearning4j_tpu/nn/activations.py.

Plain functions on tensors; autograd gives the backward passes. The port
keeps image activations as NCHW tensors, so softmax (the one activation
that reads an axis) normalises over the feature axis: dim 1 of a 4-D
tensor, the last axis otherwise (the reference's last axis of NHWC).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def feature_dim(x):
    """The feature (channel) axis: 1 for the port's NCHW images, else -1."""
    return 1 if x.ndim == 4 else -1


def identity(x):
    return x


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def relu(x):
    return torch.relu(x)


def leakyrelu(x, alpha: float = 0.01):
    return F.leaky_relu(x, alpha)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


def selu(x):
    return F.selu(x)


def gelu(x):
    # jax.nn.gelu's default is the tanh form
    return F.gelu(x, approximate="tanh")


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softsign(x):
    return F.softsign(x)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def cube(x):
    return x ** 3


def rationaltanh(x):
    # Reference ND4J ActivationRationalTanh: 1.7159 * tanh_approx(2x/3)
    a = 0.6666667 * x
    tanh_approx = torch.sign(a) * (
        1.0 - 1.0 / (1.0 + torch.abs(a) + a ** 2 + 1.41645 * a ** 4))
    return 1.7159 * tanh_approx


def rectifiedtanh(x):
    return torch.relu(torch.tanh(x))


def softmax(x):
    return torch.softmax(x, dim=feature_dim(x))


def swish(x):
    return F.silu(x)


def mish(x):
    return x * torch.tanh(softplus(x))


def threshold_relu(x, theta: float = 1.0):
    return torch.where(x > theta, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


ACTIVATIONS = {
    "identity": identity,
    "linear": identity,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "relu": relu,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "softplus": softplus,
    "softsign": softsign,
    "hardtanh": hardtanh,
    "hardsigmoid": hardsigmoid,
    "relu6": relu6,
    "cube": cube,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "swish": swish,
    "mish": mish,
}


def get(name):
    """Resolve an activation by name (case-insensitive) or pass through a callable."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
