"""Weight initialization: port of deeplearning4j_tpu/nn/weights.py.

The same schemes and formulas (the reference's WeightInitUtil), drawn from
a `torch.Generator` that the container seeds from the configuration's
`seed`. The JAX package draws from its own PRNG, so the two packages give
other numbers from one seed: the parity tests carry the reference's
weights across instead (`from_jax_params`), and this module is held to
shapes and variances.

Draws are made on the CPU in float32 and then moved, so the card and the
CPU get the same weights from the same seed.
"""
from __future__ import annotations

import math

import torch

VALID = (
    "zero", "ones", "uniform", "xavier", "xavier_uniform", "xavier_fan_in",
    "xavier_legacy", "relu", "relu_uniform", "sigmoid_uniform", "lecun_normal",
    "lecun_uniform", "normal", "distribution", "var_scaling_normal_fan_in",
    "identity",
)


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       dtype=torch.float32)


def init(gen, shape, fan_in, fan_out, scheme="xavier", distribution=None,
         dtype=torch.float32):
    """A CPU weight tensor of `shape` per the named scheme (the reference's
    WeightInitUtil.initWeights formulas)."""
    scheme = str(scheme).lower()
    shape = tuple(int(s) for s in shape)
    fan_in = max(float(fan_in), 1.0)
    fan_out = max(float(fan_out), 1.0)

    if scheme == "zero":
        w = torch.zeros(shape)
    elif scheme == "ones":
        w = torch.ones(shape)
    elif scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("identity init requires square 2-D shape")
        w = torch.eye(shape[0])
    elif scheme == "uniform":
        a = 1.0 / math.sqrt(fan_in)
        w = _uniform(gen, shape, -a, a)
    elif scheme == "xavier":
        w = math.sqrt(2.0 / (fan_in + fan_out)) * _normal(gen, shape)
    elif scheme == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        w = _uniform(gen, shape, -a, a)
    elif scheme in ("xavier_fan_in", "lecun_normal",
                    "var_scaling_normal_fan_in"):
        w = math.sqrt(1.0 / fan_in) * _normal(gen, shape)
    elif scheme == "xavier_legacy":
        w = math.sqrt(1.0 / (fan_in + fan_out)) * _normal(gen, shape)
    elif scheme in ("relu", "he_normal"):
        w = math.sqrt(2.0 / fan_in) * _normal(gen, shape)
    elif scheme in ("relu_uniform", "he_uniform"):
        a = math.sqrt(6.0 / fan_in)
        w = _uniform(gen, shape, -a, a)
    elif scheme == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        w = _uniform(gen, shape, -a, a)
    elif scheme == "lecun_uniform":
        a = math.sqrt(3.0 / fan_in)
        w = _uniform(gen, shape, -a, a)
    elif scheme == "normal":
        w = _normal(gen, shape) / math.sqrt(fan_in)
    elif scheme == "distribution":
        if distribution is None:
            raise ValueError("WeightInit 'distribution' requires a distribution spec")
        w = _from_distribution(gen, shape, distribution)
    else:
        raise ValueError(f"Unknown weight init '{scheme}'. Known: {VALID}")
    return w.to(dtype)


def _from_distribution(gen, shape, dist):
    """dist: {"type": "normal", "mean": 0, "std": 0.01},
    {"type": "uniform", "lower": -a, "upper": a} or
    {"type": "binomial", "n": n, "p": p}."""
    kind = str(dist.get("type", "normal")).lower()
    if kind in ("normal", "gaussian"):
        mean = float(dist.get("mean", 0.0))
        std = float(dist.get("std", 1.0))
        return mean + std * _normal(gen, shape)
    if kind == "uniform":
        return _uniform(gen, shape, float(dist.get("lower", -1.0)),
                        float(dist.get("upper", 1.0)))
    if kind == "binomial":
        n = int(dist.get("n", 1))
        p = float(dist.get("p", 0.5))
        probs = torch.full((n,) + shape, p)
        return torch.bernoulli(probs, generator=gen).sum(dim=0)
    raise ValueError(f"Unknown distribution type '{kind}'")
