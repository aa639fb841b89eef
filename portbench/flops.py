"""The operations a step needs, counted from shapes, and the card's peaks.

A product's count is 2 x its multiply-adds. Training needs each
product's forward, its input gradient (dX) and its weight gradient (dW),
each as many operations as the forward, except the first layer's dX: the
images need no gradient. What runs outside the convolutions and products
(BatchNorm, activations, pooling, the update) is not counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense, without sparsity (NVIDIA's data sheet; at the
# full 700 W power limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def macs(product):
    """Multiply-adds of one product's forward: ("conv", batch, out h, out
    w, out c, in c, kernel) or ("dense", batch, in, out)."""
    if product[0] == "conv":
        _, b, oh, ow, co, ci, k = product
        return b * oh * ow * co * ci * k * k
    if product[0] == "dense":
        _, b, n_in, n_out = product
        return b * n_in * n_out
    raise ValueError(f"unknown product {product[0]!r}")


def forward_flops(products):
    return 2 * sum(macs(p) for p in products)


def train_flops(products):
    """Forward, dX (all but the first product's) and dW."""
    total = 0
    for i, p in enumerate(products):
        m = macs(p)
        total += 2 * m * (3 if i else 2)
    return total
