"""Loss functions: port of deeplearning4j_tpu/nn/losses.py.

Each loss is a plain function ``loss(labels, preout, activation_fn, mask)
-> per_example`` on tensors, returning one value per example; the
containers take the mean over examples and add the L1/L2 terms. Autograd
gives the gradients.

The feature axis is `activations.feature_dim` (dim 1 of the port's NCHW
images, else the last), where the reference reads the last axis of NHWC.
"""
from __future__ import annotations

import torch

from . import activations
from .activations import feature_dim

_EPS = 1e-7


def _apply_activation(preout, activation_fn):
    return activations.get(activation_fn)(preout)


def _reduce_per_example(per_elem, mask):
    """Sum per-element loss over feature axes -> per-example vector. Apply mask first."""
    if mask is not None:
        per_elem = per_elem * mask
    dims = tuple(range(1, per_elem.ndim))
    return per_elem.sum(dim=dims) if dims else per_elem


def _n_out(labels):
    return labels.shape[feature_dim(labels)]


def mcxent(labels, preout, activation_fn="softmax", mask=None):
    """Multi-class cross entropy / negative log likelihood; with softmax,
    the log_softmax form (as the reference's LossMCXENT)."""
    act = str(activation_fn).lower() if not callable(activation_fn) else ""
    if act == "softmax":
        logp = torch.log_softmax(preout, dim=feature_dim(preout))
        per_elem = -labels * logp
    else:
        out = _apply_activation(preout, activation_fn)
        per_elem = -labels * torch.log(torch.clamp(out, _EPS, 1.0 - _EPS))
    return _reduce_per_example(per_elem, mask)


negativeloglikelihood = mcxent


def xent(labels, preout, activation_fn="sigmoid", mask=None):
    """Binary cross entropy (elementwise)."""
    act = str(activation_fn).lower() if not callable(activation_fn) else ""
    if act == "sigmoid":
        # stable: max(z,0) - z*y + log(1+exp(-|z|))
        z = preout
        per_elem = (torch.clamp(z, min=0) - z * labels
                    + torch.log1p(torch.exp(-torch.abs(z))))
    else:
        out = torch.clamp(_apply_activation(preout, activation_fn), _EPS,
                          1.0 - _EPS)
        per_elem = -(labels * torch.log(out)
                     + (1.0 - labels) * torch.log(1.0 - out))
    return _reduce_per_example(per_elem, mask)


def mse(labels, preout, activation_fn="identity", mask=None):
    out = _apply_activation(preout, activation_fn)
    d = out - labels
    # the reference's LossMSE divides by nOut
    return _reduce_per_example(d * d, mask) / _n_out(labels)


def l2(labels, preout, activation_fn="identity", mask=None):
    out = _apply_activation(preout, activation_fn)
    d = out - labels
    return _reduce_per_example(d * d, mask)


def mae(labels, preout, activation_fn="identity", mask=None):
    out = _apply_activation(preout, activation_fn)
    return _reduce_per_example(torch.abs(out - labels), mask) / _n_out(labels)


def l1(labels, preout, activation_fn="identity", mask=None):
    out = _apply_activation(preout, activation_fn)
    return _reduce_per_example(torch.abs(out - labels), mask)


def hinge(labels, preout, activation_fn="identity", mask=None):
    """Hinge loss; labels in {-1, +1}."""
    out = _apply_activation(preout, activation_fn)
    return _reduce_per_example(torch.clamp(1.0 - labels * out, min=0.0), mask)


def squared_hinge(labels, preout, activation_fn="identity", mask=None):
    out = _apply_activation(preout, activation_fn)
    per_elem = torch.clamp(1.0 - labels * out, min=0.0) ** 2
    return _reduce_per_example(per_elem, mask)


def kl_divergence(labels, preout, activation_fn="softmax", mask=None):
    out = torch.clamp(_apply_activation(preout, activation_fn), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    per_elem = labels * (torch.log(lab) - torch.log(out))
    return _reduce_per_example(per_elem, mask)


def poisson(labels, preout, activation_fn="identity", mask=None):
    out = _apply_activation(preout, activation_fn)
    per_elem = out - labels * torch.log(torch.clamp(out, min=_EPS))
    return _reduce_per_example(per_elem, mask)


def mape(labels, preout, activation_fn="identity", mask=None):
    """100 * |y - yhat| / max(|y|, eps), mean over the output features."""
    out = _apply_activation(preout, activation_fn)
    per_elem = 100.0 * torch.abs(out - labels) / torch.clamp(
        torch.abs(labels), min=_EPS)
    return _reduce_per_example(per_elem, mask) / _n_out(labels)


def msle(labels, preout, activation_fn="identity", mask=None):
    """(log((y+1)/(yhat+1)))², mean over the output features; inputs
    clamped at -1+eps so the log stays finite."""
    out = _apply_activation(preout, activation_fn)
    d = (torch.log1p(torch.clamp(out, min=_EPS - 1.0))
         - torch.log1p(torch.clamp(labels, min=_EPS - 1.0)))
    return _reduce_per_example(d * d, mask) / _n_out(labels)


def cosine_proximity(labels, preout, activation_fn="identity", mask=None):
    out = _apply_activation(preout, activation_fn)
    if mask is not None:
        out = out * mask
        labels = labels * mask
    dim = feature_dim(out)
    num = torch.sum(labels * out, dim=dim)
    den = (torch.linalg.vector_norm(labels, dim=dim)
           * torch.linalg.vector_norm(out, dim=dim) + _EPS)
    r = -(num / den)
    dims = tuple(range(1, r.ndim))
    return r.sum(dim=dims) if dims else r


LOSSES = {
    "mcxent": mcxent,
    "negativeloglikelihood": mcxent,
    "xent": xent,
    "mse": mse,
    "l2": l2,
    "mae": mae,
    "l1": l1,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "squaredhinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "kld": kl_divergence,
    "mape": mape,
    "msle": msle,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "cosineproximity": cosine_proximity,
}


def get(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(LOSSES)}")
    return LOSSES[key]
