"""Restricted Boltzmann Machine layer: port of
deeplearning4j_tpu/nn/conf/layers/rbm.py.

Binary or gaussian visible and hidden units, CD-k pretraining, propup as
the feed-forward activation. W is [n_in, n_out] as in the reference, `b`
the hidden bias, `vb` the visible bias.

CD statistics are not the gradient of a loss, so the layer supplies
`pretrain_grads` itself (the positive and negative phase statistics of
classic CD) and the pretraining driver applies them through the layer's
updater; no autograd runs. The samples are split from the math: the
draws (uniforms for a binary unit, standard normals for a gaussian one)
come from `pretrain_draws` on a torch.Generator, or are handed in as
`draws`, the 2k + 1 tensors the reference takes from
`fold_in(rng, 0)`, `fold_in(rng, 2s + 1)` and `fold_in(rng, 2s + 2)`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import weights
from ..input_type import InputType
from .base import LayerConf, register_layer
from .feedforward import _ff_size


def _sample(p, draw, unit):
    """A unit's sample given its mean `p` and its draw: p + normal for a
    gaussian unit, uniform < p (as jax.random.bernoulli) for a binary one."""
    if unit == "gaussian":
        return p + draw
    return (draw < p).to(p.dtype)


def _draw(shape, unit, gen, dtype, device):
    if unit == "gaussian":
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


@register_layer("rbm")
@dataclass
class RBM(LayerConf):
    n_in: int = None
    n_out: int = None
    hidden_unit: str = "binary"     # binary | gaussian
    visible_unit: str = "binary"
    k: int = 1                      # CD-k steps

    def set_n_in(self, input_type, override=True):
        if self.n_in is None or override:
            self.n_in = _ff_size(input_type)

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        w = weights.init(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         self.weight_init or "xavier", self.dist, dtype)
        return {"W": w, "b": torch.zeros(self.n_out, dtype=dtype),
                "vb": torch.zeros(self.n_in, dtype=dtype)}

    # ------------------------------------------------------------------
    def _prop_up(self, params, v):
        pre = v @ params["W"] + params["b"]
        return pre if self.hidden_unit == "gaussian" else torch.sigmoid(pre)

    def _prop_down(self, params, h):
        pre = h @ params["W"].T + params["vb"]
        return pre if self.visible_unit == "gaussian" else torch.sigmoid(pre)

    def forward(self, params, x, *, train=False, rng=None, mask=None,
                state=None):
        """propup."""
        return self._prop_up(params, x)

    # ------------------------------------------------------------------
    def pretrain_draws(self, v0, gen):
        """The 2k + 1 draws of one CD-k pass over the batch `v0`, from the
        torch.Generator `gen` (None: a generator seeded 0): the first
        hidden sample's, then each step's visible and hidden samples'."""
        if gen is None:
            gen = torch.Generator(v0.device).manual_seed(0)
        B, dt, dev = v0.shape[0], v0.dtype, v0.device
        draws = [_draw((B, self.n_out), self.hidden_unit, gen, dt, dev)]
        for _ in range(self.k):
            draws.append(_draw((B, self.n_in), self.visible_unit, gen, dt,
                               dev))
            draws.append(_draw((B, self.n_out), self.hidden_unit, gen, dt,
                               dev))
        return draws

    def pretrain_grads(self, params, v0, *, rng=None, draws=None):
        """CD-k statistics to minimise (the negative of the likelihood's
        ascent direction), keyed as the parameters: dW = (vkᵀ·phk −
        v0ᵀ·ph0)/B and the two mean differences. `draws` as
        `pretrain_draws` gives them (drawn from `rng` when None)."""
        if draws is None:
            draws = self.pretrain_draws(v0, rng)
        ph0 = self._prop_up(params, v0)
        h = _sample(ph0, draws[0], self.hidden_unit)
        vk, phk = v0, ph0
        for step in range(self.k):
            pv = self._prop_down(params, h)
            vk = _sample(pv, draws[2 * step + 1], self.visible_unit)
            phk = self._prop_up(params, vk)
            h = _sample(phk, draws[2 * step + 2], self.hidden_unit)
        B = v0.shape[0]
        return {"W": (vk.T @ phk - v0.T @ ph0) / B,
                "b": (phk - ph0).mean(dim=0),
                "vb": (vk - v0).mean(dim=0)}

    def pretrain_loss(self, params, x, *, rng=None, draws=None):
        """The monitoring quantity: the reconstruction error of one pass
        up and down (no sampling)."""
        pv = self._prop_down(params, self._prop_up(params, x))
        return ((x - pv) ** 2).sum(dim=-1).mean()
