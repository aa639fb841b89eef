"""Variational autoencoder layer and its reconstruction distributions: port
of deeplearning4j_tpu/nn/conf/layers/variational.py.

The layer owns an encoder MLP, the (mean, log-variance) heads of q(z|x),
a sampled z, a decoder MLP and the parameters of a reconstruction
distribution p(x|z). As a pretrain layer its loss is the negative ELBO;
in a feed-forward stack `forward` gives the latent means. Its parameters
are named as the reference's: `e{i}W/b`, `pZXMeanW/b`, `pZXLogStd2W/b`,
`d{i}W/b`, `pXZW/b`, each W [n_in, n_out]. The log-variance is clipped to
±10.

The reparameterisation's noise is split from the math: `eps` (one
standard-normal [B, n_out] tensor a sample, the reference's
`normal(fold_in(rng, s))`) comes from `pretrain_draws` on a
torch.Generator, or is handed in as `draws`. Autograd gives the ELBO's
gradients.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ... import activations, losses, weights
from ..input_type import InputType
from .base import LayerConf, register_layer
from .feedforward import _ff_size

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Reconstruction distributions
# ---------------------------------------------------------------------------

class GaussianReconstructionDistribution:
    """p(x|z) = N(mean, exp(logvar)); the decoder gives [mean, logvar]
    halves."""

    def __init__(self, activation="identity"):
        self.activation = activation

    def params_per_feature(self):
        return 2

    def total_params(self, n):
        return n * self.params_per_feature()

    def neg_log_prob(self, x, dist_params):
        n = x.shape[-1]
        mean = activations.get(self.activation)(dist_params[..., :n])
        logvar = dist_params[..., n:].clamp(-10.0, 10.0)
        ll = (-_HALF_LOG_2PI - 0.5 * logvar
              - (x - mean) ** 2 / (2.0 * torch.exp(logvar)))
        return -ll.sum(dim=-1)

    def sample_mean(self, dist_params, n):
        return activations.get(self.activation)(dist_params[..., :n])

    def to_dict(self):
        return {"type": "gaussian", "activation": self.activation}


class BernoulliReconstructionDistribution:
    """p(x|z) = Bernoulli(sigmoid(logits))."""

    def params_per_feature(self):
        return 1

    def total_params(self, n):
        return n

    def neg_log_prob(self, x, dist_params):
        ll = (x * F.logsigmoid(dist_params)
              + (1 - x) * F.logsigmoid(-dist_params))
        return -ll.sum(dim=-1)

    def sample_mean(self, dist_params, n):
        return torch.sigmoid(dist_params)

    def to_dict(self):
        return {"type": "bernoulli"}


class ExponentialReconstructionDistribution:
    """p(x|z) = λ·exp(−λx) for x ≥ 0; the decoder gives γ = log λ (through
    `activation`, clipped to ±20), so log p(x) = γ − exp(γ)·x."""

    def __init__(self, activation="identity"):
        self.activation = activation

    def params_per_feature(self):
        return 1

    def total_params(self, n):
        return n

    def _gamma(self, dist_params):
        return activations.get(self.activation)(dist_params).clamp(-20.0,
                                                                   20.0)

    def neg_log_prob(self, x, dist_params):
        gamma = self._gamma(dist_params)
        return -(gamma - torch.exp(gamma) * x).sum(dim=-1)

    def sample_mean(self, dist_params, n):
        return torch.exp(-self._gamma(dist_params))      # E[x] = 1/λ

    def to_dict(self):
        return {"type": "exponential", "activation": self.activation}


class CompositeReconstructionDistribution:
    """Distributions over consecutive feature slices (e.g. 10 gaussian
    features, then 5 bernoulli ones): each component sees its slice of the
    data and of the decoder's output; the losses add."""

    def __init__(self, components):
        """components: (n_features, distribution) pairs, in feature order."""
        self.components = [(int(n), d) for n, d in components]

    def total_params(self, n):
        expect = sum(nc for nc, _ in self.components)
        if n != expect:
            raise ValueError(
                f"composite components cover {expect} features, layer "
                f"has {n}")
        return sum(d.total_params(nc) for nc, d in self.components)

    def _slices(self):
        xi = pi = 0
        for nc, d in self.components:
            npar = d.total_params(nc)
            yield nc, d, slice(xi, xi + nc), slice(pi, pi + npar)
            xi += nc
            pi += npar

    def neg_log_prob(self, x, dist_params):
        total = 0.0
        for _, d, xs, ps in self._slices():
            total = total + d.neg_log_prob(x[..., xs], dist_params[..., ps])
        return total

    def sample_mean(self, dist_params, n):
        return torch.cat([d.sample_mean(dist_params[..., ps], nc)
                          for nc, d, _, ps in self._slices()], dim=-1)

    def to_dict(self):
        return {"type": "composite",
                "components": [[n, d.to_dict()]
                               for n, d in self.components]}


class LossFunctionWrapper:
    """A loss function as the reconstruction term (a plain autoencoder
    inside the VAE): the 'negative log probability' is the loss value. Not
    a density, so `reconstruction_probability` raises with it."""

    def __init__(self, loss="mse", activation="identity"):
        self.loss = loss
        self.activation = activation

    def params_per_feature(self):
        return 1

    def total_params(self, n):
        return n

    def neg_log_prob(self, x, dist_params):
        return losses.get(self.loss)(x, dist_params, self.activation)

    def sample_mean(self, dist_params, n):
        return activations.get(self.activation)(dist_params)

    def to_dict(self):
        return {"type": "loss_wrapper", "loss": self.loss,
                "activation": self.activation}


_DISTRIBUTIONS = (GaussianReconstructionDistribution,
                  BernoulliReconstructionDistribution,
                  ExponentialReconstructionDistribution,
                  CompositeReconstructionDistribution, LossFunctionWrapper)


def _dist_from_dict(d):
    if isinstance(d, _DISTRIBUTIONS):
        return d
    if d is None or d.get("type") == "gaussian":
        return GaussianReconstructionDistribution(
            (d or {}).get("activation", "identity"))
    if d["type"] == "bernoulli":
        return BernoulliReconstructionDistribution()
    if d["type"] == "exponential":
        return ExponentialReconstructionDistribution(
            d.get("activation", "identity"))
    if d["type"] == "composite":
        return CompositeReconstructionDistribution(
            [(n, _dist_from_dict(c)) for n, c in d["components"]])
    if d["type"] == "loss_wrapper":
        return LossFunctionWrapper(d.get("loss", "mse"),
                                   d.get("activation", "identity"))
    raise ValueError(f"Unknown reconstruction distribution {d}")


# ---------------------------------------------------------------------------

@register_layer("vae")
@dataclass
class VariationalAutoencoder(LayerConf):
    n_in: int = None
    n_out: int = None                       # latent size
    encoder_layer_sizes: tuple = (100,)
    decoder_layer_sizes: tuple = (100,)
    pzx_activation: str = "identity"        # the mean head's activation
    reconstruction_distribution: dict = None  # serde dict; see _dist
    num_samples: int = 1

    def __post_init__(self):
        self.encoder_layer_sizes = tuple(self.encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(self.decoder_layer_sizes)
        # a distribution object becomes its serde dict, so to_json
        # round-trips however the conf was built
        if hasattr(self.reconstruction_distribution, "to_dict"):
            self.reconstruction_distribution = \
                self.reconstruction_distribution.to_dict()

    def _dist(self):
        return _dist_from_dict(self.reconstruction_distribution)

    def set_n_in(self, input_type, override=True):
        if self.n_in is None or override:
            self.n_in = _ff_size(input_type)

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        d = {}
        wi = self.weight_init or "xavier"

        def mk(name, nin, nout):
            d[f"{name}W"] = weights.init(gen, (nin, nout), nin, nout, wi,
                                         self.dist, dtype)
            d[f"{name}b"] = torch.zeros(nout, dtype=dtype)

        prev = self.n_in
        for i, h in enumerate(self.encoder_layer_sizes):
            mk(f"e{i}", prev, h)
            prev = h
        mk("pZXMean", prev, self.n_out)
        mk("pZXLogStd2", prev, self.n_out)
        prev = self.n_out
        for i, h in enumerate(self.decoder_layer_sizes):
            mk(f"d{i}", prev, h)
            prev = h
        mk("pXZ", prev, self._dist().total_params(self.n_in))
        return d

    # ------------------------------------------------------------------
    def _encode(self, params, x):
        """(mean, logvar clipped to ±10) of q(z|x)."""
        act = activations.get(self.activation or "identity")
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"e{i}W"] + params[f"e{i}b"])
        mean = activations.get(self.pzx_activation)(
            h @ params["pZXMeanW"] + params["pZXMeanb"])
        logvar = h @ params["pZXLogStd2W"] + params["pZXLogStd2b"]
        return mean, logvar.clamp(-10.0, 10.0)

    def _decode(self, params, z):
        act = activations.get(self.activation or "identity")
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"d{i}W"] + params[f"d{i}b"])
        return h @ params["pXZW"] + params["pXZb"]

    def forward(self, params, x, *, train=False, rng=None, mask=None,
                state=None):
        """The latent means."""
        return self._encode(params, x)[0]

    def _eps(self, x, gen, n):
        """n standard-normal [B, n_out] draws from `gen` (None: a generator
        seeded 0, as the reference's PRNGKey(0))."""
        if gen is None:
            gen = torch.Generator(x.device).manual_seed(0)
        return [torch.randn((x.shape[0], self.n_out), generator=gen,
                            dtype=x.dtype, device=x.device)
                for _ in range(n)]

    def pretrain_draws(self, x, gen):
        """The reparameterisation's noise for the batch `x`: `num_samples`
        standard-normal [B, n_out] tensors from the torch.Generator `gen`."""
        return self._eps(x, gen, self.num_samples)

    def pretrain_loss(self, params, x, *, rng=None, draws=None):
        """The negative ELBO, E_q[−log p(x|z)] + KL(q(z|x) ‖ N(0, I)), the
        mean over examples, with `num_samples` draws of z = mean +
        exp(logvar / 2)·eps. `draws`: the eps tensors (drawn from `rng`
        when None)."""
        if draws is None:
            draws = self.pretrain_draws(x, rng)
        mean, logvar = self._encode(params, x)
        kl = 0.5 * (torch.exp(logvar) + mean ** 2 - 1.0 - logvar).sum(dim=-1)
        dist = self._dist()
        recon = 0.0
        for eps in draws:
            z = mean + torch.exp(0.5 * logvar) * eps
            recon = recon + dist.neg_log_prob(x, self._decode(params, z))
        return (recon / self.num_samples + kl).mean()

    def reconstruction_probability(self, params, x, num_samples=5, rng=None,
                                   draws=None):
        """A Monte-Carlo (importance-weighted) estimate of log p(x) per
        example over `num_samples` draws of z; `draws`: the eps tensors
        (drawn from `rng` when None). Undefined, and raises, with
        LossFunctionWrapper."""
        dist = self._dist()
        if isinstance(dist, LossFunctionWrapper):
            raise ValueError(
                "reconstruction_probability is undefined with "
                "LossFunctionWrapper (not a probability distribution); "
                "use a Gaussian/Bernoulli/Exponential/Composite "
                "reconstruction distribution")
        if draws is None:
            draws = self._eps(x, rng, num_samples)
        mean, logvar = self._encode(params, x)
        terms = []
        for eps in draws:
            z = mean + torch.exp(0.5 * logvar) * eps
            log_pxz = -dist.neg_log_prob(x, self._decode(params, z))
            log_pz = (-_HALF_LOG_2PI - 0.5 * z ** 2).sum(dim=-1)
            log_qzx = (-_HALF_LOG_2PI - 0.5 * logvar
                       - (z - mean) ** 2 / (2 * torch.exp(logvar))).sum(dim=-1)
            terms.append(log_pxz + log_pz - log_qzx)
        return torch.logsumexp(torch.stack(terms), dim=0) - math.log(
            num_samples)

    reconstructionLogProbability = reconstruction_probability

    def generate_at_mean_given_z(self, params, z):
        """The reconstruction distribution's mean given latent `z`."""
        return self._dist().sample_mean(self._decode(params, z), self.n_in)

    generateAtMeanGivenZ = generate_at_mean_given_z
