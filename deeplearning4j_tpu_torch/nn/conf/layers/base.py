"""Layer configuration base class and registry: port of
deeplearning4j_tpu/nn/conf/layers/base.py.

The same fields, defaults and JSON as the reference, so a configuration
written by one package loads in the other unchanged. Config and math are
one class, as in the reference: the layer carries its hyperparameters,
`init_params` and its forward as plain functions on tensors; parameters
and state live in the containers (`nn.Module`s), and autograd gives the
backward.

Parameters are held in the port's layout (for a convolution OIHW, where
the reference holds HWIO). `to_reference` / `from_reference` move one
parameter between the two; the containers' `params()`, `set_params()`,
`from_jax_params()` and the model zip speak the reference's layout.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, fields

import torch

LAYER_REGISTRY = {}

# Fields that participate in global-default override (reference:
# NeuralNetConfiguration.Builder globals). None on a layer = inherit global.
GLOBAL_OVERRIDABLE = (
    "activation", "weight_init", "dist", "learning_rate", "bias_learning_rate",
    "bias_init", "l1", "l2", "l1_bias", "l2_bias", "dropout", "updater", "momentum",
    "rho", "rms_decay", "epsilon", "adam_mean_decay", "adam_var_decay",
    "gradient_normalization", "gradient_normalization_threshold",
    "lr_policy", "lr_policy_decay_rate", "lr_policy_steps", "lr_policy_power",
    "lr_policy_max_iterations", "lr_schedule",
)


def register_layer(name):
    def deco(cls):
        LAYER_REGISTRY[name] = cls
        cls.layer_type = name
        cls.span_name = f"layer.{name}"     # its forward's program span
        return cls
    return deco


@dataclass
class LayerConf:
    """Base for all layer configs. Fields default to None = 'inherit global'."""
    # whether the forward's program span (`span_name`) also times the
    # device with CUDA events: where a per-layer metric reads it, since
    # two events cost tens of microseconds of host time under a profiler
    span_times_device = False
    name: str = None
    activation: str = None
    weight_init: str = None
    dist: dict = None
    bias_init: float = None
    learning_rate: float = None
    bias_learning_rate: float = None
    l1: float = None
    l2: float = None
    l1_bias: float = None
    l2_bias: float = None
    dropout: float = None
    updater: str = None
    momentum: float = None
    rho: float = None
    rms_decay: float = None
    epsilon: float = None
    adam_mean_decay: float = None
    adam_var_decay: float = None
    gradient_normalization: str = None
    gradient_normalization_threshold: float = None
    lr_policy: str = None
    lr_policy_decay_rate: float = None
    lr_policy_steps: float = None
    lr_policy_power: float = None
    lr_policy_max_iterations: float = None  # horizon for 'poly' decay
    lr_schedule: dict = None

    # ------------------------------------------------------------------
    # Contract each concrete layer implements
    # ------------------------------------------------------------------
    def init_params(self, gen, dtype=torch.float32):
        """The layer's parameters ({} for none) as CPU tensors in the
        port's layout, drawn from the torch.Generator `gen`."""
        return {}

    def forward(self, params, x, *, train=False, rng=None, mask=None, state=None):
        """Forward to the output (post-activation). `rng` is the
        container's torch.Generator for dropout."""
        raise NotImplementedError

    def get_output_type(self, input_type):
        raise NotImplementedError

    def set_n_in(self, input_type, override=True):
        """Infer nIn from the previous layer's output type."""
        return

    def has_state(self):
        """True if the layer carries non-trainable state (BN running stats)."""
        return False

    def init_state(self):
        return {}

    # ------------------------------------------------------------------
    # Layout bridge to the reference (identity but for convolutions)
    # ------------------------------------------------------------------
    def to_reference(self, key, t):
        """Parameter (or same-shaped updater state) `key` from the port's
        layout to the reference's."""
        return t

    def from_reference(self, key, t):
        """The inverse of `to_reference`."""
        return t

    # ------------------------------------------------------------------
    # Regularization score contribution (reference BaseLayer.calcL1/calcL2)
    # ------------------------------------------------------------------
    def reg_score(self, params):
        total = 0.0
        l1 = self.l1 or 0.0
        l2 = self.l2 or 0.0
        l1b = self.l1_bias if self.l1_bias is not None else 0.0
        l2b = self.l2_bias if self.l2_bias is not None else 0.0
        for k, v in params.items():
            is_bias = k in ("b", "beta")
            a1, a2 = (l1b, l2b) if is_bias else (l1, l2)
            if a1:
                total = total + a1 * v.abs().sum()
            if a2:
                total = total + 0.5 * a2 * (v * v).sum()
        return total

    # ------------------------------------------------------------------
    # Serde
    # ------------------------------------------------------------------
    def to_dict(self):
        d = {"type": self.layer_type}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        typ = d.pop("type")
        if typ not in LAYER_REGISTRY:
            raise ValueError(f"Unknown layer type '{typ}'. "
                             f"Known: {sorted(LAYER_REGISTRY)}")
        klass = LAYER_REGISTRY[typ]
        valid = {f.name for f in fields(klass)}
        kwargs = {}
        for k, v in d.items():
            if k in valid:
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
        return klass(**kwargs)

    def apply_global_defaults(self, g):
        """Fill None fields from the global builder config `g` (a dict)."""
        out = copy.deepcopy(self)
        for fname in GLOBAL_OVERRIDABLE:
            if getattr(out, fname, None) is None and g.get(fname) is not None:
                setattr(out, fname, g[fname])
        if out.activation is None:
            out.activation = "sigmoid"       # reference default
        if out.weight_init is None:
            out.weight_init = "xavier"       # reference default
        if out.learning_rate is None:
            out.learning_rate = 0.1          # reference default
        if out.updater is None:
            out.updater = "sgd"              # reference default
        if out.bias_init is None:
            out.bias_init = 0.0
        if out.lr_policy is None:
            out.lr_policy = "none"
        return out

    # Updater hyperparameter dict consumed by updaters.apply
    def updater_hp(self):
        hp = {}
        if self.momentum is not None:
            hp["momentum"] = self.momentum
        if self.rho is not None:
            hp["rho"] = self.rho
        if self.rms_decay is not None:
            hp["rmsDecay"] = self.rms_decay
        if self.epsilon is not None:
            hp["epsilon"] = self.epsilon
        if self.adam_mean_decay is not None:
            hp["adamMeanDecay"] = self.adam_mean_decay
        if self.adam_var_decay is not None:
            hp["adamVarDecay"] = self.adam_var_decay
        return hp


class DropoutTape:
    """The dropout keep masks of one recomputed segment (the
    ComputationGraph's `remat_segments`): its first forward draws them from
    `generator` in the plain path's order and keeps them; `rewind()` at the
    start of each later run (the backward's recompute) replays them, so the
    recompute sees the first forward's masks and the generator moves once.
    No generator state is read or set, so it also runs inside a CUDA graph
    capture."""

    def __init__(self, generator):
        self.generator = generator
        self._masks = []
        self._next = None       # None: drawing; an index: replaying
        self._runs = 0

    def rewind(self):
        self._next = 0 if self._runs else None
        self._runs += 1

    def keep(self, shape, p, device):
        if self._next is None:
            m = torch.rand(shape, generator=self.generator,
                           device=device) < p
            self._masks.append(m)
            return m
        m = self._masks[self._next]
        self._next += 1
        return m


def apply_input_dropout(conf: LayerConf, x, train, rng):
    """Inverted dropout on the layer *input* (DL4J util/Dropout.java). The
    dropout value is the probability of RETAINING an activation, as in
    ND4J's DropOutInverted. `rng` is a torch.Generator on x's device, or a
    `DropoutTape` over one."""
    p = conf.dropout or 0.0
    if not train or p <= 0.0 or p >= 1.0 or rng is None:
        return x
    if isinstance(rng, DropoutTape):
        keep = rng.keep(x.shape, p, x.device)
    else:
        keep = torch.rand(x.shape, generator=rng, device=x.device) < p
    return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
