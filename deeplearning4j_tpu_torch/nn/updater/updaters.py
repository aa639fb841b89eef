"""Gradient updaters, learning-rate schedules and gradient normalization:
port of deeplearning4j_tpu/nn/updater/updaters.py.

Each updater is a pair of plain functions (init_state, apply) over one
tensor, with the reference's formulas (ND4J's GradientUpdater
implementations) and its state names, so a model zip's
`updaterState.bin` restores into either package. The update math runs in
f32 (at least): a state stored in bf16 (`updater_state_dtype`) is widened
before the arithmetic and rounded once when stored, and hyperparameters
are never rounded to a narrow type (on bf16 tensors `torch.add(g, v,
alpha=0.9)` would run with 0.8984375).

`schedule_lr` runs on the host: the iteration count is a Python int, so a
step reads no scalar back from the card.
"""
from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# Learning rate schedules — reference nn/conf/LearningRatePolicy.java
# ---------------------------------------------------------------------------


def schedule_lr(base_lr, policy, iteration, *, decay_rate=0.0, steps=1.0,
                power=1.0, schedule_map=None, max_iterations=None):
    """The effective learning rate at `iteration`.

    Policies: none, exponential, inverse, step, poly, sigmoid, torchstep,
    schedule (DL4J LayerUpdater.applyLrDecayPolicy formulas)."""
    policy = str(policy).lower()
    it = float(iteration)
    if policy in ("none", "fixed"):
        return base_lr
    if policy == "exponential":
        return base_lr * decay_rate ** it
    if policy == "inverse":
        return base_lr / (1.0 + decay_rate * it) ** power
    if policy in ("step", "torchstep"):
        return base_lr * decay_rate ** math.floor(it / steps)
    if policy == "poly":
        if max_iterations is None or float(max_iterations) <= 0.0:
            raise ValueError(
                "lr policy 'poly' needs a decay horizon: set "
                ".lr_policy_max_iterations(N) on the builder (lr reaches 0 "
                "at iteration N)")
        frac = min(max(it / float(max_iterations), 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power
    if policy == "sigmoid":
        return base_lr / (1.0 + math.exp(-decay_rate * (it - steps)))
    if policy == "schedule":
        # schedule_map: {iteration: lr}, piecewise constant
        lr = base_lr
        if schedule_map:
            for k in sorted(schedule_map, key=float):
                if it >= float(k):
                    lr = schedule_map[k]
        return lr
    raise ValueError(f"Unknown learning rate policy '{policy}'")


# ---------------------------------------------------------------------------
# Per-tensor updaters — reference ND4J GradientUpdater implementations
# ---------------------------------------------------------------------------

def _zeros_like(p):
    return torch.zeros_like(p)


def _counter(p):
    # >= f32 so the step counter and bias-correction powers stay exact
    return torch.zeros((), dtype=torch.promote_types(p.dtype, torch.float32),
                       device=p.device)


def sgd_init(p):
    return {}


def sgd_apply(state, grad, lr, hp):
    return lr * grad, state


def nesterovs_init(p):
    return {"v": _zeros_like(p)}


def nesterovs_apply(state, grad, lr, hp):
    # ND4J Nesterovs: vPrev = v; v = mu*v - lr*g; update = mu*vPrev -
    # (1+mu)*v, then params -= update (at mu=0: params -= lr*g)
    mu = hp.get("momentum", 0.9)
    v_prev = state["v"]
    v = mu * v_prev - lr * grad
    update = mu * v_prev - (1.0 + mu) * v
    return update, {"v": v}


def adagrad_init(p):
    return {"h": _zeros_like(p)}


def adagrad_apply(state, grad, lr, hp):
    eps = hp.get("epsilon", 1e-6)
    h = state["h"] + grad * grad
    update = lr * grad / (torch.sqrt(h) + eps)
    return update, {"h": h}


def rmsprop_init(p):
    return {"g2": _zeros_like(p)}


def rmsprop_apply(state, grad, lr, hp):
    decay = hp.get("rmsDecay", 0.95)
    eps = hp.get("epsilon", 1e-8)
    g2 = decay * state["g2"] + (1.0 - decay) * grad * grad
    update = lr * grad / torch.sqrt(g2 + eps)
    return update, {"g2": g2}


def adadelta_init(p):
    return {"msg": _zeros_like(p), "msdx": _zeros_like(p)}


def adadelta_apply(state, grad, lr, hp):
    rho = hp.get("rho", 0.95)  # ND4J AdaDelta default
    eps = hp.get("epsilon", 1e-6)
    msg = rho * state["msg"] + (1.0 - rho) * grad * grad
    dx = grad * torch.sqrt(state["msdx"] + eps) / torch.sqrt(msg + eps)
    msdx = rho * state["msdx"] + (1.0 - rho) * dx * dx
    return dx, {"msg": msg, "msdx": msdx}  # lr unused, as the reference


def adam_init(p):
    return {"m": _zeros_like(p), "v": _zeros_like(p), "t": _counter(p)}


def adam_apply(state, grad, lr, hp):
    b1 = hp.get("adamMeanDecay", 0.9)
    b2 = hp.get("adamVarDecay", 0.999)
    eps = hp.get("epsilon", 1e-8)
    t = state["t"] + 1.0
    m = b1 * state["m"] + (1.0 - b1) * grad
    v = b2 * state["v"] + (1.0 - b2) * grad * grad
    alpha = lr * torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))
    update = alpha * m / (torch.sqrt(v) + eps)
    return update, {"m": m, "v": v, "t": t}


def adamax_init(p):
    return {"m": _zeros_like(p), "u": _zeros_like(p), "t": _counter(p)}


def adamax_apply(state, grad, lr, hp):
    b1 = hp.get("adamMeanDecay", 0.9)
    b2 = hp.get("adamVarDecay", 0.999)
    eps = hp.get("epsilon", 1e-8)
    t = state["t"] + 1.0
    m = b1 * state["m"] + (1.0 - b1) * grad
    u = torch.maximum(b2 * state["u"], torch.abs(grad))
    update = lr / (1.0 - torch.pow(b1, t)) * m / (u + eps)
    return update, {"m": m, "u": u, "t": t}


def nadam_init(p):
    return {"m": _zeros_like(p), "v": _zeros_like(p), "t": _counter(p)}


def nadam_apply(state, grad, lr, hp):
    b1 = hp.get("adamMeanDecay", 0.9)
    b2 = hp.get("adamVarDecay", 0.999)
    eps = hp.get("epsilon", 1e-8)
    t = state["t"] + 1.0
    m = b1 * state["m"] + (1.0 - b1) * grad
    v = b2 * state["v"] + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - torch.pow(b1, t + 1.0))
    g_hat = grad / (1.0 - torch.pow(b1, t))
    v_hat = v / (1.0 - torch.pow(b2, t))
    update = lr * (b1 * m_hat + (1.0 - b1) * g_hat) / (torch.sqrt(v_hat) + eps)
    return update, {"m": m, "v": v, "t": t}


def none_init(p):
    return {}


def none_apply(state, grad, lr, hp):
    return torch.zeros_like(grad), state


UPDATERS = {
    "sgd": (sgd_init, sgd_apply),
    "nesterovs": (nesterovs_init, nesterovs_apply),
    "adagrad": (adagrad_init, adagrad_apply),
    "rmsprop": (rmsprop_init, rmsprop_apply),
    "adadelta": (adadelta_init, adadelta_apply),
    "adam": (adam_init, adam_apply),
    "adamax": (adamax_init, adamax_apply),
    "nadam": (nadam_init, nadam_apply),
    "none": (none_init, none_apply),
}


def get(name):
    key = str(name).lower()
    if key not in UPDATERS:
        raise ValueError(f"Unknown updater '{name}'. Known: {sorted(UPDATERS)}")
    return UPDATERS[key]


_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float64": torch.float64}


def cast_updater_state(state, dtype):
    """Cast the non-scalar float leaves of one parameter's (or a nested
    dict of) updater state to `dtype` ('bfloat16' halves the optimizer's
    memory traffic; scalar leaves such as Adam's step counter keep their
    exact type). bf16 moments lose ~8 bits of mantissa: prefer f32 state
    for Adam-family runs where the last fraction of accuracy matters."""
    if dtype is None:
        return state
    dt = _DTYPES[str(dtype)] if not isinstance(dtype, torch.dtype) else dtype
    if isinstance(state, dict):
        return {k: cast_updater_state(v, dt) for k, v in state.items()}
    if state.ndim > 0 and state.is_floating_point():
        return state.to(dt)
    return state


def _wide(t):
    return t.to(torch.promote_types(t.dtype, torch.float32))


@torch.no_grad()
def apply_layer(layer, params, grads, ustate, iteration, minimize=True):
    """One layer's update (the reference's per-layer body of
    `make_apply_fn`): gradient normalization, the learning rate at
    `iteration`, the updater. Updates `params` (a dict of tensors) in place
    and returns the layer's new updater state, stored in each old state's
    type."""
    if not params:
        return {}
    grads = normalize_gradients(grads, layer.gradient_normalization,
                                layer.gradient_normalization_threshold or 1.0)
    _, apply_fn = get(layer.updater or "sgd")
    hp = layer.updater_hp()
    new_state = {}
    for k, p in params.items():
        base_lr = layer.learning_rate or 0.1
        if k in ("b", "beta") and layer.bias_learning_rate is not None:
            base_lr = layer.bias_learning_rate
        lr = schedule_lr(
            base_lr, layer.lr_policy or "none", iteration,
            decay_rate=layer.lr_policy_decay_rate or 0.0,
            steps=layer.lr_policy_steps or 1.0,
            power=layer.lr_policy_power or 1.0,
            schedule_map=layer.lr_schedule,
            max_iterations=layer.lr_policy_max_iterations)
        old = ustate[k]
        upd, s_k = apply_fn({n: _wide(s) for n, s in old.items()},
                            _wide(grads[k]), lr, hp)
        wide = _wide(p)
        p.copy_(wide - upd if minimize else wide + upd)
        new_state[k] = {n: s.to(old[n].dtype) for n, s in s_k.items()}
    return new_state


# ---------------------------------------------------------------------------
# Gradient normalization — reference LayerUpdater.preApply
# ---------------------------------------------------------------------------

def normalize_gradients(grads, mode, threshold=1.0):
    """DL4J GradientNormalization over one layer's {param_name: gradient}.

    Modes: None, RenormalizeL2PerLayer, RenormalizeL2PerParamType,
    ClipElementWiseAbsoluteValue, ClipL2PerLayer, ClipL2PerParamType."""
    if mode is None or str(mode).lower() in ("none", "nogradientnormalization"):
        return grads
    mode_l = str(mode).lower()
    eps = 1e-8
    if mode_l == "renormalizel2perlayer":
        total = torch.sqrt(sum((g * g).sum() for g in grads.values()) + eps)
        return {k: g / total for k, g in grads.items()}
    if mode_l == "renormalizel2perparamtype":
        return {k: g / (torch.linalg.vector_norm(g) + eps)
                for k, g in grads.items()}
    if mode_l == "clipelementwiseabsolutevalue":
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in grads.items()}
    if mode_l == "clipl2perlayer":
        total = torch.sqrt(sum((g * g).sum() for g in grads.values()) + eps)
        scale = torch.clamp(threshold / total, max=1.0)
        return {k: g * scale for k, g in grads.items()}
    if mode_l == "clipl2perparamtype":
        out = {}
        for k, g in grads.items():
            n = torch.linalg.vector_norm(g) + eps
            out[k] = g * torch.clamp(threshold / n, max=1.0)
        return out
    raise ValueError(f"Unknown gradient normalization '{mode}'")
