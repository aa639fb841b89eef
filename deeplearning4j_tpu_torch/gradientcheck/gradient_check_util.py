"""Numerical gradient checks: port of
deeplearning4j_tpu/gradientcheck/gradient_check_util.py (the reference's
gradientcheck/GradientCheckUtil.java:76 for MultiLayerNetwork and :222 for
ComputationGraph): perturb each parameter by +/- epsilon, and hold
(score+ - score-) / (2 eps) against the analytic gradient with a maximum
relative error. The reference forces double precision; run it on float64
networks (`data_type("float64")`).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger(__name__)


def check_gradients(net, features, labels, epsilon=1e-6, max_rel_error=1e-3,
                    min_abs_error=1e-8, print_results=False, fmask=None,
                    lmask=None, subset=None, seed=12345):
    """Gradient-check a MultiLayerNetwork or a ComputationGraph (any object
    with compute_gradient_and_score / flatten_gradients / params /
    set_params / make_flat_score_fn).

    Returns True if every checked parameter passes: a relative error of at
    most `max_rel_error`, or an absolute one of at most `min_abs_error`.
    `subset`: check a random subset of N parameters (numpy's
    default_rng(seed).choice, as the reference draws it)."""
    grads, _ = net.compute_gradient_and_score(features, labels, fmask, lmask,
                                              train=True)
    analytic = net.flatten_gradients(grads)
    flat0 = net.params().astype(np.float64)
    n = flat0.size

    idxs = np.arange(n)
    if subset is not None and subset < n:
        rng = np.random.default_rng(seed)
        idxs = rng.choice(n, size=subset, replace=False)

    score_fn = net.make_flat_score_fn(features, labels, fmask, lmask,
                                      train=True)

    def score_at(vec):
        with torch.no_grad():
            return float(score_fn(vec))

    fails = 0
    max_err_seen = 0.0
    for i in idxs:
        orig = flat0[i]
        flat0[i] = orig + epsilon
        s_plus = score_at(flat0)
        flat0[i] = orig - epsilon
        s_minus = score_at(flat0)
        flat0[i] = orig
        numeric = (s_plus - s_minus) / (2.0 * epsilon)
        a = analytic[i]
        abs_err = abs(a - numeric)
        denom = abs(a) + abs(numeric)
        rel_err = abs_err / denom if denom > 0 else 0.0
        max_err_seen = max(max_err_seen, rel_err)
        ok = rel_err <= max_rel_error or abs_err <= min_abs_error
        if not ok:
            fails += 1
            log.warning("param %d FAILED: analytic=%.8g numeric=%.8g "
                        "relErr=%.4g", i, a, numeric, rel_err)
        elif print_results:
            log.info("param %d ok: analytic=%.8g numeric=%.8g relErr=%.4g",
                     i, a, numeric, rel_err)
    net.set_params(flat0)
    if fails:
        log.warning("GradientCheck: %d/%d FAILED (maxRelErr=%.4g)", fails,
                    len(idxs), max_err_seen)
    return fails == 0
