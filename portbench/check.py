"""The numbers a run compares with the reference, each beside its limit
(`cells/<cell>.json`); a cell compares the ones its limits name.

Training (the first steps, which the window's own `fit` and feed drove):
- `loss_gap`: the largest relative gap between a step's loss and the
  reference's.
- `grad_norm_gap`: the relative gap between the norm of the whole first
  gradient as the program's optimizer got it (worked out from the
  Nesterov velocity after one step, g = -v / lr) and the reference's.
- `grad_gap`: per parameter, the gap between the norm of its first
  gradient and the reference's, over the larger of the reference's norm
  of that parameter and the median parameter's; the worst parameter.
- `change_gap`, `stats_gap`: the same for the norm of each parameter's
  change after the last step (parameters whose reference gradient is
  under a thousandth of the median parameter's left out: they move by
  round-off alone) and of each running statistic's change.
- `far_leaves`: how many of those parameters and running statistics
  read a change gap of `FAR` or more. A leaf left unmoved, or moved
  double, reads 1 wherever its change is at least the median's, so a
  fault that leaves a whole kind of leaf behind (BatchNorm's gamma and
  beta, say) shows here even where each leaf's own gap stays under the
  worst-leaf limits.

Scoring (every row the window served): `prob_gap`, the largest absolute
gap between a served probability and the reference's; `logp_gap`, the
largest gap between their logarithms where the reference's probability
is 1e-3 or more; `tv_mean`, the mean over rows of the total variation
distance.
"""
from __future__ import annotations

import math
import statistics

FAR = 0.9


def scaled_gaps(prog, ref, leaves):
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm and the median leaf's."""
    floor = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
            for k in leaves]


def _total(norms, leaves):
    return math.sqrt(sum(norms[k] ** 2 for k in leaves))


def leaf_sets(ref):
    """(parameters, parameters that move, running statistics) of the
    reference's norms (`reference.steps.train`'s dict)."""
    params = list(ref["grad"])
    floor = statistics.median(ref["grad"][k] for k in params)
    moved = [k for k in params if ref["grad"][k] >= 1e-3 * floor]
    stats = [k for k in ref["change"] if k not in ref["grad"]]
    return params, moved, stats


def train_readings(prog, ref):
    """{number: reading} of the program's first steps against the
    reference's (both {"losses", "grad", "change"} of norms)."""
    params, moved, stats = leaf_sets(ref)
    change = scaled_gaps(prog["change"], ref["change"], moved)
    total = _total(ref["grad"], params)
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], ref["losses"])),
           "grad_norm_gap": abs(_total(prog["grad"], params) - total)
           / total,
           "grad_gap": max(scaled_gaps(prog["grad"], ref["grad"], params)),
           "change_gap": max(change)}
    if stats:
        stat = scaled_gaps(prog["change"], ref["change"], stats)
        out["stats_gap"] = max(stat)
        change = change + stat
    out["far_leaves"] = float(sum(g >= FAR for g in change))
    return out


def scoring_readings(served, ref):
    """The served probabilities [(pool batch, rows x classes)] against the
    reference's {pool batch: rows x classes}."""
    import numpy as np
    prob = logp = 0.0
    tv = []
    for j, p in served:
        r = ref[j]
        d = np.abs(p - r)
        prob = max(prob, float(d.max()))
        keep = r >= 1e-3
        with np.errstate(divide="ignore"):
            lg = np.abs(np.log(np.maximum(p, 1e-30)) - np.log(r))
        logp = max(logp, float(lg[keep].max()) if keep.any() else 0.0)
        tv.extend(0.5 * d.sum(axis=1))
    if not tv:
        return {"prob_gap": math.nan, "logp_gap": math.nan,
                "tv_mean": math.nan}
    return {"prob_gap": prob, "logp_gap": logp,
            "tv_mean": float(np.mean(tv))}


def worst_over(readings_list):
    """The worst of several ranks' readings, number by number."""
    out = {}
    for r in readings_list:
        for k, v in r.items():
            out[k] = v if k not in out or not (v <= out[k]) else out[k]
    return out


def judge(readings, limits):
    """(correct, [(name, reading, limit)]): every number at or under its
    limit (a number that is not finite fails)."""
    rows = [(k, float(readings.get(k, math.nan)), float(limits[k]))
            for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
