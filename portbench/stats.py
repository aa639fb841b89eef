"""Percentiles over all samples, and the spread of a set of runs."""
from __future__ import annotations

import math
import statistics


def percentile(values, q):
    """The q-th percentile (0-100) of all `values`, linear between the
    two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values):
    """The distance between the first and third quartiles (Python's
    `statistics.quantiles(values, n=4)`) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
