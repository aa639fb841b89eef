"""The tail over all samples and the spread of a set of runs."""
import random
import statistics

import numpy as np
import pytest

from portbench.stats import percentile, spread


@pytest.mark.parametrize("n", [1, 2, 7, 200, 1001])
def test_percentile_is_over_all_samples(n):
    rng = random.Random(n)
    xs = [rng.lognormvariate(0, 1) for _ in range(n)]
    for q in (50, 95, 99):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_p95_of_a_window_sees_its_slow_steps():
    # 200 steps of 100 ms and 20 of 300 ms: the slow tenth sets the p95,
    # where a reservoir of the newest 100 fast steps would not see it
    steps = [300.0] * 20 + [100.0] * 200
    assert percentile(steps, 95) == 300.0
    assert percentile(steps[-100:], 95) == 100.0


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 9.0, 10.5, 9.5, 10.0]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))
