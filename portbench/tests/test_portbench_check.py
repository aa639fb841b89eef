"""The numbers a training run compares, on hand-made norms; the idle
share a traced run reports; the feed's pinned threads."""
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import check, traffic as T
from portbench.readers import device_idle


def _norms(n_conv=6, n_bn=12, seed=0):
    """The reference's and a sound program's norms of a toy ResNet-like
    net: convolutions, BatchNorm gammas and betas, running statistics."""
    rng = np.random.default_rng(seed)
    conv = [("c%d" % i, "W") for i in range(n_conv)]
    bn = [("b%d" % i, k) for i in range(n_bn // 2) for k in ("gamma",
                                                             "beta")]
    stats = [("b%d" % i, k) for i in range(n_bn // 2) for k in ("mean",
                                                                "var")]
    ref = {"losses": [7.0, 6.9, 6.8],
           "grad": {k: float(rng.uniform(0.5, 2.0)) for k in conv + bn}}
    ref["change"] = {k: 0.1 * v for k, v in ref["grad"].items()}
    ref["change"].update({k: float(rng.uniform(0.1, 0.3)) for k in stats})
    prog = {"losses": [x * 1.001 for x in ref["losses"]],
            "grad": {k: v * 1.02 for k, v in ref["grad"].items()},
            "change": {k: v * 0.97 for k, v in ref["change"].items()}}
    return prog, ref, bn


def test_sound_norms_leave_no_leaf_far():
    prog, ref, _ = _norms()
    r = check.train_readings(prog, ref)
    assert r["far_leaves"] == 0
    assert r["change_gap"] == pytest.approx(0.03)
    assert r["loss_gap"] == pytest.approx(0.001)


@pytest.mark.parametrize("factor", [0.0, 2.0], ids=["unmoved", "double"])
def test_batch_norm_left_behind_or_moved_double_counts(factor):
    # each gamma and beta reads a gap under 1 against the median leaf's
    # change where its own is smaller, so the worst-leaf limits above 1
    # miss it; the count of leaves at 0.9 or more does not
    prog, ref, bn = _norms()
    for k in bn:
        prog["change"][k] = factor * ref["change"][k]
    r = check.train_readings(prog, ref)
    assert r["change_gap"] <= 1.0 + 1e-12
    floor = sorted(ref["change"][k] for k in ref["grad"])
    floor = np.median(floor)
    expect = sum(ref["change"][k] >= check.FAR * floor for k in bn)
    assert r["far_leaves"] == expect >= 3


def test_idle_share_of_an_untraced_step():
    # 10 untraced steps in 1 s, 100 ms a step; the traced steps were
    # stretched to 150 ms by the profiler, with 80 ms of device work each
    ctx = SimpleNamespace(window_s=1.0, steps=10, ranks=[
        {"trace": {"busy_s": 0.4, "steps": 5, "window_s": 0.75}}])
    assert device_idle.read(ctx) == pytest.approx(20.0)


def test_pinned_feed_keeps_its_threads_apart():
    cores = T.physical_cores()
    if len(cores) < 2:
        pytest.skip("one physical core")
    before = os.sched_getaffinity(0)
    started = {}

    def make():
        ready = threading.Event()

        def staging():
            started["cpus"] = os.sched_getaffinity(0)
            ready.set()
        threading.Thread(target=staging).start()
        ready.wait()
        return "feed"
    try:
        assert T.pinned(make) == "feed"
        assert started["cpus"] == {cores[-2]}
        assert os.sched_getaffinity(0) == {cores[-1]}
    finally:
        os.sched_setaffinity(0, before)
