"""Training through `Network.fit` (MultiLayerNetwork or ComputationGraph)
over the port's AsyncDataSetIterator, one card.

Set-up builds the network, loads the weights made from the seed, and
drives it through its first `check_steps` steps in one `fit` call over
the window's own feed (pool batches 0, 1, 2: all different rows, with
the cell's queue and staging threads in flight), an iteration listener
reading the loss after each step and the optimizer's state after the
first; the parameters and running statistics are read after the last.
Then `warmup_steps` timed steps give the step time, from which the
window's step count is set so that it lasts `--seconds`. The window is
one `fit` call over that many batches; an iteration listener records a
CUDA event after each step. A traced run then profiles `trace_steps`
more steps. Once the program is freed, the reference takes the same
first steps from the same inputs.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import check, profile, traffic as T
from ..flops import PEAK_FLOPS, train_flops
from ..harness import note, process_age
from ..reference import common as C, steps as RS
from ..stats import percentile


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _norm(a):
    return float(np.linalg.norm(np.ravel(a)))


class FirstSteps:
    """An iteration listener that reads the first steps as `fit` takes
    them: each step's loss, and after the first step the gradient as the
    optimizer got it (from the Nesterov velocity, g = -v / lr)."""

    def __init__(self, family, lr):
        self.family, self.lr = family, lr
        self.losses, self.grad = [], None

    def iteration_done(self, net, iteration):
        self.losses.append(net.score())
        if self.grad is None:
            self.grad = {k: _norm(st["v"] / -self.lr) for k, st in
                         self.family.leaf_items(
                             net.reference_updater_state())}


def program_first_steps(s, net, fit, data, host):
    """The program's norms of its first steps (see `check`)."""
    tr, fam = s.cell.traffic, s.cell.family
    probe = FirstSteps(fam, s.cell.config["learning_rate"])
    net.set_listeners(probe)
    fit(T.feed(data, tr, list(range(tr["check_steps"])), s.device))
    net.set_listeners()
    change = {k: _norm(a - host[k])
              for k, a in fam.leaf_items(net.reference_params())}
    for k, a in fam.leaf_items(net.reference_model_state()):
        change[k] = _norm(a - (1.0 if k[1] == "var" else 0.0))
    return {"losses": probe.losses, "grad": probe.grad, "change": change}


def reference_first_steps(s, data, num=C.F32, loss_rows=None):
    """The reference's norms of the same first steps (`num`: its rounding;
    the control's is "fp8"; `loss_rows`: see `steps.train`)."""
    cfg, tr, fam = s.cell.config, s.cell.traffic, s.cell.family
    C.strict_f32()
    model = fam.reference.Model(cfg, num)
    params = C.make_params(fam.reference.leaves(cfg), s.seed, s.device)
    batches = T.host_images(data, tr, range(tr["check_steps"]), s.device)
    gen = torch.Generator(s.device).manual_seed(C.subseed(s.seed, "program"))
    return RS.train(model, params, batches, lr=cfg["learning_rate"],
                    momentum=cfg["momentum"],
                    bn_names=fam.reference.batch_norms(cfg),
                    decay=cfg.get("batch_norm", {}).get("decay", 0.9), gen=gen,
                    recompute=bool(tr.get("reference_recompute", False)),
                    loss_rows=loss_rows)


def peak_bytes(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def windows(s, net, fit, data, first):
    """Warm-up, the window and (trace 1) the traced window, from pool
    batch `first` on. `s.agree(n)` makes every rank take the same step
    count, `s.barrier()` starts them together. Returns this rank's
    measurements."""
    tr, dev = s.cell.traffic, s.device
    n_pool = tr["pool_batches"]

    def order(start, n):
        return [(start + i) % n_pool for i in range(n)]

    w = tr["warmup_steps"]
    clock = T.StepClock(dev)
    net.set_listeners(clock)
    clock.start()
    fit(T.feed(data, tr, order(first, w), dev))
    sync(dev)
    step_ms = statistics.median(clock.step_ms())
    n = s.agree(max(1, math.ceil(1e3 * s.seconds / step_ms)))
    note(f"warm-up: {step_ms:.2f} ms a step, {n} steps to the window")
    start = first + w
    clock = T.StepClock(dev)
    net.set_listeners(clock)
    it = T.feed(data, tr, order(start, n), dev)
    setup_peak = peak_bytes(dev)
    reset_peak(dev)
    sync(dev)
    s.barrier()
    t0 = time.perf_counter()
    setup_s = process_age()
    clock.start()
    fit(it)
    sync(dev)
    t1 = time.perf_counter()
    window_peak = peak_bytes(dev)
    net.set_listeners()
    loss = net.score()
    rank = {"steps": n, "window_s": t1 - t0, "setup_s": setup_s,
            "data_wait_s": it.wait_s, "peak_window_bytes": window_peak,
            "peak_bytes": max(setup_peak, window_peak),
            "step_ms": clock.step_ms(), "loss_finite": math.isfinite(loss),
            "trace": None}
    if s.trace:
        k = tr["trace_steps"]
        it = T.feed(data, tr, order(start + n, k), dev)
        with profile.traced(dev) as box:
            fit(it)
        rank["trace"] = profile.summarize(profile.load_events(box[0]), k)
        rank["peak_bytes"] = max(rank["peak_bytes"], peak_bytes(dev))
    return rank


def measured(s, ranks, readings):
    """The run's measurements from every rank's (rank 0's first)."""
    cfg, tr = s.cell.config, s.cell.traffic
    r0 = ranks[0]
    n, window_s = r0["steps"], r0["window_s"]
    rows = T.global_batch(tr)
    products = s.cell.family.reference.products(cfg, tr["batch"])
    ctx = SimpleNamespace(
        phase="train", steps=n, window_s=window_s,
        flops_per_step=train_flops(products),
        peak_flops=PEAK_FLOPS[cfg["data_type"]], ranks=ranks)
    return {
        "e2e": {"train_samples_per_s": n * rows / window_s,
                "train_step_p95_ms": max(percentile(r["step_ms"], 95)
                                         for r in ranks),
                "setup_s": r0["setup_s"]},
        "ctx": ctx, "readings": readings, "attempted": n, "failed": 0,
        "finite": all(r["loss_finite"] for r in ranks),
        "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}


def run(s):
    """One run of a one-card training cell."""
    cfg, tr, fam = s.cell.config, s.cell.traffic, s.cell.family
    dev = s.device
    note("start")
    net = fam.build(cfg, C.subseed(s.seed, "program"), dev)
    note("network built")
    host = C.to_host(C.make_params(fam.reference.leaves(cfg), s.seed, dev))
    net.from_jax_params(fam.params_tree(cfg, host))
    note("weights loaded")
    data = T.pool(cfg, tr, s.seed, dev)
    note("pool drawn")
    prog = program_first_steps(s, net, net.fit, data, host)
    note("first steps read")
    del host
    rank = windows(s, net, net.fit, data, tr["check_steps"])
    note(f"window of {rank['steps']} steps closed")
    del net
    free()
    ref = reference_first_steps(s, data)
    note("reference done")
    out = measured(s, [rank], check.train_readings(prog, ref))
    out["first_steps"] = (prog, ref)
    return out


def planted(s, loss_rows):
    """A fault planted in the reference put in the program's place: its
    loss over the first `loss_rows` rows of each batch, read against the
    sound reference."""
    cfg, tr = s.cell.config, s.cell.traffic
    data = T.pool(cfg, tr, s.seed, s.device)
    bad = reference_first_steps(s, data, loss_rows=loss_rows)
    ref = reference_first_steps(s, data)
    return {"readings": check.train_readings(bad, ref),
            "first_steps": (bad, ref)}


def control(s):
    """The control's readings: the reference in float8 against itself in
    float32, on this run's inputs."""
    cfg, tr = s.cell.config, s.cell.traffic
    data = T.pool(cfg, tr, s.seed, s.device)
    low = reference_first_steps(s, data, C.Numerics("fp8"))
    ref = reference_first_steps(s, data)
    return {"readings": check.train_readings(low, ref),
            "first_steps": (low, ref)}
