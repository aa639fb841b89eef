"""Batch scoring through `evaluate` (ComputationGraph or
MultiLayerNetwork) over the port's AsyncDataSetIterator, one card.

The weights come from the seed; BatchNorm's running statistics are those
of a calibration batch drawn from the seed, worked out by the reference
(a training-mode forward), as a trained network's would be: both sides
get the same. Warm-up batches give the batch time, from which the
window's batch count is set to last `--seconds`; the window is one
`evaluate` call. Around the network's `output`, which `evaluate` calls
once a batch, a proxy keeps every served batch (and the warm-up's batch
times, from the host clock: `output` returns the probabilities on the
host). Once the program is
freed, the reference scores each image of the pool that the window
served, and every served probability is compared with its own.
"""
from __future__ import annotations

import math
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import check, profile, traffic as T
from ..flops import PEAK_FLOPS, forward_flops
from ..harness import note, process_age
from ..reference import common as C, steps as RS
from .fit import free, peak_bytes, reset_peak, sync


class Served:
    """Keeps every batch the network's `output` serves while armed, with
    the pool batch it came from (`evaluate` calls `output` once a batch,
    in the iterator's order)."""

    def __init__(self, net):
        self.net = net
        self.order = None
        self.kept = []
        self.times = []
        self._output = net.output
        net.output = self._serve

    def arm(self, order):
        self.order = order

    def disarm(self):
        self.order = None

    def _serve(self, *args, **kwargs):
        out = self._output(*args, **kwargs)
        self.times.append(time.perf_counter())
        if self.order is not None:
            probs = out[0] if isinstance(out, list) else out
            self.kept.append((self.order[len(self.kept)], np.array(probs)))
        return out

    def close(self):
        del self.net.output


def calibration(s, model, params):
    """BatchNorm's running statistics: the batch statistics of a
    calibration batch drawn from the seed."""
    cfg, tr, fam = s.cell.config, s.cell.traffic, s.cell.family
    names = fam.reference.batch_norms(cfg)
    if not names:
        return {}
    x, _ = C.image_pool(tr["calibration_rows"], cfg["height"], cfg["width"],
                        cfg["channels"], cfg["num_classes"], s.seed,
                        s.device, "calibration")
    x = C.images(torch.from_numpy(x).to(s.device))
    return RS.batch_statistics(model, params, x, names)


def run(s):
    """One run of a one-card scoring cell."""
    cfg, tr, fam = s.cell.config, s.cell.traffic, s.cell.family
    dev = s.device
    C.strict_f32()
    model = fam.reference.Model(cfg)
    params = C.make_params(fam.reference.leaves(cfg), s.seed, dev)
    running = calibration(s, model, params)
    note("calibrated")
    net = fam.build(cfg, C.subseed(s.seed, "program"), dev)
    net.from_jax_params(fam.params_tree(cfg, C.to_host(params)),
                        fam.state_tree(running))
    del params
    free()
    reset_peak(dev)
    note("network built, weights loaded")
    data = T.pool(cfg, tr, s.seed, dev)
    note("pool drawn")
    rows = tr["batch"]
    served = Served(net)
    n_pool = tr["pool_batches"]

    def order(start, n):
        return [(start + i) % n_pool for i in range(n)]

    w = tr["warmup_steps"]
    net.evaluate(T.feed(data, tr, order(0, w), dev))
    batch_s = statistics.median(b - a for a, b in zip(served.times,
                                                       served.times[1:]))
    n = max(1, math.ceil(s.seconds / batch_s))
    note(f"warm-up: {1e3 * batch_s:.2f} ms a batch, {n} batches to the "
         f"window")
    batches = order(w, n)
    it = T.feed(data, tr, batches, dev)
    setup_peak = peak_bytes(dev)
    reset_peak(dev)
    served.arm(batches)
    sync(dev)
    t0 = time.perf_counter()
    setup_s = process_age()
    ev = net.evaluate(it)
    sync(dev)
    t1 = time.perf_counter()
    served.disarm()
    window_peak = peak_bytes(dev)
    rank = {"steps": n, "window_s": t1 - t0, "setup_s": setup_s,
            "data_wait_s": it.wait_s, "peak_window_bytes": window_peak,
            "peak_bytes": max(setup_peak, window_peak), "trace": None}
    if s.trace:
        k = tr["trace_steps"]
        it = T.feed(data, tr, order(w + n, k), dev)
        with profile.traced(dev) as box:
            net.evaluate(it)
        rank["trace"] = profile.summarize(profile.load_events(box[0]), k)
        rank["peak_bytes"] = max(rank["peak_bytes"], peak_bytes(dev))
    counted = ev.num_examples
    served.close()
    kept = served.kept
    del net, served, it
    free()
    note("window closed")
    gaps = reference_gaps(s, data, kept, running)
    note("reference done")
    ctx = SimpleNamespace(
        phase="eval", steps=n, window_s=rank["window_s"],
        flops_per_step=forward_flops(fam.reference.products(cfg, rows)),
        peak_flops=PEAK_FLOPS[cfg["data_type"]], ranks=[rank])
    return {"e2e": {"eval_samples_per_s": n * rows / rank["window_s"],
                    "setup_s": setup_s},
            "ctx": ctx, "readings": gaps, "attempted": n,
            "failed": n - len(kept) + (0 if counted == n * rows else 1),
            "finite": all(np.isfinite(p).all() for _, p in kept),
            "memory_peak_bytes": rank["peak_bytes"]}


def reference_probabilities(s, data, batches, running, num=C.F32):
    """{pool batch: the reference's probabilities of its images}."""
    cfg, tr, fam = s.cell.config, s.cell.traffic, s.cell.family
    C.strict_f32()
    model = fam.reference.Model(cfg, num)
    params = C.make_params(fam.reference.leaves(cfg), s.seed, s.device)
    images = T.host_images(data, tr, sorted(set(batches)), s.device)
    return {j: RS.probabilities(model, params, x, running).cpu().numpy()
            for j, (x, _) in zip(sorted(set(batches)), images)}


def reference_gaps(s, data, kept, running):
    return check.scoring_readings(kept, reference_probabilities(
        s, data, [j for j, _ in kept], running))


def control(s):
    """The control's reading: the reference in float8 against itself in
    float32 over every image of the pool."""
    cfg, tr, fam = s.cell.config, s.cell.traffic, s.cell.family
    C.strict_f32()
    model = fam.reference.Model(cfg)
    params = C.make_params(fam.reference.leaves(cfg), s.seed, s.device)
    running = calibration(s, model, params)
    del params
    data = T.pool(cfg, tr, s.seed, s.device)
    pool = list(range(tr["pool_batches"]))
    low = reference_probabilities(s, data, pool, running, C.Numerics("fp8"))
    return {"readings": reference_gaps(s, data, sorted(low.items()),
                                       running)}
