"""The one generator of the benchmark's traffic, and the instruments the
loops put around the program's iterator protocol.

A traffic file (`traffic/<name>.json`) gives a pool: `pool_batches`
distinct batches of `batch` rows (times `ranks` for a data-parallel
global batch), uniform uint8 pixels and uniform classes, drawn on the
device from the run's seed and kept on the host; the loops cycle through
it. The feed (`feed`) is the port's `AsyncDataSetIterator` with the
given pre-processing on the card, wire type, queue and staging workers.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import torch

from .reference import common as C


def pool(config, traffic, seed, device, tag="data"):
    """(uint8 NHWC pixels, one-hot labels) of the whole pool."""
    rows = traffic["batch"] * traffic.get("ranks", 1)
    return C.image_pool(rows * traffic["pool_batches"], config["height"],
                        config["width"], config["channels"],
                        config["num_classes"], seed, device, tag)


def global_batch(traffic):
    return traffic["batch"] * traffic.get("ranks", 1)


def pool_iterator(data, traffic, order):
    """A DataSetIterator over the pool's batches `order` (indices into the
    pool), in that order; reset() starts it again."""
    from deeplearning4j_tpu_torch.datasets import DataSet, DataSetIterator

    rows = global_batch(traffic)
    x, y = data

    class PoolIterator(DataSetIterator):
        def __init__(self):
            self.pos = 0

        def has_next(self):
            return self.pos < len(order)

        def next_batch(self):
            j = order[self.pos]
            self.pos += 1
            return DataSet(x[j * rows:(j + 1) * rows],
                           y[j * rows:(j + 1) * rows])

        def reset(self):
            self.pos = 0

        def batch(self):
            return rows

    return PoolIterator()


_CORES = []


def physical_cores():
    """One CPU of each physical core the process may run on, as it started
    (read once, before any thread is pinned)."""
    if not _CORES:
        seen = set()
        for cpu in sorted(os.sched_getaffinity(0)):
            try:
                core = Path(f"/sys/devices/system/cpu/cpu{cpu}/topology/"
                            "thread_siblings_list").read_text().strip()
            except OSError:
                core = str(cpu)
            if core not in seen:
                seen.add(core)
                _CORES.append(cpu)
    return _CORES


def pinned(make):
    """`make()` (which starts the feed's staging threads) with the staging
    threads on one physical core and the calling thread, which launches
    the steps, on another, so that neither shares a core with the other
    or moves. Threads started before keep the whole machine."""
    cores = physical_cores()
    if len(cores) < 2:
        return make()
    os.sched_setaffinity(0, {cores[-2]})
    try:
        return make()
    finally:
        os.sched_setaffinity(0, {cores[-1]})


def feed(data, traffic, order, device):
    """The port's AsyncDataSetIterator over `pool_iterator`, as the traffic
    file configures it, with the host's wait in each `next()` summed in
    `wait_s` (and marked `portbench.data_wait` in a trace). With
    `pin_threads`, its staging threads and the calling thread are pinned
    (`pinned`)."""
    from deeplearning4j_tpu_torch.datasets import (AsyncDataSetIterator,
                                                   ImagePreProcessingScaler)
    from torch.profiler import record_function

    transforms = {"ImagePreProcessingScaler": ImagePreProcessingScaler}

    class TimedFeed(AsyncDataSetIterator):
        wait_s = 0.0
        taken = 0

        def next(self):
            t0 = time.perf_counter()
            with record_function("portbench.data_wait"):
                ds = super().next()
            self.wait_s += time.perf_counter() - t0
            self.taken += 1
            return ds

    transform = traffic.get("device_transform")

    def make():
        return TimedFeed(pool_iterator(data, traffic, order),
                         queue_size=traffic["queue_size"],
                         transfer_dtype=traffic.get("transfer_dtype"),
                         device_transform=(transforms[transform]()
                                           if transform else None),
                         num_workers=traffic["num_workers"],
                         cast_labels=False, device=device)
    return pinned(make) if traffic.get("pin_threads") else make()


class StepClock:
    """An iteration listener that marks the end of each step the network
    reports: a CUDA event recorded on the training stream (on the CPU, the
    host clock)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def start(self):
        self._mark()

    def iteration_done(self, net, iteration):
        self._mark()

    def step_ms(self):
        """Each step's ms (on the card, once the window synchronised)."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [1e3 * (b - a) for a, b in pairs]


def host_images(data, traffic, batches, device):
    """The pool's batches `batches` as the reference's float32 NCHW
    images and labels on `device`."""
    rows = global_batch(traffic)
    x, y = data
    out = []
    for j in batches:
        xs = torch.from_numpy(x[j * rows:(j + 1) * rows]).to(device)
        ys = torch.from_numpy(y[j * rows:(j + 1) * rows]).to(device)
        out.append((C.images(xs), ys))
    return out
