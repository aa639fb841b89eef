"""Asynchronous parameter-server training.

Port of deeplearning4j_tpu/parallel/parameter_server.py (reference
ParameterServerParallelWrapper.java:39-160):

  * worker threads pull a parameter snapshot (possibly stale), compute
    GRADIENTS on it with the network's gradient function
    (`Network.make_grad_fn`), and push them to the accumulator,
    concurrently with other workers and with the accumulator's apply work;
  * the accumulator thread pops gradients and applies them to the master
    parameters with the updater half of the step (`make_apply_fn`), then
    publishes a new, version-tagged snapshot;
  * staleness (master version - snapshot version at apply time) is tracked;
    gradients staler than `max_staleness` are dropped (`stale_dropped`);
    the queue size bounds the gradients in flight; the layer state a
    worker's forward produced (BatchNorm's running statistics) is
    published last-writer-wins.

Where the reference's arrays are immutable, the port's updaters write the
parameters in place. So a published snapshot is a detached clone of the
masters, taken under the accumulator's lock, never the masters
themselves: a worker's gradient is computed on parameters that do not
change under it.

The worker threads are a pool that lives as long as the wrapper (or the
hook), not one set per fit: PyTorch keeps cuDNN's searched convolution
plans per thread, so a new thread searches every shape again (seconds for
ResNet-50). `close()` ends the pool.

On a card every worker thread computes on its own CUDA stream; the snapshot
(cloned on the apply thread's stream) and the pushed gradients cross
streams through events, and each tensor used on a stream other than the
one it was allocated on is marked with `record_stream`, so the caching
allocator never hands its memory out while that stream may still read it.
The host work of the threads interleaves under the interpreter lock; their
kernels may overlap on the device.

`ps_transport.PSServer` / `PSClient` put a TCP boundary under the same
pull and push, with this accumulator as the server's core.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import logging
import queue
import threading

import numpy as np
import torch

from ..datasets.dataset import DataSet
from ..datasets.iterators import ListDataSetIterator, next_processed

log = logging.getLogger(__name__)


def ps_batch(net, ds, rng):
    """The batch dict the gradient function consumes: the ONE definition of
    the PS batch contract (in-process workers, TrainingHook workers and the
    remote `ps_transport.ps_worker_fit` loop feed grad_fn the same way).
    `ds` is put on the network's device in its layout; `rng` is the
    dropout torch.Generator."""
    features, labels, fmask, lmask = net._batch(net._dataset(ds))
    return {"features": features, "labels": labels, "fmask": fmask,
            "lmask": lmask, "rng": rng}


def _ps_fns(net):
    """(grad_fn, apply_fn), made once per network and cached on it (the
    reference caches its jitted pair the same way)."""
    cached = getattr(net, "_ps_fns_cache", None)
    if cached is None:
        cached = (net.make_grad_fn(), net.make_apply_fn())
        net._ps_fns_cache = cached
    return cached


def batch_generator(net, *ids):
    """A dropout torch.Generator on the network's device, seeded from the
    network's seed and `ids` (e.g. round, worker, batch): the reference's
    fold_in of its PRNG key."""
    seed = np.random.SeedSequence([int(net._seed) & 0xFFFFFFFF]
                                  + [int(i) for i in ids]).generate_state(
        2, np.uint32)
    return torch.Generator(net.device).manual_seed(
        (int(seed[0]) << 31) ^ int(seed[1]))


def _clone(tree):
    return {key: {k: t.detach().clone() for k, t in per.items()}
            for key, per in tree.items()}


def _tensors(*trees):
    out = []
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            out.append(tree)
        elif isinstance(tree, dict):
            for per in tree.values():
                out.extend(per.values())
    return out


def _cross(tensors, ready, stream):
    """Order `stream` after the event `ready` and mark each tensor as used
    on it (a no-op off the card)."""
    if ready is None:
        return
    stream.wait_event(ready)
    for t in tensors:
        if t.is_cuda:
            t.record_stream(stream)


def _ready(device):
    """An event recorded on the caller's current stream (None off the
    card)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class GradientsAccumulator:
    """The PS core: gradient inbox + apply loop on the master parameters.
    reference: ParameterServerClient.pushNDArray / ParameterServerNode."""

    def __init__(self, net, queue_size=8, max_staleness=None):
        self.net = net
        net._ensure_init()
        self._device = net.device
        self._q = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._error = None
        self._applied = 0
        self._stale_dropped = 0
        # running aggregates, not a per-push history
        self._staleness_count = 0
        self._staleness_sum = 0
        self._staleness_max = 0
        self.max_staleness = max_staleness
        self._lock = threading.Lock()
        self._version = 0
        with self._lock:
            self._snapshot = self._publish()
        self._apply_fn = _ps_fns(net)[1]
        self._thread = threading.Thread(target=self._apply_loop, daemon=True)
        self._thread.start()

    def _publish(self):
        """(params, model_state, version, ready event): clones of the
        masters and the layer state (called under the lock)."""
        net = self.net
        return (_clone(net._params), _clone(net._states()), self._version,
                _ready(self._device))

    # -- worker side ---------------------------------------------------
    def snapshot_params(self):
        """Latest published (params, model_state, version): the PS 'pull'.
        On a card the caller's current stream is ordered after the
        snapshot's copy."""
        params, state, version, ready = self._snapshot
        if ready is not None:
            _cross(_tensors(params, state), ready,
                   torch.cuda.current_stream(self._device))
        return params, state, version

    def push_gradients(self, grads, score, version, model_state=None):
        """The PS 'push': enqueue gradients (and the layer state the
        worker's forward produced) computed against snapshot `version`.
        Blocks while the inbox is full. Raises if the accumulator died.
        Returns True when enqueued, False when the accumulator had already
        stopped (a transport must not ack that push)."""
        item = (grads, score, version, model_state, _ready(self._device))
        while True:
            if self._error is not None:
                raise self._error
            if self._stop.is_set():
                return False
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue

    # -- accumulator side ----------------------------------------------
    def _apply_loop(self):
        net = self.net
        try:
            while not self._stop.is_set() or not self._q.empty():
                try:
                    grads, score, version, mstate, ready = self._q.get(
                        timeout=0.05)
                except queue.Empty:
                    continue
                staleness = self._version - version
                self._staleness_count += 1
                self._staleness_sum += staleness
                self._staleness_max = max(self._staleness_max, staleness)
                if (self.max_staleness is not None
                        and staleness > self.max_staleness):
                    self._stale_dropped += 1
                    continue
                if ready is not None:
                    _cross(_tensors(grads, mstate, score), ready,
                           torch.cuda.current_stream(self._device))
                with self._lock:
                    _, net._updater_state = self._apply_fn(
                        net._params, net._updater_state, grads,
                        net.conf.iteration_count)
                    if mstate is not None:
                        # last-writer-wins layer state (BN running stats)
                        net._store_state(mstate)
                    net._score = score
                    net.conf.iteration_count += 1
                    self._applied += 1
                    self._version += 1
                    self._snapshot = self._publish()
        except Exception as e:  # record + unblock producers, re-raise at join
            log.exception("parameter-server apply loop failed")
            self._error = e
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass

    def applied_count(self):
        return self._applied

    def stats(self):
        n = self._staleness_count
        return {
            "applied": self._applied,
            "stale_dropped": self._stale_dropped,
            "max_staleness_seen": self._staleness_max,
            "mean_staleness": (self._staleness_sum / n) if n else 0.0,
        }

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=60)
        if self._error is not None:
            raise self._error


class _ThreadStream(threading.local):
    """A worker thread's own CUDA stream, made at its first batch."""
    stream = None


_streams = _ThreadStream()


@contextlib.contextmanager
def _worker_stream(device):
    """This worker thread's own CUDA stream, ordered after the default
    stream's work so far (batches staged before the round started);
    nothing off the card."""
    if device.type != "cuda":
        yield
        return
    stream = _streams.stream
    if stream is None or stream.device != device:
        stream = _streams.stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.default_stream(device))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def worker_pool(n):
    """The pool of n worker threads a wrapper or a hook keeps."""
    return cf.ThreadPoolExecutor(max_workers=n,
                                 thread_name_prefix="ps-worker")


def run_workers(net, acc, shards, round_id, pool, hook=None):
    """Train `shards` (one list of DataSets per worker) on the threads of
    `pool` against `acc`: each worker pulls a snapshot, computes gradients
    and pushes them (the hook's pre/post_update around each batch).
    Re-raises the first worker error once every worker has ended."""
    grad_fn = _ps_fns(net)[0]

    def worker(w, batches):
        try:
            with _worker_stream(net.device):
                for j, ds in enumerate(batches):
                    if hook is not None:
                        hook.pre_update(ds, net)
                    params, state, version = acc.snapshot_params()
                    batch = ps_batch(net, ds,
                                     batch_generator(net, round_id, w, j))
                    grads, score, new_state, _ = grad_fn(params, state, batch)
                    acc.push_gradients(grads, score, version, new_state)
                    if hook is not None:
                        hook.post_update(ds, net)
        except Exception:
            log.exception("parameter-server worker %d failed", w)
            raise

    futures = [pool.submit(worker, w, s) for w, s in enumerate(shards) if s]
    cf.wait(futures)
    for f in futures:
        f.result()


class ParameterServerParallelWrapper:
    """reference: ParameterServerParallelWrapper.java: Builder mirrors the
    reference (workers, queue size)."""

    class Builder:
        def __init__(self, model):
            self.model = model
            self._workers = 2
            self._queue_size = 8
            self._max_staleness = None

        def workers(self, n):
            self._workers = int(n); return self

        def queue_size(self, n):
            self._queue_size = int(n); return self

        queueSize = queue_size

        def max_staleness(self, n):
            self._max_staleness = None if n is None else int(n); return self

        maxStaleness = max_staleness

        def build(self):
            return ParameterServerParallelWrapper(
                self.model, self._workers, self._queue_size,
                self._max_staleness)

    def __init__(self, model, workers=2, queue_size=8, max_staleness=None):
        self.model = model
        model._ensure_init()
        self.workers = int(workers)
        self.queue_size = int(queue_size)
        self.max_staleness = max_staleness
        self.last_stats = None
        self._rounds = 0
        self._pool = None

    def close(self):
        """End the worker threads (a later fit starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def fit(self, data, num_epochs=1):
        if isinstance(data, DataSet):
            data = ListDataSetIterator(list(data.batch_by(
                max(1, data.num_examples() // self.workers))))
        net = self.model
        if self._pool is None:
            self._pool = worker_pool(self.workers)
        acc = GradientsAccumulator(net, self.queue_size, self.max_staleness)
        try:
            for _ in range(num_epochs):
                data.reset()
                shards = [[] for _ in range(self.workers)]
                i = 0
                while data.has_next():
                    shards[i % self.workers].append(next_processed(data))
                    i += 1
                self._rounds += 1
                run_workers(net, acc, shards, self._rounds, self._pool)
        finally:
            acc.shutdown()
            self.last_stats = acc.stats()
        return net
