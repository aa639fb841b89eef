"""DataSetIterator family: port of deeplearning4j_tpu/datasets/iterators.py.

The iterator protocol and every iterator are the reference's, on numpy.
`AsyncDataSetIterator` (the reference's background prefetch, which stages
the next batch with `jax.device_put` while the current step runs) stages
on CUDA streams here:

  host batch -> wire cast (`transfer_dtype`; a torch bf16 tensor, since
  numpy has no bf16) -> `pin_memory()` -> a non-blocking copy on a side
  `torch.cuda.Stream` owned by the staging thread -> `device_transform`
  on that stream -> an event recorded after both.

The consumer (`next_batch`, on the caller's thread) makes its current
stream wait on that event and calls `record_stream` on every staged
tensor before handing the batch out: each was allocated on the side
stream and is used on another, and without it the caching allocator
could give its block to the next staged batch while the step still reads
it.

Staged batches hold tensors in the public layout (NHWC images); the
containers take them as the port's channels_last NCHW view without a
copy (`common.device.to_port`). `device=None` stages to the card and
raises without one; pass device="cpu" to stage to the CPU.
"""
from __future__ import annotations

import concurrent.futures as cf
import queue
import threading

import numpy as np
import torch

from ..common.device import card_numerics, resolve_device
from ..optimize import profiler as P
from .dataset import DataSet, MultiDataSet


def _apply_pre(pre, ds):
    """Run one pre-processor (normalizer / callable / CombinedPreProcessor)
    on a SHALLOW COPY of the batch: normalizer transforms rebind
    ds.features, and cached-batch iterators hand out the same DataSet
    objects every epoch, so transforming in place would double-normalize
    from epoch 2 on."""
    if pre is None:
        return ds
    ds = ds.shallow_copy()
    out = pre.pre_process(ds) if hasattr(pre, "pre_process") else pre(ds)
    return ds if out is None else out


def next_processed(it):
    """The next batch through the iterator's pre-processor-applying path
    when it has one (DataSetIterator.next()); duck-typed iterators without
    next() give their raw next_batch()."""
    nxt = getattr(it, "next", None)
    return nxt() if callable(nxt) else it.next_batch()


def wrap_async_for_fit(it, compute_dtype, queue_size=2, device=None):
    """fit()'s auto-wrap policy, shared by MultiLayerNetwork and
    ComputationGraph: async prefetch staged to the network's `device`, and
    for bf16 networks a bf16 FEATURE wire (bit-identical training: the step
    casts features to bf16 anyway), labels and masks at full precision."""
    if isinstance(it, AsyncDataSetIterator):
        return it
    wire = "bfloat16" if compute_dtype == torch.bfloat16 else None
    return AsyncDataSetIterator(it, queue_size=max(2, int(queue_size)),
                                transfer_dtype=wire, cast_labels=False,
                                device=resolve_device(device))


class BatchValidationError(ValueError):
    """A batch failed DataSetValidator checks under the 'raise' policy."""


def inject_features(injector, site, ds):
    """Fire `site` with the batch's (first) feature array as the payload;
    when a planned `corrupt` rule hands back a poisoned copy, rebind it onto
    a shallow copy of the DataSet (the source batch is never mutated)."""
    if injector is None:
        return ds
    feats = ds.features
    multi = isinstance(feats, (list, tuple))
    arr = feats[0] if multi else feats
    out = injector.fire(site, payload=arr)
    if out is arr:
        return ds
    ds = ds.shallow_copy()
    ds.features = [out] + list(feats[1:]) if multi else out
    return ds


class DataSetValidator:
    """Batch validation at the iterator boundary: shape, dtype and
    finiteness checks with a corrupt-record policy: 'raise' (the default),
    'skip' (drop the batch and count it) or 'count' (let it through,
    counted). `fault_injector` fires the site "data.batch" on every batch's
    features before validation. Works standalone (`validate`), wrapped
    (`ValidatingDataSetIterator`) or on the staging threads
    (`AsyncDataSetIterator(..., validator=...)`)."""

    def __init__(self, policy="raise", check_finite=True,
                 feature_shape=None, label_shape=None, dtypes=None,
                 fault_injector=None, site="data.batch",
                 health_policy=None):
        if policy not in ("raise", "skip", "count"):
            raise ValueError(f"policy must be raise/skip/count, "
                             f"got {policy!r}")
        self.policy = policy
        self.check_finite = bool(check_finite)
        self.feature_shape = (None if feature_shape is None
                              else tuple(feature_shape))
        self.label_shape = (None if label_shape is None
                            else tuple(label_shape))
        self.dtypes = dtypes            # allowed numpy dtype kinds, e.g. "f"
        self.fault_injector = fault_injector
        self.site = site
        self.health_policy = health_policy
        # the staging pool's threads validate concurrently
        self._lock = threading.Lock()
        self.rejected = 0
        self.passed = 0
        self.last_error = None

    def _problem(self, ds):
        feats, labs = ds.features, getattr(ds, "labels", None)
        if feats is None:
            return "batch has no features"
        flist = list(feats) if isinstance(feats, (list, tuple)) else [feats]
        llist = (list(labs) if isinstance(labs, (list, tuple))
                 else ([labs] if labs is not None else []))
        n = np.asarray(flist[0]).shape[0] if np.asarray(flist[0]).ndim else 0
        for a in flist:
            a = np.asarray(a)
            if a.ndim == 0 or a.shape[0] != n:
                return (f"feature batch dims disagree: {a.shape} vs "
                        f"leading {n}")
            if self.dtypes is not None and a.dtype.kind not in self.dtypes:
                return (f"feature dtype {a.dtype} not in allowed kinds "
                        f"{self.dtypes!r}")
            if (self.feature_shape is not None
                    and tuple(a.shape[1:]) != self.feature_shape):
                return (f"feature shape {tuple(a.shape[1:])} != expected "
                        f"{self.feature_shape}")
        for a in llist:
            if a is None:
                continue
            a = np.asarray(a)
            if a.ndim == 0 or a.shape[0] != n:
                return (f"label batch size {a.shape} disagrees with "
                        f"features ({n})")
            if (self.label_shape is not None
                    and tuple(a.shape[1:]) != self.label_shape):
                return (f"label shape {tuple(a.shape[1:])} != expected "
                        f"{self.label_shape}")
        if self.check_finite:
            masks = [getattr(ds, k, None) for k in
                     ("features_mask", "labels_mask")]
            for mk in ("features_masks", "labels_masks"):
                ms = getattr(ds, mk, None)
                if ms:
                    masks.extend(ms)
            for a in flist + llist + masks:
                if a is None:
                    continue
                a = np.asarray(a)
                if a.dtype.kind == "f" and not np.isfinite(a).all():
                    bad = int(a.size - np.isfinite(a).sum())
                    return f"non-finite values in batch ({bad} elements)"
        return None

    def validate(self, ds, batch_index=None):
        """The (possibly injector-poisoned) batch, or None when it was
        rejected under 'skip'. Raises BatchValidationError under 'raise'."""
        ds = inject_features(self.fault_injector, self.site, ds)
        problem = self._problem(ds)
        if problem is None:
            with self._lock:
                self.passed += 1
            return ds
        with self._lock:
            self.rejected += 1
            self.last_error = problem
        if self.health_policy is not None:
            self.health_policy.record_validation_reject(
                problem, batch_index=batch_index)
        if self.policy == "raise":
            raise BatchValidationError(
                f"corrupt batch rejected: {problem}")
        if self.policy == "skip":
            return None
        return ds                       # 'count': pass through, counted


def _carry_metas(src, dst):
    """Per-example metadata (`example_metas`, Evaluation's error-analysis
    channel) survives every batch rebuild in the staging pipeline."""
    metas = getattr(src, "example_metas", None)
    if metas is not None:
        dst.example_metas = metas
    return dst


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32, "float64": torch.float64}


def _torch_dtype(dt):
    return dt if isinstance(dt, torch.dtype) else _TORCH_DTYPES[str(dt)]


def _to_bf16(t):
    """float -> bf16 as the reference's ml_dtypes cast: float64 rounds to
    float32 first, then to nearest bf16, ties to even (torch's rounding);
    a NaN becomes the quiet NaN 0x7FC0 with its sign (torch's vectorised
    cast may give another NaN pattern)."""
    if t.dtype == torch.float64:
        t = t.float()
    out = t.to(torch.bfloat16)
    nan = torch.isnan(t)
    if bool(nan.any()):
        canon = torch.where(torch.signbit(t), -0x40, 0x7FC0).to(torch.int16)
        out = torch.where(nan, canon, out.view(torch.int16)).view(
            torch.bfloat16)
    return out


def _wire_caster(transfer_dtype):
    """Array cast for the host->device wire: floats shrink to
    transfer_dtype (for bf16 a torch tensor, since numpy has none); ints
    (uint8 pixels, token ids) and bool masks are already compact and pass
    through."""
    dt = _torch_dtype(transfer_dtype)

    def cast(a):
        if a is None:
            return None
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            if a.dtype.kind != "f":
                return a
            a = torch.from_numpy(np.ascontiguousarray(a))
        if not a.is_floating_point():
            return a
        return _to_bf16(a) if dt == torch.bfloat16 else a.to(dt)

    return cast


class DataSetIterator:
    """Iterator protocol. Subclasses implement next_batch()/reset()/has_next().

    `next()` = next_batch() + the attached pre-processor; all framework
    consumers (fit/evaluate loops) go through next()."""

    def has_next(self):
        raise NotImplementedError

    def next_batch(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def batch(self):
        return -1

    def total_outcomes(self):
        return -1

    def input_columns(self):
        return -1

    pre_processor = None

    def set_pre_processor(self, p):
        """Attach a pre-processor applied by next(). It receives a shallow
        copy of the batch and must REBIND fields (``ds.features = scaled``),
        never transform arrays in place: the copy shares its arrays with
        cached batches that are handed out again every epoch."""
        self.pre_processor = p
        return self

    setPreProcessor = set_pre_processor

    def next(self):
        """next_batch() with the attached pre-processor applied."""
        return _apply_pre(self.pre_processor, self.next_batch())

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()


class ValidatingDataSetIterator(DataSetIterator):
    """Wrap any DataSetIterator with a DataSetValidator. Under 'skip'
    rejected batches vanish from the stream (has_next looks ahead past
    them); 'raise' surfaces on next()/has_next; 'count' passes everything.
    The underlying iterator's pre-processor runs first."""

    def __init__(self, underlying, validator):
        self.underlying = underlying
        self.validator = validator
        self._pending = None
        self._index = 0

    def _advance(self):
        while self._pending is None and self.underlying.has_next():
            ds = self.validator.validate(next_processed(self.underlying),
                                         batch_index=self._index)
            self._index += 1
            if ds is not None:
                self._pending = ds

    def has_next(self):
        self._advance()
        return self._pending is not None

    def next_batch(self):
        self._advance()
        if self._pending is None:
            raise StopIteration("iterator exhausted")
        b, self._pending = self._pending, None
        return b

    def reset(self):
        self.underlying.reset()
        self._pending = None
        self._index = 0

    def batch(self):
        return self.underlying.batch()

    def total_outcomes(self):
        return self.underlying.total_outcomes()


class FileDataSetIterator(DataSetIterator):
    """Streams DataSets saved with DataSet.save(), one file per batch."""

    def __init__(self, paths):
        self.paths = [str(p) for p in paths]
        self._i = 0

    def has_next(self):
        return self._i < len(self.paths)

    def next_batch(self):
        ds = DataSet.load(self.paths[self._i])
        self._i += 1
        return ds

    def reset(self):
        self._i = 0


class ListDataSetIterator(DataSetIterator):
    """Iterate over a list of pre-batched DataSets (or one DataSet split
    into `batch_size` batches)."""

    def __init__(self, dataset_or_list, batch_size=None):
        if isinstance(dataset_or_list, DataSet):
            if batch_size is None:
                batch_size = dataset_or_list.num_examples()
            self._batches = list(dataset_or_list.batch_by(batch_size))
        else:
            self._batches = list(dataset_or_list)
        self._batch_size = batch_size or (
            self._batches[0].num_examples() if self._batches else 0)
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._batches)

    def next_batch(self):
        b = self._batches[self._pos]
        self._pos += 1
        return b

    def reset(self):
        self._pos = 0

    def batch(self):
        return self._batch_size

    def total_outcomes(self):
        b = self._batches[0]
        return int(b.labels.shape[-1]) if b.labels is not None else -1


class IteratorDataSetIterator(DataSetIterator):
    """Wrap a python iterable (or a factory of one) of DataSets."""

    def __init__(self, make_iter):
        self._make = make_iter if callable(make_iter) else (
            lambda: iter(list(make_iter)))
        self._it = self._make()
        self._next = None
        self._advance()

    def _advance(self):
        try:
            self._next = next(self._it)
        except StopIteration:
            self._next = None

    def has_next(self):
        return self._next is not None

    def next_batch(self):
        b = self._next
        self._advance()
        return b

    def reset(self):
        self._it = self._make()
        self._advance()


class MultipleEpochsIterator(DataSetIterator):
    """Repeat an underlying iterator N epochs."""

    def __init__(self, num_epochs, underlying):
        self.num_epochs = int(num_epochs)
        self.underlying = underlying
        self._epoch = 0

    def has_next(self):
        if self.underlying.has_next():
            return True
        if self._epoch + 1 < self.num_epochs:
            self._epoch += 1
            self.underlying.reset()
            return self.underlying.has_next()
        return False

    def next_batch(self):
        # through the underlying's pre-processor-applying path
        return next_processed(self.underlying)

    def reset(self):
        self._epoch = 0
        self.underlying.reset()

    def batch(self):
        return self.underlying.batch()


class SamplingDataSetIterator(DataSetIterator):
    """Random-with-replacement sampling from a DataSet (numpy's generator,
    seeded as the reference's)."""

    def __init__(self, dataset, batch_size, total_samples, seed=42):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.total = int(total_samples)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._emitted = 0

    def has_next(self):
        return self._emitted < self.total

    def next_batch(self):
        n = self.dataset.num_examples()
        idx = self._rng.integers(0, n, size=self.batch_size)
        self._emitted += self.batch_size
        return DataSet(self.dataset.features[idx],
                       self.dataset.labels[idx]
                       if self.dataset.labels is not None else None)

    def reset(self):
        self._emitted = 0
        self._rng = np.random.default_rng(self._seed)

    def batch(self):
        return self.batch_size


class _Staging(threading.local):
    """The staging thread's own side stream (one per thread)."""
    stream = None


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch that stages the next batch on `device`
    while the current step runs (the module docstring gives the stream
    protocol). The underlying iterator's pre-processor runs on the
    prefetch thread.

    * ``transfer_dtype``: cast float features (and, with cast_labels=True,
      labels and masks) on the host to this dtype (typically
      ``bfloat16``) before the copy: half the wire bytes, exact for bf16
      networks, whose step casts inputs anyway.
    * ``device_transform``: a function on tensors applied on the card to
      the staged features (a Normalizer's `as_device_transform()`, or the
      Normalizer itself), so the wire can carry raw uint8 pixels.
    * ``num_workers`` > 1 prepares and stages batches on a pool; order is
      kept (futures are collected FIFO).

    The consumer's blocking take in ``next_batch`` (the queue's get and
    the hand-over to the consumer's stream) is the program span
    ``data.wait`` (`optimize.profiler.span`: recorded while a profiler
    runs); each take also sets the registry's
    ``data.async_iterator.queue_depth`` gauge and counts
    ``data.async_iterator.batches``.
    """

    def __init__(self, underlying, queue_size=2, device_put=True,
                 transfer_dtype=None, device_transform=None, num_workers=1,
                 cast_labels=True, validator=None, device=None):
        self.underlying = underlying
        self.queue_size = max(1, int(queue_size))
        self._device_put = device_put
        self._device = resolve_device(device) if device_put else None
        self._transfer_dtype = transfer_dtype
        # runs on the prefetch thread after the pre-processors and before
        # the wire cast: a 'skip'-rejected batch never reaches the queue
        self._validator = validator
        # cast_labels=False shrinks FEATURES only: labels can matter at
        # full precision (regression targets)
        self._cast_labels = bool(cast_labels)
        if device_transform is not None and not device_put:
            raise ValueError(
                "device_transform requires device_put=True (the transform "
                "runs on the staged device array)")
        if device_transform is not None and not callable(device_transform):
            device_transform = device_transform.as_device_transform()
        self._device_fn = device_transform
        self._staging = _Staging()
        self.num_workers = max(1, int(num_workers))
        self._q = None
        self._thread = None
        self._sentinel = object()
        self._start()

    def _start(self):
        self._q = queue.Queue(maxsize=self.queue_size)
        self._error = None
        self._consumed_any = False
        old_pool = getattr(self, "_pool", None)
        if old_pool is not None:
            # reset() re-runs _start() every epoch: reclaim the previous
            # epoch's staging threads
            old_pool.shutdown(wait=False)
            self._pool = None
        # per-generation stop event: reset() signals the old generation's
        # threads to exit before the underlying iterator is reset
        old_stop = getattr(self, "_stop", None)
        if old_stop is not None:
            old_stop.set()
        self._stop = threading.Event()
        if self.num_workers == 1:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        else:
            # the producer submits prepare+stage jobs to a pool; the
            # collector drains the future queue FIFO, so order is kept
            self._pool = cf.ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="async-ds-stage")
            self._futs = queue.Queue(maxsize=self.queue_size
                                     + self.num_workers)
            # joinable: reset() waits for an in-flight next_batch() before
            # it touches the (non-thread-safe) underlying iterator
            self._producer_thread = threading.Thread(
                target=self._producer, args=(self._futs, self._stop),
                daemon=True)
            self._producer_thread.start()
            self._thread = threading.Thread(
                target=self._collector, args=(self._futs, self._stop),
                daemon=True)
            self._thread.start()
        self._next = self._q.get()
        self._raise_if_failed()

    def _prepare(self, ds):
        """Per-batch work: pre-process (the underlying iterator's, then this
        iterator's own), validate, wire-cast, stage."""
        ds = _apply_pre(getattr(self.underlying, "pre_processor", None), ds)
        ds = _apply_pre(self.pre_processor, ds)
        if self._validator is not None:
            ds = self._validator.validate(ds)
            if ds is None:          # rejected under the 'skip' policy
                return None
        if self._transfer_dtype is not None:
            ds = self._cast_for_wire(ds)
        if self._device_put:
            ds = self._stage(ds)
        return ds

    def _worker(self):
        stop = self._stop      # THIS generation's stop event
        try:
            while not stop.is_set() and self.underlying.has_next():
                item = self._prepare(self.underlying.next_batch())
                if item is None:
                    continue           # validator-skipped batch
                # stop-aware put: a mid-stream reset stops staging within
                # one batch
                while not stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # re-raised on the consumer thread
            self._error = e
        finally:
            self._q.put(self._sentinel)

    @staticmethod
    def _put_control(futs, stop, item):
        """Stop-aware blocking put for control items (a mid-stream
        exception, the end sentinel): one timed attempt under a full queue
        would drop the item and leave the collector blocked forever,
        turning a data error into a hang. Retry until it lands or the
        generation stops (a dead collector has already drained `futs`)."""
        while not stop.is_set():
            try:
                futs.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _producer(self, futs, stop):
        try:
            while not stop.is_set() and self.underlying.has_next():
                # next_batch() stays on ONE thread; only prepare/stage fans
                # out
                ds = self.underlying.next_batch()
                fut = self._pool.submit(self._prepare, ds)
                while not stop.is_set():
                    try:
                        futs.put(fut, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced by the collector
            self._put_control(futs, stop, e)
        finally:
            self._put_control(futs, stop, self._sentinel)

    def _collector(self, futs, stop):
        try:
            while not stop.is_set():
                # a timed get: a stopped producer may exit without a
                # sentinel
                try:
                    fut = futs.get(timeout=0.2)
                except queue.Empty:
                    continue
                if fut is self._sentinel:
                    break
                if isinstance(fut, BaseException):
                    raise fut
                res = fut.result()
                if res is None:
                    continue           # validator-skipped batch
                self._q.put(res)
        except BaseException as e:
            self._error = e
            stop.set()            # unblock the producer's bounded put
            while True:           # drain so its in-flight put releases
                try:
                    futs.get_nowait()
                except queue.Empty:
                    break
        finally:
            self._q.put(self._sentinel)

    def _cast_for_wire(self, ds):
        if isinstance(ds, MultiDataSet):
            # a plain DataSetIterator may yield MultiDataSets
            return AsyncMultiDataSetIterator._cast_for_wire(self, ds)
        cast = _wire_caster(self._transfer_dtype)
        keep = (lambda a: a) if not self._cast_labels else cast
        out = DataSet.__new__(DataSet)
        out.features = cast(ds.features)
        out.labels = keep(ds.labels)
        out.features_mask = keep(ds.features_mask)
        out.labels_mask = keep(ds.labels_mask)
        _carry_metas(ds, out)
        return out

    def _raise_if_failed(self):
        if self._next is self._sentinel and self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("prefetch worker failed") from err

    # -- staging ---------------------------------------------------------
    def _side_stream(self):
        st = self._staging
        if st.stream is None:
            st.stream = torch.cuda.Stream(self._device)
        return st.stream

    def _put(self, a):
        """One array (numpy or tensor) onto the device. On the card: from
        pinned host memory, without blocking the host, on the current
        (side) stream."""
        if a is None:
            return None
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if self._device.type != "cuda" or t.is_cuda:
            return t.to(self._device)
        return t.pin_memory().to(self._device, non_blocking=True)

    def _transform(self, t):
        with card_numerics(self._device, torch.float32):
            return self._device_fn(t)

    def _staged(self, ds, fill):
        """Run fill(put, transform) on the side stream; mark the batch with
        the event its consumer waits on."""
        if self._device.type != "cuda":
            fill(self._put, self._transform)
            return ds
        stream = self._side_stream()
        with torch.cuda.device(self._device), torch.cuda.stream(stream):
            fill(self._put, self._transform)
            ready = torch.cuda.Event()
            ready.record(stream)
        ds._staged_ready = ready
        return ds

    def _stage(self, ds):
        if isinstance(ds, MultiDataSet):
            return AsyncMultiDataSetIterator._stage(self, ds)
        staged = DataSet.__new__(DataSet)

        def fill(put, transform):
            staged.features = put(ds.features)
            if self._device_fn is not None:
                # on the side stream, overlapping the current step as the
                # copy does
                staged.features = transform(staged.features)
            staged.labels = put(ds.labels)
            staged.features_mask = put(ds.features_mask)
            staged.labels_mask = put(ds.labels_mask)

        self._staged(staged, fill)
        _carry_metas(ds, staged)
        return staged

    def _hand_over(self, b):
        """Order the consumer's stream after the batch's staging, and tell
        the allocator each staged tensor is used on that stream."""
        ready = b.__dict__.pop("_staged_ready", None)
        if ready is None:
            return b
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(ready)
        for t in _tensors(b):
            if t.is_cuda:
                t.record_stream(consumer)
        return b

    def has_next(self):
        self._raise_if_failed()
        return self._next is not self._sentinel

    def next_batch(self):
        b = self._next
        if b is self._sentinel:
            self._raise_if_failed()
            raise StopIteration("iterator exhausted")
        self._consumed_any = True
        with P.span("data.wait"):
            self._next = self._q.get()
            # the staging-queue depth after the take (0 while the loop is
            # fast means the loop is data-starved; full means
            # compute-bound), on the shared registry; resolved once, at the
            # first batch
            obs = getattr(self, "_obs_metrics", None)
            if obs is None:
                from ..obs.registry import default_registry
                reg = default_registry()
                obs = self._obs_metrics = (
                    reg.gauge("data.async_iterator.queue_depth"),
                    reg.counter("data.async_iterator.batches"))
            obs[0].set(self._q.qsize())
            obs[1].inc()
            return self._hand_over(b)

    def next(self):
        # the pre-processors already ran on the prefetch thread
        return self.next_batch()

    def __iter__(self):
        # a fresh wrapper is already prefetching from position 0: reset
        # only after a batch was consumed, or when the stream is exhausted
        if self._consumed_any or not self.has_next():
            self.reset()
        while self.has_next():
            yield self.next()

    def set_pre_processor(self, p):
        # the prefetch worker has already prepared batches without it
        raise RuntimeError(
            "set_pre_processor on a running AsyncDataSetIterator would "
            "miss already-prefetched batches; attach the pre-processor "
            "to the underlying iterator before wrapping")

    def reset(self):
        # stop the current generation BEFORE draining, so at most the
        # in-flight batches are staged for nothing
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()
        while self._next is not self._sentinel:
            self._next = self._q.get()
        # multi-worker: the producer may still be inside
        # underlying.next_batch() when the drain completes
        pt = getattr(self, "_producer_thread", None)
        if pt is not None and pt.is_alive():
            pt.join()
        self.underlying.reset()
        self._start()

    def batch(self):
        return self.underlying.batch()


def _tensors(ds):
    out = []
    for v in vars(ds).values():
        for a in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(a, torch.Tensor):
                out.append(a)
    return out


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """Background prefetch of MultiDataSets for ComputationGraph training:
    the same queue/thread/stream contract as the DataSet variant, staging
    every input/output array (and masks)."""

    def _cast_for_wire(self, mds):
        cast = _wire_caster(self._transfer_dtype)
        keep = (lambda a: a) if not self._cast_labels else cast
        out = MultiDataSet.__new__(MultiDataSet)
        out.features = [cast(f) for f in mds.features]
        out.labels = [keep(l) for l in mds.labels]
        out.features_masks = ([keep(m) for m in mds.features_masks]
                              if mds.features_masks else mds.features_masks)
        out.labels_masks = ([keep(m) for m in mds.labels_masks]
                            if mds.labels_masks else mds.labels_masks)
        _carry_metas(mds, out)
        return out

    def _stage(self, mds):
        staged = MultiDataSet.__new__(MultiDataSet)

        def fill(put, transform):
            staged.features = [put(f) for f in mds.features]
            if self._device_fn is not None:
                staged.features = [transform(f) for f in staged.features]
            staged.labels = [put(l) for l in mds.labels]
            staged.features_masks = ([put(m) for m in mds.features_masks]
                                     if mds.features_masks else
                                     mds.features_masks)
            staged.labels_masks = ([put(m) for m in mds.labels_masks]
                                   if mds.labels_masks else mds.labels_masks)

        self._staged(staged, fill)
        _carry_metas(mds, staged)
        return staged


class ExistingDataSetIterator(DataSetIterator):
    """Adapt any python iterable of DataSets (or a factory callable) to the
    protocol, so reset() restarts it. One-shot sources (generators) are
    replayed from a cache on reset()."""

    def __init__(self, iterable_or_factory, total_outcomes=-1):
        self._source = iterable_or_factory
        self._outcomes = int(total_outcomes)
        src = iterable_or_factory
        self._one_shot = (not callable(src)) and iter(src) is src
        if self._one_shot:
            self._consumed = []   # every item ever pulled from the source
            self._pos = 0
        self.reset()

    def reset(self):
        if self._one_shot:
            self._pos = 0
            return
        src = self._source
        self._it = iter(src() if callable(src) else src)
        self._next = next(self._it, None)

    def has_next(self):
        if self._one_shot:
            if self._pos < len(self._consumed):
                return True
            try:
                self._consumed.append(next(self._source))
                return True
            except StopIteration:
                return False
        return self._next is not None

    def next_batch(self):
        if self._one_shot:
            if not self.has_next():
                return None
            ds = self._consumed[self._pos]
            self._pos += 1
            return ds
        ds = self._next
        self._next = next(self._it, None)
        return ds

    def total_outcomes(self):
        return self._outcomes


class ArraysDataSetIterator(DataSetIterator):
    """Batches over (features, labels) arrays, or an iterable of
    (features_row, labels_row) examples."""

    def __init__(self, pairs, batch_size):
        if (isinstance(pairs, tuple) and len(pairs) == 2
                and hasattr(pairs[0], "shape")):
            feats, labs = pairs
        else:
            pairs = list(pairs)
            feats = np.stack([np.asarray(f, np.float32) for f, _ in pairs])
            labs = np.stack([np.asarray(l, np.float32) for _, l in pairs])
        self._ds = DataSet(np.asarray(feats), np.asarray(labs))
        self.batch_size = int(batch_size)
        self.reset()

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < self._ds.num_examples()

    def next_batch(self):
        i, j = self._pos, self._pos + self.batch_size
        self._pos = j
        return DataSet(self._ds.features[i:j], self._ds.labels[i:j])

    def batch(self):
        return self.batch_size

    def input_columns(self):
        return int(np.prod(self._ds.features.shape[1:]))

    def total_outcomes(self):
        return int(self._ds.labels.shape[-1])


INDArrayDataSetIterator = ArraysDataSetIterator   # reference names
DoublesDataSetIterator = ArraysDataSetIterator
FloatsDataSetIterator = ArraysDataSetIterator


class ReconstructionDataSetIterator(DataSetIterator):
    """Wrap an iterator, replacing labels with the features (autoencoder
    targets)."""

    def __init__(self, backing):
        self.backing = backing

    def has_next(self):
        return self.backing.has_next()

    def next_batch(self):
        ds = self.backing.next_batch()
        return DataSet(ds.features, ds.features,
                       ds.features_mask, ds.features_mask)

    def reset(self):
        self.backing.reset()

    def batch(self):
        return self.backing.batch()

    def input_columns(self):
        return self.backing.input_columns()

    def total_outcomes(self):
        return self.backing.input_columns()


class MovingWindowDataSetIterator(DataSetIterator):
    """Sliding windows over a sequence dataset: each example is a
    [window, features] slice advanced by `stride`, labelled by its last
    step."""

    def __init__(self, features, labels, window, stride=1, batch_size=32):
        feats = np.asarray(features)
        labs = np.asarray(labels)
        xs, ys = [], []
        for start in range(0, len(feats) - window + 1, int(stride)):
            xs.append(feats[start:start + window])
            ys.append(labs[start + window - 1])
        self._x = np.stack(xs) if xs else np.zeros((0, window) +
                                                   feats.shape[1:])
        self._y = np.stack(ys) if ys else np.zeros((0,) + labs.shape[1:])
        self.batch_size = int(batch_size)
        self.reset()

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._x)

    def next_batch(self):
        i, j = self._pos, self._pos + self.batch_size
        self._pos = j
        return DataSet(self._x[i:j], self._y[i:j])

    def batch(self):
        return self.batch_size


class CombinedPreProcessor:
    """Chain DataSet pre-processors (anything with pre_process(ds), or a
    callable), each bound by the rebind-only contract of
    `DataSetIterator.set_pre_processor`."""

    class Builder:
        def __init__(self):
            self._steps = []

        def add_pre_processor(self, p):
            self._steps.append(p)
            return self

        addPreProcessor = add_pre_processor

        def build(self):
            return CombinedPreProcessor(self._steps)

    def __init__(self, steps):
        self.steps = list(steps)

    def pre_process(self, ds):
        for p in self.steps:
            out = p.pre_process(ds) if hasattr(p, "pre_process") else p(ds)
            if out is not None:
                ds = out
        return ds

    preProcess = pre_process
