"""MagicQueue: per-device staging of global batches.

Port of deeplearning4j_tpu/parallel/magic_queue.py (reference
deeplearning4j-core parallelism/MagicQueue.java:21-47). A filler thread
splits each global batch along the batch axis into one shard per device
and stages each shard onto its device, so consumers pop batches that are
already resident; the copy happens off the training thread, the
`AsyncDataSetIterator` contract generalised to several devices. On a card
the copy is the same as there: the host shard pinned, a non-blocking copy
on a side `torch.cuda.Stream` (one per device, owned by the filler
thread), an event recorded after it. `next_for` makes the consumer's
current stream wait on that event and calls `record_stream` on each staged
tensor before handing the shard out.

`devices=None` means every local CUDA card (and raises without one);
pass `devices=["cpu", ...]` to stage to the CPU.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..common.device import resolve_device
from ..datasets.dataset import DataSet
from ..datasets.iterators import next_processed

_EOS = object()     # end-of-stream marker, distinct from any shard


class MagicQueue:
    def __init__(self, devices=None, capacity=2):
        if devices is None:
            resolve_device(None)            # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        self.capacity = int(capacity)
        self._buckets = [queue.Queue(maxsize=self.capacity)
                         for _ in self.devices]
        self._streams = {}
        self._thread = None
        self._stop = threading.Event()
        self._error = None

    # -- producer side --------------------------------------------------
    def feed(self, iterator):
        """Start the background filler over a DataSetIterator (or iterable
        of DataSets). Each global batch is split into len(devices) shards
        (reference MagicQueue.add routing by device index)."""
        if self._thread is not None:
            raise RuntimeError("MagicQueue is already being fed")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._fill, args=(iterator,), daemon=True)
        self._thread.start()
        return self

    def _stage(self, ds, lo, hi, dev):
        """Rows [lo, hi) of `ds` on `dev`; on a card copied on the
        device's side stream, with the event its consumer waits on."""
        def put(a):
            if a is None:
                return None
            t = a[lo:hi] if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
            if dev.type != "cuda" or t.is_cuda:
                return t.to(dev)
            return t.pin_memory().to(dev, non_blocking=True)

        shard = DataSet.__new__(DataSet)
        if dev.type != "cuda":
            shard.features, shard.labels, shard.features_mask, \
                shard.labels_mask = (put(ds.features), put(ds.labels),
                                     put(ds.features_mask),
                                     put(ds.labels_mask))
            return shard
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            shard.features, shard.labels, shard.features_mask, \
                shard.labels_mask = (put(ds.features), put(ds.labels),
                                     put(ds.features_mask),
                                     put(ds.labels_mask))
            ready = torch.cuda.Event()
            ready.record(stream)
        shard._staged_ready = ready
        return shard

    def _fill(self, iterator):
        try:
            it = iter(iterator) if not hasattr(iterator, "has_next") else None
            while not self._stop.is_set():
                if it is not None:
                    try:
                        ds = next(it)
                    except StopIteration:
                        break
                else:
                    if not iterator.has_next():
                        break
                    ds = next_processed(iterator)
                n = len(self.devices)
                b = ds.num_examples()
                per = -(-b // n)
                for di, dev in enumerate(self.devices):
                    lo, hi = di * per, min((di + 1) * per, b)
                    hi = max(hi, lo)
                    # ragged tail: the device gets a 0-row shard (keeps
                    # consumers in lockstep; None is reserved for stream end)
                    self._put_blocking(di, self._stage(ds, lo, hi, dev))
        except Exception as e:
            self._error = e
        finally:
            for di in range(len(self._buckets)):
                self._put_blocking(di, _EOS)

    def _put_blocking(self, di, item):
        """Deliver even to a slow consumer; gives up only on shutdown()."""
        while not self._stop.is_set():
            try:
                self._buckets[di].put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer side --------------------------------------------------
    def next_for(self, device_index, timeout=30.0):
        """Pop the next device-resident DataSet shard for a device; None at
        end of stream. reference MagicQueue.poll(device)."""
        if self._error is not None:
            raise self._error
        shard = self._buckets[int(device_index)].get(timeout=timeout)
        if self._error is not None:
            raise self._error
        if shard is _EOS:
            return None
        ready = shard.__dict__.pop("_staged_ready", None)
        if ready is not None:
            dev = self.devices[int(device_index)]
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for t in (shard.features, shard.labels, shard.features_mask,
                      shard.labels_mask):
                if t is not None:
                    t.record_stream(consumer)
        return shard

    def size(self, device_index=None):
        if device_index is not None:
            return self._buckets[int(device_index)].qsize()
        return sum(bq.qsize() for bq in self._buckets)

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
