"""Prefetching around any batch source (counterpart of
``repro.data.pipeline``).

``Prefetcher`` runs the (numpy-producing) source in a daemon thread with
a bounded queue, so host-side batch synthesis overlaps the device step;
its ``place`` hook moves each batch to the device as it is taken
(e.g. ``to_device``: pinned host memory and a non-blocking copy on a
CUDA device).  ``sharded_placer`` is the hook of a sharded train step:
each rank keeps its rows of every host batch (the reference's placer
onto mesh shardings, where each device holds its rows).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch


class Prefetcher:
    def __init__(self, source: Callable[[int], Any], *, depth: int = 2,
                 start_step: int = 0,
                 place: Callable[[Any], Any] | None = None):
        """source(step) -> batch (a dict of numpy arrays); place: e.g.
        ``lambda b: to_device(b, "cuda")``."""
        self.source = source
        self.place = place or (lambda b: b)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.source(step)
            except Exception as e:            # surface errors to the consumer
                self._q.put(e)
                return
            # block while the queue is full (bounded prefetch)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self, timeout: float = 60.0):
        item = self._q.get(timeout=timeout)
        if isinstance(item, Exception):
            raise item
        step, batch = item
        return step, self.place(batch)

    def __iter__(self) -> Iterator:
        while True:
            yield self.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def to_device(batch: dict, device) -> dict:
    """A dict of numpy arrays as tensors on `device`: through pinned host
    memory with a non-blocking copy on a CUDA device."""
    device = torch.device(device)
    out = {}
    for key, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


def sharded_placer(spec_tree, mapping, device):
    """Batch placer for a sharded train step: each host batch (a dict of
    numpy arrays) cut to this rank's slice by its resolved spec in
    `spec_tree` (``Mapping.batch_sharding``: rows over the batch axes)
    and moved to `device` through ``to_device``."""
    def place(batch: dict) -> dict:
        local = {}
        for key, x in batch.items():
            x = np.asarray(x)
            for dim, axes in enumerate(spec_tree[key]):
                if axes is not None:
                    lo, hi = mapping.local_range(axes, x.shape[dim])
                    x = x[(slice(None),) * dim + (slice(lo, hi),)]
            local[key] = x
        return to_device(local, device)
    return place
