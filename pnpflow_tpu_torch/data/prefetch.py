"""Host-side prefetch (port of ``pnpflow_tpu/data/prefetch.py``).

A background thread keeps a bounded queue of ready batches, so the device
does not wait on decoding.  The consumer may stop early (the trainer's
``max_iters_per_epoch`` break): the generator's ``finally`` releases the
producer, so no thread or queued batch outlives the epoch.  An error in the
producer is raised in the consumer.

With ``device`` a CUDA device, the producer also moves each batch's images
there: copied into pinned memory and sent with ``non_blocking``, so the
copy overlaps the device's work instead of waiting for it.  The producer
makes that card current first (a bare ``cuda`` is the consumer's current
card): a new thread starts on card 0, whatever card the consumer's rank
trains on.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch


def to_device(x, device):
    """A numpy batch as a tensor on ``device``: through pinned memory and a
    non-blocking copy for a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device is not None and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t if device is None else t.to(device)


class PrefetchIterator:
    """Wrap any iterable of batches with an N-deep background queue; with
    ``device``, each ``(images, labels)`` item's images arrive on it."""

    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2, device=None):
        self._iterable = iterable
        self._depth = depth
        self._device = device

    def __len__(self):
        return len(self._iterable)

    @staticmethod
    def _ready(item, dev):
        if dev is None:
            return item
        x, *rest = item
        return (to_device(x, dev), *rest)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        err: list = []
        dev = None if self._device is None else torch.device(self._device)
        on_card = dev is not None and dev.type == "cuda"
        if on_card and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())

        def _put(item) -> bool:
            """put() that gives up when the consumer has gone away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                with (torch.cuda.device(dev) if on_card
                      else contextlib.nullcontext()):
                    for item in self._iterable:
                        if not _put(self._ready(item, dev)):
                            return
            except BaseException as exc:  # raised again in the consumer
                err.append(exc)
            finally:
                _put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # the consumer is done (normally, by break or by an exception):
            # release the producer, possibly blocked on a full queue
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def prefetch(loader, depth: int = 2, device=None):
    """Wrap a loader (or a dict of them) with background prefetch."""
    if isinstance(loader, dict):
        return {k: (PrefetchIterator(v, depth, device) if v is not None
                    else None) for k, v in loader.items()}
    return PrefetchIterator(loader, depth, device)
