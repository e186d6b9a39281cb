"""Multiprocess input pipeline for the image-file datasets (port of
``pnpflow_tpu/data/grain_loader.py``; ``--opts data_backend grain``).

JAX's ``GrainFileLoader`` is built on grain; this one on
``torch.utils.data.DataLoader`` with ``num_workers`` worker processes, with
the same iterator contract as the thread path (``data/datasets.py``
``_FileDataset``): ``(images NHWC float32, labels int32)`` numpy batches,
shuffled per epoch by a generator seeded ``seed + epoch``, ``drop_last``,
and missing files dropped with a warning at construction, so that indices
stay stable.  The order of a shuffled epoch is torch's ``randperm`` of that
generator, not grain's: an epoch holds the same images as JAX's, in another
order.

Workers start with ``forkserver``, not ``fork``: a process forked from a
parent that runs torch's thread pools can deadlock, and the forkserver's
workers share none of its threads; the server imports torch and this
module once, so each epoch's workers start in a fraction of a second.  The
server and the resource tracker that comes with it are processes of their
own that would outlive the program: ``stop_worker_servers`` stops both, and
runs at exit.  The
transform must be picklable (the module-level transforms of
``data/datasets.py`` are), and a script that iterates the loader guards its
entry with ``if __name__ == "__main__"``, as ``multiprocessing`` asks.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import warnings
from multiprocessing import forkserver, resource_tracker

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset


class _ImageSource(Dataset):
    """Random access over image files: decode and transform one."""

    def __init__(self, paths, transform):
        kept = []
        for p in paths:
            if os.path.exists(p):
                kept.append(p)
            else:
                warnings.warn(f"File not found: {p}. Skipping.")
        self.paths = kept
        self.transform = transform

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        from PIL import Image

        img = Image.open(self.paths[int(idx)]).convert("RGB")
        return np.asarray(self.transform(img), np.float32)


def _stack(items):
    return np.stack(items)


def stop_worker_servers():
    """Stop the forkserver and the resource tracker, if they run, and wait
    for both to exit; the next loader with workers starts them again."""
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


atexit.register(stop_worker_servers)


def _context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", __name__])
    return ctx


class GrainFileLoader:
    """Per-epoch iterable with the ``_FileDataset`` contract, read by
    ``num_workers`` worker processes (0: in this process)."""

    def __init__(self, paths, batch_size, transform, shuffle=False, seed=0,
                 drop_last=False, num_workers: int = 4):
        self.source = _ImageSource(paths, transform)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self._epoch = 0

    def __len__(self):
        n = len(self.source)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def order(self, epoch: int) -> list:
        """The indices of epoch ``epoch`` in the order they are read."""
        n = len(self.source)
        if not self.shuffle:
            return list(range(n))
        gen = torch.Generator().manual_seed(self.seed + epoch)
        return torch.randperm(n, generator=gen).tolist()

    def __iter__(self):
        order = self.order(self._epoch)
        self._epoch += 1
        workers = self.num_workers
        loader = DataLoader(
            self.source, batch_size=self.batch_size, sampler=order,
            drop_last=self.drop_last, num_workers=workers,
            collate_fn=_stack,
            multiprocessing_context=_context() if workers else None)
        for imgs in loader:
            yield imgs, np.zeros(len(imgs), dtype=np.int32)
