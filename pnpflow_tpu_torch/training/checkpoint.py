"""Versioned, asynchronous train-state checkpoints (port of
``pnpflow_tpu/training/checkpoint.py``, ``--opts ckpt_backend orbax``).

JAX's ``OrbaxCheckpointer`` wraps ``orbax.checkpoint.CheckpointManager``;
there is no Orbax in PyTorch, so this module keeps its contract on its own:

* one directory per optimizer step, ``directory/<step>/``, holding the
  port's msgpack resume layout (``params``, ``opt_state``, ``ema``,
  ``step``, ``epochs_done``: what ``train_state.msgpack`` holds), and the
  newest ``max_to_keep`` (3) of them kept;
* atomic finalisation: a step is written into a temporary directory
  (``.tmp-<step>-...``), then renamed with ``os.replace``; a half-written
  temporary directory is never read and is removed by the next save;
* asynchronous save: the host copy is taken before :meth:`save` returns,
  and the write runs on a thread, in order; :meth:`wait_until_finished`
  waits for it (and raises what it raised), :meth:`close` too;
* :meth:`restore_latest` reads the newest finished step.

:class:`FileCheckpointer` is the default backend (``ckpt_backend msgpack``)
behind the same interface: the one ``train_state.msgpack``, replaced
atomically by every save, written at once.  The trainer holds one of the
two and calls nothing else.

Neither package reads the other's ``orbax/`` directory: Orbax writes its
own format (tensorstore/OCDBT), this one writes msgpack.
"""

from __future__ import annotations

import os
import shutil
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pnpflow_tpu_torch.models.registry import read_msgpack, write_msgpack

STATE_FILE = "state.msgpack"


def host_copy(tree):
    """A deep copy of a nested dict of arrays, on the host: what the write
    thread serialises cannot change under it."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _resume_tree(path):
    """``(tree, epochs_done)`` from a resume file; a parameter file (one
    with a fingerprint) or one without ``epochs_done`` raises."""
    tree, fp = read_msgpack(path)
    if fp is not None or "epochs_done" not in tree:
        raise ValueError(f"{path}: not a resume state")
    return tree, int(tree.pop("epochs_done"))


class FileCheckpointer:
    """The trainer's resume state in one file, replaced on every save."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def save(self, tree: dict, epochs_done: int = 0):
        """Write ``tree`` (the msgpack resume layout without
        ``epochs_done``) now, atomically."""
        write_msgpack(dict(tree, epochs_done=np.int32(epochs_done)),
                      self.path)

    def restore_latest(self):
        """``(tree, epochs_done, resumed)``, or ``(None, 0, False)`` where
        there is no file."""
        if not os.path.exists(self.path):
            return None, 0, False
        return (*_resume_tree(self.path), True)

    def wait_until_finished(self):
        pass

    def close(self):
        pass


class OrbaxCheckpointer:
    """The trainer's resume state in versioned step directories."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = self.path = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def all_steps(self) -> list:
        """The finished steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, tree: dict, epochs_done: int = 0):
        """Queue the write of ``tree`` (the msgpack resume layout without
        ``epochs_done``) under its ``step``; returns once the host copy is
        taken.  A step written before is replaced."""
        payload = host_copy(tree)
        payload["epochs_done"] = np.int32(epochs_done)
        self._pending.append(self._pool.submit(self._write, payload))

    def _write(self, payload):
        step = int(payload["step"])
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.directory, name))
        tmp = os.path.join(self.directory,
                           f".tmp-{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        write_msgpack(payload, os.path.join(tmp, STATE_FILE))
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            old = tmp + ".old"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(s)))

    def restore_latest(self):
        """``(tree, epochs_done, resumed)`` of the newest finished step, or
        ``(None, 0, False)`` where there is none; waits for pending
        writes first."""
        self.wait_until_finished()
        step = self.latest_step()
        if step is None:
            return None, 0, False
        return (*_resume_tree(os.path.join(self.directory, str(step),
                                           STATE_FILE)), True)

    def wait_until_finished(self):
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self):
        self.wait_until_finished()
        self._pool.shutdown()
