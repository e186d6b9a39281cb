"""The port's ``data_backend grain`` (``pnpflow_tpu_torch/data/
grain_loader.py``, a ``torch.utils.data.DataLoader`` with worker
processes) against the JAX package's grain loader and the thread loader,
as ``tests/test_runtime_backends.py`` holds JAX's: the same images as the
thread path, each epoch the same images as JAX's (in another order: torch's
``randperm``, not grain's), a deterministic order for a seed, ``drop_last``
and missing files; and the CLI's ``train True`` reading through it (with
``ckpt_backend orbax``: one full-width CLI run serves both backends).
Worker processes start by ``forkserver``; a test that starts them stops
with an error after 60 s an epoch (600 s for the whole CLI run, which
trains the full-width U-Net and writes its checkpoints), never hangs.
"""

import contextlib
import functools
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from pnpflow_tpu_torch.data.datasets import (
    DataLoaders, _FileDataset, resize_transform)
from pnpflow_tpu_torch.data.grain_loader import GrainFileLoader
from pnpflow_tpu_torch.main import main
from pnpflow_tpu_torch.training import flow_matching as fm

TRANSFORM = functools.partial(resize_transform, size=(16, 16))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image_dir(tmp_path, n=10, size=16):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        p = tmp_path / f"img_{i:02d}.png"
        Image.fromarray(rng.integers(0, 255, size=(size, size, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


def _rows(batches):
    return np.concatenate([x for x, _ in batches])


def _as_set(x):
    return sorted(map(bytes, np.ascontiguousarray(x)))


def test_same_images_as_the_thread_loader(tmp_path):
    paths = _image_dir(tmp_path)
    ref = list(_FileDataset(paths, 4, TRANSFORM))
    got = list(GrainFileLoader(paths, 4, TRANSFORM, num_workers=0))
    assert [x.shape for x, _ in got] == [x.shape for x, _ in ref]
    for (a, la), (b, lb) in zip(ref, got):
        np.testing.assert_array_equal(a, b)
        assert lb.dtype == np.int32 and la.shape == lb.shape


def test_epoch_membership_equals_jax(tmp_path):
    pytest.importorskip("grain")
    from pnpflow_tpu.data.grain_loader import GrainFileLoader as JaxLoader

    paths = _image_dir(tmp_path)
    jax_l = JaxLoader(paths, 3, TRANSFORM, shuffle=True, seed=5,
                      num_workers=0)
    port = GrainFileLoader(paths, 3, TRANSFORM, shuffle=True, seed=5,
                           num_workers=0)
    for _ in range(2):
        a, b = list(jax_l), list(port)
        assert len(a) == len(b) == len(port) == 4
        assert _as_set(_rows(a)) == _as_set(_rows(b))


def test_order_is_deterministic_for_a_seed(tmp_path):
    paths = _image_dir(tmp_path)
    a = GrainFileLoader(paths, 10, TRANSFORM, shuffle=True, seed=3,
                        num_workers=0)
    b = GrainFileLoader(paths, 10, TRANSFORM, shuffle=True, seed=3,
                        num_workers=0)
    (xa, _), = list(a)
    (xb, _), = list(b)
    np.testing.assert_array_equal(xa, xb)
    (xa2, _), = list(a)         # the next epoch reshuffles
    assert not np.array_equal(xa, xa2)
    assert a.order(1) == b.order(1) != a.order(0)


def test_drop_last_and_missing_files(tmp_path):
    paths = _image_dir(tmp_path) + [str(tmp_path / "missing.png")]
    with pytest.warns(UserWarning, match="missing.png"):
        loader = GrainFileLoader(paths, 4, TRANSFORM, drop_last=True,
                                 num_workers=0)
    batches = list(loader)
    assert len(batches) == len(loader) == 2     # 10 files, the ragged 2 go
    assert all(b[0].shape == (4, 16, 16, 3) for b in batches)


def _timeout(seconds):
    def fail(*_):
        raise TimeoutError(f"a worker epoch took more than {seconds} s")

    signal.signal(signal.SIGALRM, fail)
    signal.alarm(seconds)


def test_worker_processes(tmp_path):
    """Two worker processes, two epochs: the thread loader's images, and
    the same shuffled order as in this process."""
    paths = _image_dir(tmp_path)
    inline = GrainFileLoader(paths, 4, TRANSFORM, shuffle=True, seed=1,
                             num_workers=0)
    workers = GrainFileLoader(paths, 4, TRANSFORM, shuffle=True, seed=1,
                              num_workers=2)
    try:
        for _ in range(2):
            _timeout(60)
            got = list(workers)
            signal.alarm(0)
            for (a, _), (b, _) in zip(list(inline), got):
                np.testing.assert_array_equal(a, b)
    finally:
        signal.alarm(0)


_READ_AND_EXIT = """
import functools, sys
from pnpflow_tpu_torch.data.datasets import resize_transform
from pnpflow_tpu_torch.data.grain_loader import GrainFileLoader
loader = GrainFileLoader(sys.argv[1:], 4, functools.partial(
    resize_transform, size=(16, 16)), num_workers=2)
print(sum(len(x) for x, _ in loader))
"""


def _session(sid):
    """The live processes of session ``sid``."""
    left = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                state, _, _, session = f.read().rsplit(")", 1)[1].split()[:4]
        except OSError:
            continue
        if int(session) == sid and state != "Z":
            left.append(int(d))
    return left


def test_a_program_that_read_with_workers_leaves_no_process(tmp_path):
    """The forkserver and the resource tracker that the workers need are
    stopped when the program exits: nothing of its session outlives it."""
    paths = _image_dir(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out, err = tmp_path / "out.txt", tmp_path / "err.txt"
    # to files, not pipes: the forkserver inherits the program's stdout,
    # and a reader of a pipe would wait for the server too
    with open(out, "w") as o, open(err, "w") as e:
        proc = subprocess.Popen(
            [sys.executable, "-c", _READ_AND_EXIT, *paths], cwd=root,
            stdout=o, stderr=e, start_new_session=True)
    try:
        proc.wait(timeout=120)
        left = _session(proc.pid)   # the new session's id is the child's pid
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0, err.read_text()
    assert out.read_text().split() == ["10"]
    assert not left


def _celeba(root, n=8):
    """A CelebA-layout folder: 178x178 images and the partition csv."""
    d = root / "data" / "celeba" / "img_align_celeba"
    d.mkdir(parents=True)
    rng = np.random.default_rng(2)
    rows = ["image_id,partition"]
    for i in range(n):
        name = f"{i:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, size=(178, 178, 3),
                                     dtype=np.uint8)).save(d / name)
        rows.append(f"{name},{0 if i < n - 2 else 2}")
    (root / "data" / "celeba" / "list_eval_partition.csv").write_text(
        "\n".join(rows) + "\n")
    os.symlink(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config"), root / "config")


def test_dataloaders_and_cli_take_the_backend(tmp_path, monkeypatch):
    _celeba(tmp_path)
    loaders = DataLoaders("celeba", 2, 2, root=str(tmp_path / "data"),
                          dim_image=16, backend="grain",
                          num_workers=0).load_data()
    assert isinstance(loaders["train"], GrainFileLoader)
    x, _ = next(iter(loaders["test"]))
    assert x.shape == (2, 16, 16, 3) and -1.0 <= x.min() <= x.max() <= 1.0
    with pytest.raises(ValueError, match="unknown data_backend"):
        DataLoaders("celeba", 2, 2, backend="threads")
    # the CLI trains on it, its 4 workers reading, and keeps its resume
    # state through ckpt_backend orbax; the epoch-0 sample plot is not
    # under test here
    monkeypatch.setattr(fm.FlowMatchingTrainer, "_save_sample_plot",
                        lambda *a: None)
    out = tmp_path / "out"
    _timeout(600)
    try:
        args = main(["--opts", "dataset", "celeba", "dim_image", "16",
                     "root", str(tmp_path), "train", "True",
                     "num_epoch", "1", "batch_size_train", "2",
                     "max_iters_per_epoch", "1", "data_backend", "grain",
                     "ckpt_backend", "orbax", "eval", "False",
                     "device", "cpu", "output_root", str(out)])
    finally:
        signal.alarm(0)
    assert len(args.train_stats["losses"]) == 1
    d = out / "model" / "celeba" / "ot"
    assert (d / "model_final.msgpack").exists()
    assert os.listdir(d / "orbax") == ["1"]
    assert not (d / "train_state.msgpack").exists()
