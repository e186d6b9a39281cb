"""The flow-matching trainer's FID-5k curve under ``compute_metrics``.

Every ``save_every`` epoch appends one ``epoch fid`` row to
``{model_dir}/FID_5k.txt``: the EMA weights sampled by Euler in 10 steps,
scored against the test split (JAX: ``pnpflow_tpu/training/flow_matching.py
:416-451``).  Here n is cut from 5000 to 8 and the features are the 32x32
pixels (no Inception weights).  Two intended divergences from JAX: a new
step's weights give a new value (JAX's chunk cache repeats the first one),
and an error propagates (JAX prints "FID checkpoint skipped").  The curve
caches no generated chunk, which no later call could read.
"""

import functools
import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.training import flow_matching as fm
from pnpflow_tpu_torch.utils.config import CfgNode

DIM = 16
TINY = dict(input_channels=1, input_height=DIM, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,))
N = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and for the BLAS under scipy's
    ``sqrtm`` (its Schur recursion gains nothing from more): the test
    runner runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _trainer(tmp_path, **extra):
    args = CfgNode(dict({
        "dataset": "synthetic", "model": "ot", "dim_image": DIM,
        "num_channels": 1, "lr": 1e-3, "num_epoch": 1, "seed": 0,
        "output_root": str(tmp_path), "batch_size_train": 4,
        "device": "cpu", "save_every": 1, "max_iters_per_epoch": 1,
        "compute_metrics": True, "eval_split": "test"}, **extra))
    tr = fm.FlowMatchingTrainer(args, model=VelocityUNet(**TINY))
    # n cut from the protocol's 5000
    tr._fid_checkpoint = functools.partial(
        fm.FlowMatchingTrainer._fid_checkpoint, tr, n=N)
    return tr


def _loaders(seed=0):
    rng = np.random.default_rng(seed)

    def batch(n):
        return (np.tanh(rng.normal(size=(n, DIM, DIM, 1))).astype(np.float32),
                np.zeros(n))

    return {"train": [batch(4)], "test": [batch(N)]}


def _rows(tr):
    with open(f"{tr.model_dir}/FID_5k.txt") as f:
        return [line.split() for line in f]


def test_training_writes_the_curve_and_a_new_step_moves_it(tmp_path):
    tr = _trainer(tmp_path)
    loaders = _loaders()
    with pytest.warns(UserWarning, match="pixel features"):
        state = tr.train(loaders)
    rows = _rows(tr)
    assert [r[0] for r in rows] == ["0"] and math.isfinite(float(rows[0][1]))
    # one more step: other EMA weights, another value (JAX's cache would
    # serve the first checkpoint's samples again)
    x0, x1 = (torch.from_numpy(np.random.default_rng(s).standard_normal(
        (4, DIM, DIM, 1)).astype(np.float32)) for s in (1, 2))
    tr.train_step(state, x0, x1, torch.Generator().manual_seed(1))
    before = [p.detach().clone() for p in state.model.parameters()]
    with pytest.warns(UserWarning, match="pixel features"):
        moved = tr._fid_checkpoint(state, 1, loaders)
    rows = _rows(tr)
    assert [r[0] for r in rows] == ["0", "1"]
    assert moved["resumed_chunks"] == 0
    assert float(rows[1][1]) == moved["fid"] != float(rows[0][1])
    # the curve reads the EMA weights and puts the trained ones back
    assert all(torch.equal(a, p) for a, p in zip(
        before, state.model.parameters()))
    assert not all(torch.equal(state.ema[n], p) for n, p in
                   state.model.named_parameters())
    # no generated chunk is cached: no later call could read it; the test
    # features are, and both calls read them
    cache = tmp_path / "results" / "synthetic" / "ot" / "metric_cache"
    assert [p.relative_to(cache).as_posix()
            for p in sorted(cache.rglob("*"))] == [
        "test_pixels_32_test_d16", "test_pixels_32_test_d16/feats_n8.npz"]


def test_curve_is_off_without_compute_metrics(tmp_path):
    tr = _trainer(tmp_path, compute_metrics=False)
    state = tr.init_state(0)
    assert tr._fid_checkpoint(state, 0, _loaders()) is None
    assert not (tmp_path / "model" / "synthetic" / "ot" /
                "FID_5k.txt").exists()


def test_an_error_propagates(tmp_path):
    """JAX prints "FID checkpoint skipped" and trains on; the port raises,
    so a broken metric path shows."""
    class Unreadable:
        def __iter__(self):
            raise OSError("test image unreadable")

    tr = _trainer(tmp_path)
    state = tr.init_state(0)
    with pytest.raises(OSError, match="unreadable"), \
            pytest.warns(UserWarning, match="pixel features"):
        tr._fid_checkpoint(state, 0, {"test": Unreadable()})
