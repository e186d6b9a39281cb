"""The port's ``ckpt_backend orbax`` (``pnpflow_tpu_torch/training/
checkpoint.py``): the contract of JAX's ``OrbaxCheckpointer``
(``tests/test_runtime_backends.py``'s save / restore round trip and the
empty directory), its retention of the newest 3 steps, the atomic
finalisation (a half-written temporary directory is never read), the
asynchronous save (the host copy is taken before ``save`` returns, so it
equals a synchronous write of the same state), and the trainer resuming
through it.

A resumed run reseeds its draws with ``seed + start_epoch``, in both
packages, so it does not repeat an uninterrupted run's later epochs; what
the resume restores is the state bit for bit, and the same resume through
the msgpack backend trains to the same parameters.
"""

import os

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from pnpflow_tpu_torch.models.registry import read_msgpack, write_msgpack
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.training import flow_matching as fm
from pnpflow_tpu_torch.training.checkpoint import (
    STATE_FILE, OrbaxCheckpointer)
from pnpflow_tpu_torch.utils.config import CfgNode

DIM = 16
TINY = dict(input_channels=1, input_height=DIM, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_sample_plot(monkeypatch):
    """The epoch-0 sample plot (16 samples, 10 forwards) is not under test
    here."""
    monkeypatch.setattr(fm.FlowMatchingTrainer, "_save_sample_plot",
                        lambda *a: None)


def _tiny_tree(step=7):
    """The JAX test's tiny state, as the msgpack layout holds it."""
    params = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3)}
    mu = optax.adam(1e-3).init({"w": jnp.asarray(params["w"])})[0].mu
    return {"params": params, "opt_state": {"0": {"mu": {
        "w": np.asarray(mu["w"])}}}, "ema": dict(params),
        "step": np.array(step, np.int32)}


def test_save_restore_round_trip(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(_tiny_tree(), epochs_done=3)
    ck.wait_until_finished()
    tree, epochs_done, resumed = ck.restore_latest()
    assert resumed and epochs_done == 3 and int(tree["step"]) == 7
    np.testing.assert_array_equal(tree["params"]["w"],
                                  np.arange(6.0).reshape(2, 3))
    assert os.listdir(ck.directory) == ["7"]
    ck.close()


def test_restore_empty_dir(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "ck2"))
    assert ck.restore_latest() == (None, 0, False)
    assert ck.latest_step() is None
    ck.close()


def test_retention_keeps_the_newest_three(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    for step in (1, 2, 3, 4, 5):
        ck.save(_tiny_tree(step), epochs_done=step)
    ck.save(_tiny_tree(5), epochs_done=9)    # a step written again
    ck.wait_until_finished()
    assert ck.all_steps() == [3, 4, 5]
    assert sorted(os.listdir(ck.directory)) == ["3", "4", "5"]
    assert ck.restore_latest()[1] == 9


def test_half_written_temporary_directory_is_ignored(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(_tiny_tree(4), epochs_done=1)
    ck.wait_until_finished()
    # a save killed before its rename, and a step directory with no file
    tmp = os.path.join(ck.directory, ".tmp-9-dead")
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        f.write(b"truncated")
    os.makedirs(os.path.join(ck.directory, "12"))
    assert ck.all_steps() == [4]
    tree, epochs_done, ok = ck.restore_latest()
    assert ok and int(tree["step"]) == 4 and epochs_done == 1
    ck.save(_tiny_tree(5))
    ck.wait_until_finished()
    assert not os.path.exists(tmp)      # the next save removes it


def test_async_save_equals_sync_write(tmp_path):
    tree = _tiny_tree(3)
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(tree, epochs_done=2)
    # the state changes under the write thread: the copy was taken
    tree["params"]["w"] += 100.0
    ck.wait_until_finished()
    sync = dict(_tiny_tree(3), epochs_done=np.int32(2))
    write_msgpack(sync, str(tmp_path / "sync.msgpack"))
    with open(os.path.join(ck.directory, "3", STATE_FILE), "rb") as f:
        got = f.read()
    with open(tmp_path / "sync.msgpack", "rb") as f:
        assert got == f.read()
    assert read_msgpack(os.path.join(ck.directory, "3", STATE_FILE))[1] \
        is None


def _args(tmp_path, **extra):
    return CfgNode(dict({
        "dataset": "synthetic", "model": "ot", "dim_image": DIM,
        "num_channels": 1, "lr": 1e-3, "num_epoch": 1, "seed": 0,
        "output_root": str(tmp_path), "batch_size_train": 4,
        "max_iters_per_epoch": 1, "device": "cpu"}, **extra))


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, DIM, DIM, 1)).astype(np.float32)
    return {"train": [(x, np.zeros(4, np.int32))] * 3}


def _train(root, backend, epochs):
    tr = fm.FlowMatchingTrainer(_args(root, ckpt_backend=backend,
                                      num_epoch=epochs),
                                model=VelocityUNet(**TINY, fused_norm=True))
    return tr, tr.train(_data())


def _state_tensors(state):
    out = {"p/" + k: v.clone() for k, v in state.model.state_dict().items()}
    out.update({"e/" + k: v.clone() for k, v in state.ema.items()})
    for p, n in zip(state.model.parameters(), state.ema):
        st = state.optimizer.state[p]
        out["m/" + n], out["v/" + n] = st["exp_avg"], st["exp_avg_sq"]
    return out


def test_trainer_resumes_through_orbax(tmp_path):
    """Epoch 1 writes step directories; a new trainer restores the state of
    its last one bit for bit and trains epoch 2 to the parameters that the
    msgpack backend's resume reaches."""
    tr, one = _train(tmp_path / "o", "orbax", 1)
    d = os.path.join(tr.model_dir, "orbax")
    assert os.listdir(d) == ["1"]
    assert not os.path.exists(tr._state_path())
    want = _state_tensors(one)

    again = fm.FlowMatchingTrainer(
        _args(tmp_path / "o", ckpt_backend="orbax", num_epoch=2),
        model=VelocityUNet(**TINY))
    restored, epochs_done, ok = again.restore_state(again.init_state(5))
    assert ok and epochs_done == 1 and restored.step == 1
    for k, v in _state_tensors(restored).items():
        assert torch.equal(v, want[k]), k

    _, two = _train(tmp_path / "o", "orbax", 2)
    assert two.step == 2 and sorted(os.listdir(d)) == ["1", "2"]
    _train(tmp_path / "m", "msgpack", 1)
    _, two_m = _train(tmp_path / "m", "msgpack", 2)
    for k, v in _state_tensors(two).items():
        assert torch.equal(v, _state_tensors(two_m)[k]), k


def test_close_waits_for_the_writes_and_errors_surface(tmp_path):
    """``close`` (and ``wait_until_finished``) return once every queued
    write is on disk; a write that fails raises there, not silently.  The
    CLI's ``ckpt_backend orbax`` runs in ``tests/test_torch_grain.py``'s
    CLI test."""
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    for step in (1, 2):
        ck.save(_tiny_tree(step))
    ck.close()
    assert ck.all_steps() == [1, 2]
    bad = OrbaxCheckpointer(str(tmp_path / "bad"))
    bad.save({"step": np.array("three")})      # no step number
    with pytest.raises(ValueError, match="three"):
        bad.wait_until_finished()
    assert bad.all_steps() == []
