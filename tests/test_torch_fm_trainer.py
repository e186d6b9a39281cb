"""The port's ``FlowMatchingTrainer`` and the CLI's ``train True``: the
checkpoint set, the resume state and its cadence, what each package reads
of the other's files, and what the trainer refuses.

Carried across, parameters, EMA and Adam's moments are equal bit for bit:
each side only transposes float32 arrays.
"""

import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pnpflow_tpu.models import registry as jreg
from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.training.flow_matching import (
    FlowMatchingTrainer as JaxTrainer)
from pnpflow_tpu.utils.config import CfgNode as JaxCfg
from pnpflow_tpu.utils.torch_convert import convert_unet_state_dict
from pnpflow_tpu_torch.main import main
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.training import flow_matching as fm
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import (
    flax_from_state_dict, state_dict_from_flax)

DIM = 16
TINY = dict(input_channels=1, input_height=DIM, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,))
_JAX_INIT = {}


def _args(tmp_path, **extra):
    return dict({"dataset": "synthetic", "model": "ot", "dim_image": DIM,
                 "num_channels": 1, "lr": 1e-3, "num_epoch": 1, "seed": 0,
                 "output_root": str(tmp_path), "batch_size_train": 4,
                 "device": "cpu"}, **extra)


def _trainer(tmp_path, fused=True, **extra):
    return fm.FlowMatchingTrainer(
        CfgNode(_args(tmp_path, **extra)),
        model=VelocityUNet(**TINY, fused_norm=fused))


def _stepped_state(tr, steps=1, seed=0):
    """A state after ``steps`` precoupled steps on random pairs."""
    state = tr.init_state(seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x0, x1 = (torch.from_numpy(rng.standard_normal(
            (4, DIM, DIM, 1)).astype(np.float32)) for _ in range(2))
        tr.train_step(state, x0, x1, torch.Generator().manual_seed(1))
    return state


def _jax_trainer(tmp_path):
    args = _args(tmp_path)
    del args["device"]
    return JaxTrainer(JaxCfg(args), model=JaxUNet(**TINY))


def _jax_init_state(tr):
    if "state" not in _JAX_INIT:
        _JAX_INIT["state"] = jax.device_get(tr.init_state())
    return jax.tree_util.tree_map(jnp.asarray, _JAX_INIT["state"])


def _port_adam(state, names):
    """name -> (exp_avg, exp_avg_sq, step) of the port's Adam."""
    params = dict(state.model.named_parameters())
    return {n: (state.optimizer.state[params[n]]["exp_avg"],
                state.optimizer.state[params[n]]["exp_avg_sq"],
                int(state.optimizer.state[params[n]]["step"]))
            for n in names}


def _assert_tree_equal(a, b):
    flat_a = {str(k): v for k, v in jax.tree_util.tree_leaves_with_path(a)}
    flat_b = {str(k): v for k, v in jax.tree_util.tree_leaves_with_path(b)}
    assert set(flat_a) == set(flat_b)
    for k, v in flat_a.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(flat_b[k]))


def test_save_resume_round_trip_and_corrupt_file(tmp_path):
    tr = _trainer(tmp_path)
    state = _stepped_state(tr, steps=2)
    state.step = 7
    tr.save_state(state, epoch=0, epochs_done=3)
    for f in ("model_0.msgpack", "ema_model_0.msgpack",
              "train_state.msgpack"):
        assert os.path.exists(os.path.join(tr.model_dir, f)), f
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    want_ema = {k: v.clone() for k, v in state.ema.items()}
    want_adam = _port_adam(state, tr.names)

    fresh = tr.init_state(seed=1)
    assert not torch.equal(fresh.model.begin_conv.weight,
                           want["begin_conv.weight"])
    restored, epochs_done, ok = tr.restore_state(fresh)
    assert ok and epochs_done == 3 and restored.step == 7
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in restored.ema.items():
        assert torch.equal(v, want_ema[k]), k
    for n, (m, v, s) in _port_adam(restored, tr.names).items():
        assert torch.equal(m, want_adam[n][0]) and torch.equal(
            v, want_adam[n][1]) and s == want_adam[n][2] == 2

    # a corrupt or incompatible resume file is ignored with a warning and
    # leaves the state as it was
    for blob in (b"not-a-msgpack", None):
        if blob is None:
            other = fm.FlowMatchingTrainer(
                CfgNode(_args(tmp_path)), model=VelocityUNet(
                    **dict(TINY, attn_resolutions=(16,))))
            other.save_preemption(other.init_state(), epochs_done=1)
        else:
            with open(tr._state_path(), "wb") as f:
                f.write(blob)
        fresh = tr.init_state(seed=1)
        before = fresh.model.begin_conv.weight.detach().clone()
        with pytest.warns(UserWarning, match="Ignoring incompatible resume"):
            got, epochs_done, ok = tr.restore_state(fresh)
        assert not ok and epochs_done == 0 and got.step == 0
        assert torch.equal(got.model.begin_conv.weight, before)


def test_port_checkpoint_loads_in_jax(tmp_path):
    tr = _trainer(tmp_path)
    state = _stepped_state(tr)
    tr.save_state(state, epochs_done=1)
    args = JaxCfg(_args(tmp_path))
    got = jreg.load_params(JaxUNet(**TINY), args, require=True)
    want = convert_unet_state_dict(
        {k: v.numpy() for k, v in state.model.state_dict().items()}, 2)
    _assert_tree_equal(got, want)
    # the EMA file carries the same fingerprint in its envelope
    with open(os.path.join(tr.model_dir, "ema_model_final.msgpack"),
              "rb") as f:
        ema, fp = jreg.restore_params_bytes(jreg.init_params(
            JaxUNet(**TINY), args), f.read())
    assert fp == jreg._normalize_fp(jreg.model_fingerprint(JaxUNet(**TINY),
                                                           args))
    _assert_tree_equal(ema, flax_from_state_dict(state.ema))


def test_jax_resume_state_resumes_in_the_port(tmp_path):
    jtr = _jax_trainer(tmp_path)
    jstate = _jax_init_state(jtr)
    rng = np.random.default_rng(3)

    def rand(x):
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))

    params = jax.tree_util.tree_map(rand, jstate["params"])
    mu = jax.tree_util.tree_map(rand, params)
    nu = jax.tree_util.tree_map(lambda x: jnp.abs(rand(x)), params)
    jstate = {"params": params,
              "opt_state": (optax.ScaleByAdamState(
                  count=jnp.asarray(5, jnp.int32), mu=mu, nu=nu),
                  optax.EmptyState()),
              "ema": jax.tree_util.tree_map(rand, params),
              "step": jnp.asarray(5, jnp.int32)}
    jtr.save_preemption(jstate, epochs_done=2)

    tr = _trainer(tmp_path)
    state, epochs_done, ok = tr.restore_state(tr.init_state())
    assert ok and epochs_done == 2 and state.step == 5
    for n, v in state_dict_from_flax(params).items():
        assert torch.equal(state.model.state_dict()[n], v), n
    for n, v in state_dict_from_flax(jstate["ema"]).items():
        assert torch.equal(state.ema[n], v), n
    mu_sd, nu_sd = state_dict_from_flax(mu), state_dict_from_flax(nu)
    for n, (m, v, s) in _port_adam(state, tr.names).items():
        assert torch.equal(m, mu_sd[n]) and torch.equal(v, nu_sd[n]), n
        assert s == 5
    # and training goes on from there
    tr.train_step(state, *(torch.zeros(4, DIM, DIM, 1) for _ in range(2)),
                  torch.Generator().manual_seed(0))
    assert state.step == 6


def test_port_resume_state_resumes_in_jax(tmp_path):
    tr = _trainer(tmp_path)
    state = _stepped_state(tr, steps=3)
    tr.save_preemption(state, epochs_done=4)
    jtr = _jax_trainer(tmp_path)
    restored, epochs_done, ok = jtr.restore_state(_jax_init_state(jtr))
    assert ok and epochs_done == 4 and int(restored["step"]) == 3
    _assert_tree_equal(restored["params"], flax_from_state_dict(
        dict(state.model.named_parameters())))
    _assert_tree_equal(restored["ema"], flax_from_state_dict(state.ema))
    adam, empty = restored["opt_state"]
    assert isinstance(empty, optax.EmptyState)
    assert int(adam.count) == 3
    adam_sd = _port_adam(state, tr.names)
    _assert_tree_equal(adam.mu, flax_from_state_dict(
        {n: v[0] for n, v in adam_sd.items()}))
    _assert_tree_equal(adam.nu, flax_from_state_dict(
        {n: v[1] for n, v in adam_sd.items()}))


def _cadence(tmp_path, monkeypatch, num_epoch, **extra):
    tr = _trainer(tmp_path, num_epoch=num_epoch, save_every=100, **extra)
    seen = []
    monkeypatch.setattr(tr, "save_preemption",
                        lambda state, epochs_done=0: seen.append(epochs_done))
    return tr, seen


def test_preemption_point_every_epoch_by_default(tmp_path, monkeypatch):
    tr, seen = _cadence(tmp_path, monkeypatch, 3)
    x = np.zeros((4, DIM, DIM, 1), np.float32)
    tr.train({"train": [(x, 0)]})
    assert {1, 2, 3} <= set(seen), seen
    assert len(tr.stats["losses"]) == 3
    assert len(tr.stats["step_seconds"]) == 3
    assert len(tr.stats["pair_seconds"]) == 3


def test_preemption_adaptive_cadence_throttles_slow_writes(
        tmp_path, monkeypatch):
    tr, seen = _cadence(tmp_path, monkeypatch, 3)
    monkeypatch.setattr(tr, "save_state", lambda *a, **k: None)
    monkeypatch.setattr(tr, "_save_sample_plot", lambda *a, **k: None)
    tr._resume_write_s = 3600.0
    tr._compute_since_write = 0.0
    x = np.zeros((4, DIM, DIM, 1), np.float32)
    tr.train({"train": [(x, 0)]})
    assert seen == [], seen


def test_preemption_fixed_cadence_honored(tmp_path, monkeypatch):
    tr, seen = _cadence(tmp_path, monkeypatch, 4, preempt_every=2)
    monkeypatch.setattr(tr, "save_state", lambda *a, **k: None)
    monkeypatch.setattr(tr, "_save_sample_plot", lambda *a, **k: None)
    x = np.zeros((4, DIM, DIM, 1), np.float32)
    tr.train({"train": [(x, 0)]})
    assert seen == [2, 4], seen


@pytest.mark.parametrize("model,ot_method", [("indep", "exact"),
                                             ("ot", "sinkhorn")])
def test_train_with_coupling_inside(tmp_path, model, ot_method):
    tr = _trainer(tmp_path, model=model, ot_method=ot_method,
                  max_iters_per_epoch=2)
    assert not tr.precoupled
    x = np.random.default_rng(0).standard_normal(
        (4, DIM, DIM, 1)).astype(np.float32)
    state = tr.train({"train": [(x, 0)] * 3})
    assert state.step == 2 and tr.stats["pair_seconds"] == []
    assert np.isfinite(tr.stats["losses"]).all()


def test_resumed_complete_run_does_not_train_again(tmp_path, capsys):
    x = np.zeros((4, DIM, DIM, 1), np.float32)
    tr = _trainer(tmp_path)
    tr.train({"train": [(x, 0)]})
    again = _trainer(tmp_path)
    state = again.train({"train": [(x, 0)]})
    assert state.step == 1
    assert "Training already complete" in capsys.readouterr().out


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="forward-only"):
        fm.FlowMatchingTrainer(CfgNode(_args(tmp_path, dim_image=8,
                                             fused_norm="conv")))
    # ckpt_backend orbax is ported (tests/test_torch_checkpoint.py); an
    # unknown backend is refused
    with pytest.raises(ValueError, match="msgpack or orbax"):
        _trainer(tmp_path, ckpt_backend="tensorstore")
    # compute_metrics (the FID-5k curve) and the dopri5 sampler are
    # ported (tests/test_torch_fid_curve.py, tests/test_torch_ode.py); an
    # unknown sampler is refused
    _trainer(tmp_path, compute_metrics=True)
    tr = _trainer(tmp_path)
    with pytest.raises(ValueError, match="euler or dopri5"):
        tr.apply_flow_matching(tr.init_state(), 2, method="rk4")
    # a model handed in with "conv" stops at the first step, before any
    # update
    conv = fm.FlowMatchingTrainer(CfgNode(_args(tmp_path)),
                                  model=VelocityUNet(**TINY,
                                                     fused_norm="conv"))
    state = conv.init_state()
    x = torch.zeros(4, DIM, DIM, 1)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv.train_step(state, x, x, torch.Generator())
    assert state.step == 0 and not state.optimizer.state
    out = str(tmp_path)
    # data_backend grain is ported (tests/test_torch_grain.py); an unknown
    # backend is refused
    with pytest.raises(ValueError, match="thread or grain"):
        main(["--opts", "dataset", "synthetic", "train", "True",
              "data_backend", "threads", "eval", "False", "device", "cpu",
              "output_root", out])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--opts", "dataset", "synthetic", "train", "True",
              "output_root", out])


def test_sampling_uses_the_ema_and_restores_the_weights(tmp_path):
    tr = _trainer(tmp_path, fused=False)
    state = _stepped_state(tr)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    gen = torch.Generator().manual_seed(4)
    got = tr.apply_flow_matching(state, 2, generator=gen, steps=3)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    ema_model = VelocityUNet(**TINY)
    ema_model.load_state_dict(state.ema)
    want = fm.euler_sample(ema_model, (2, DIM, DIM, 1), steps=3,
                           generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, want)


def test_cli_trains_then_restores_with_the_checkpoint(tmp_path):
    """``train True eval True`` with the full-width ``ot`` U-Net at 16x16 on
    the CPU: the checkpoint set, finite losses, the JAX trainer's parameter
    count, and the eval half restoring from ``model_final.msgpack``."""
    out = str(tmp_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        args = main(["--opts", "dataset", "synthetic", "dim_image", "16",
                     "model", "ot", "train", "True", "num_epoch", "1",
                     "max_iters_per_epoch", "2", "batch_size_train", "4",
                     "eval", "True", "method", "pnp_flow", "problem",
                     "denoising", "steps_pnp", "2", "num_samples", "1",
                     "batch_size_ip", "1", "max_batch", "1",
                     "device", "cpu", "output_root", out])
    msgs = [str(w.message) for w in caught]
    assert not [m for m in msgs if "random init" in m or "Checkpoint" in m
                or "resume" in m], msgs
    d = os.path.join(out, "model", "synthetic", "ot")
    for f in ("loss_training.txt", "model_info.txt", "model_0.msgpack",
              "ema_model_0.msgpack", "model_final.msgpack",
              "ema_model_final.msgpack", "train_state.msgpack"):
        assert os.path.exists(os.path.join(d, f)), f
    losses = np.loadtxt(os.path.join(d, "loss_training.txt"))
    assert losses.shape == (2,) and np.isfinite(losses).all()
    assert args.train_stats["losses"] == pytest.approx(losses.tolist())
    # the JAX trainer's count: every leaf of the flagship's parameter tree
    jargs = JaxCfg({"model": "ot", "dim_image": 16, "num_channels": 3})
    shapes = jax.eval_shape(jreg.define_model(jargs).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes))
    with open(os.path.join(d, "model_info.txt")) as f:
        assert f.read() == f"num_params {n_jax}\n"
    assert os.path.exists(os.path.join(args.save_path, "final_psnr.txt"))
