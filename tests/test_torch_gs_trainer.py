"""The port's gradient-step trainer (``pnpflow_tpu_torch/training/
denoiser.py:GradientStepTrainer``) and ``train True model gradient_step``
beside the JAX package's trainer: the sigma sequence, the learning-rate
milestones on the optimizer, the checkpoints each package reads of the
other's, and the CLI's file set.  The step's numbers are held to JAX's in
``tests/test_torch_gs_denoiser.py``.

The model is ``tests/test_solvers.py``'s U-Net (32x32, 3 channels, ch 32,
mult (1, 2), one block, attention at 16); checkpoints carried across are
equal bit for bit (each side only transposes float32 arrays).
"""

import functools
import os
import random
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.data import DataLoaders as JaxLoaders
from pnpflow_tpu.models import registry as jreg
from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.training import denoiser as jd
from pnpflow_tpu.utils.config import CfgNode as JaxCfg
from pnpflow_tpu_torch.data import datasets
from pnpflow_tpu_torch.main import main
from pnpflow_tpu_torch.models import registry as treg
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.training import denoiser as td
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import (
    flax_from_state_dict, state_dict_from_flax)

DIM, B = 32, 2
CFG = dict(input_channels=3, input_height=DIM, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,))
SIGMA = 0.13
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def case():
    """(params, y, u): random flax parameters at a real scale, images and
    noise, from numpy seeds."""
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(JaxUNet(**CFG).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, DIM, DIM, 3)), jnp.zeros((1,)))
    params = jax.tree_util.tree_map(
        lambda leaf: (rng.normal(size=leaf.shape) / np.sqrt(
            np.prod(leaf.shape[:-1]) if len(leaf.shape) > 1 else 10.0)
        ).astype(np.float32), shapes)
    y = np.tanh(rng.normal(size=(B, DIM, DIM, 3)) * 0.4).astype(np.float32)
    u = rng.normal(size=y.shape).astype(np.float32)
    return params, y, u


def _t(a):
    return torch.from_numpy(np.array(a))


def _trainer(tmp_path, model=None, **extra):
    args = dict({"dataset": "synthetic", "model": "gradient_step",
                 "dim_image": DIM, "num_channels": 3, "lr": LR,
                 "num_epoch": 1, "seed": 0, "output_root": str(tmp_path),
                 "batch_size_train": B, "device": "cpu"}, **extra)
    if model is None:
        model = VelocityUNet(**CFG, fused_norm=True)
        model.load_state_dict(state_dict_from_flax(case()[0]))
    return td.GradientStepTrainer(CfgNode(args), model=model)


def test_sigma_sequence_equals_jax(tmp_path, monkeypatch):
    """Both trainers draw sigma from Python's ``random.Random(seed)``, one
    draw a step: JAX's and the port's sequences over 2 epochs of the
    synthetic split at batch 128 (2 steps an epoch) are equal."""
    seen = {"jax": [], "port": []}
    jtr = jd.GradientStepTrainer(JaxCfg({
        "dataset": "synthetic", "model": "gradient_step", "dim_image": 8,
        "num_channels": 1, "lr": LR, "num_epoch": 2, "seed": 4,
        "batch_size_train": 128, "output_root": str(tmp_path / "jax")}),
        model=JaxUNet(**dict(CFG, input_channels=1, input_height=8)))

    def jax_step(state, y, sigma, key):
        seen["jax"].append(sigma)
        return state, 0.0, 0.0

    jtr.train_step = jax_step
    monkeypatch.setattr(jtr, "save_params", lambda state, name: None)
    jtr.train(JaxLoaders("synthetic", 128, 128, dim_image=8,
                         num_channels=1).load_data())

    tr = _trainer(tmp_path, model=VelocityUNet(**dict(
        CFG, input_channels=1, input_height=8), fused_norm=True),
        dim_image=8, num_channels=1, num_epoch=2, seed=4,
        batch_size_train=128)

    def port_step(state, y, sigma, generator=None, u=None, v0=None):
        seen["port"].append(sigma)
        return torch.zeros(()), torch.zeros(())

    tr.train_step = port_step
    tr.train(datasets.DataLoaders("synthetic", 128, 128, dim_image=8,
                                  num_channels=1).load_data())
    r = random.Random(4)
    assert seen["jax"] == seen["port"] == tr.stats["sigmas"] == [
        r.uniform(0, 0.25) for _ in range(4)]


def test_lr_milestone_sets_the_adam_learning_rate(tmp_path):
    """At ``lr_milestone_steps 1`` the update after 300 updates runs at half
    the learning rate; without it the learning rate stays constant, as the
    reference's unstepped MultiStepLR leaves it."""
    params, y, u = case()
    for milestone, want in ((1, 0.5 * LR), (0, LR)):
        tr = _trainer(tmp_path, lr_milestone_steps=milestone)
        st = tr.init_state()
        st.step = 300
        tr.train_step(st, _t(y), SIGMA, u=_t(u))
        assert st.optimizer.param_groups[0]["lr"] == want
        assert st.step == 301


def test_checkpoints_read_both_ways(tmp_path):
    """The JAX trainer's checkpoint loads into the port's model, and the
    port trainer's into JAX's ``load_params``, bit for bit, with the
    ``gradient_step`` fingerprint."""
    params, _, _ = case()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    base = {"dataset": "synthetic", "model": "gradient_step",
            "dim_image": DIM, "num_channels": 3, "lr": LR, "num_epoch": 1}
    jtr = jd.GradientStepTrainer(JaxCfg(dict(base, output_root=str(jdir))),
                                 model=JaxUNet(**CFG))
    jtr.save_params({"params": params}, "model_final.msgpack")
    m = VelocityUNet(**CFG, fused_norm=True)
    treg.load_params(m, CfgNode(dict(base, output_root=str(jdir))),
                     require=True)
    for k, v in state_dict_from_flax(params).items():
        assert torch.equal(m.state_dict()[k], v), k

    tr = _trainer(pdir)
    st = tr.init_state(seed=2)
    tr.save_params(st, "model_final.msgpack")
    got = jreg.load_params(JaxUNet(**CFG), JaxCfg(dict(
        base, output_root=str(pdir))), require=True)
    want = flax_from_state_dict(dict(st.model.named_parameters()))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), b)


def test_cli_trains_then_restores_with_pnp_gs(tmp_path, monkeypatch):
    """``train True eval True method pnp_gs`` with the full-width
    ``gradient_step`` U-Net at 16x16 on the CPU, over a synthetic train
    split cut to 8 images (2 steps at batch 4): the JAX trainer's file set
    and line formats, finite losses, the checkpoint set, and the eval half
    restoring from ``model_final.msgpack``."""
    orig = datasets.synthetic_images
    monkeypatch.setattr(datasets, "synthetic_images",
                        lambda n, dim, ch, seed=0: orig(
                            8 if seed == 0 else n, dim, ch, seed))
    out = str(tmp_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        args = main(["--opts", "dataset", "synthetic", "dim_image", "16",
                     "model", "gradient_step", "train", "True",
                     "num_epoch", "1", "batch_size_train", "4",
                     "eval", "True", "method", "pnp_gs", "problem",
                     "denoising", "max_iter", "2", "batch_size_ip", "1",
                     "max_batch", "1", "device", "cpu",
                     "output_root", out])
    msgs = [str(w.message) for w in caught]
    assert not [m for m in msgs if "random init" in m or "Checkpoint" in m],\
        msgs
    d = os.path.join(out, "model", "synthetic", "gradient_step")
    for f in ("gradient_step_denoiser_0.msgpack",
              "gradient_step_denoiser_final.msgpack", "model_final.msgpack"):
        assert os.path.exists(os.path.join(d, f)), f
    r = os.path.join(out, "results", "synthetic", "gradient_step")
    with open(os.path.join(r, "loss_training.txt")) as f:
        lines = f.read().splitlines()
    assert [ln.rsplit(" ", 1)[0] for ln in lines] == [
        "Epoch: 0, iter: 0, Loss:", "Epoch: 0, iter: 1, Loss:"]
    losses = [float(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert np.isfinite(losses).all() and losses == args.train_stats["losses"]
    with open(os.path.join(r, "losses_gradient_step.txt")) as f:
        assert f.read().startswith(f"Epoch: 0, Loss: {losses[-1]}, PSNR: ")
    with open(os.path.join(r, "model_info.txt")) as f:
        info = f.read().splitlines()
    n = sum(p.numel() for p in treg.define_model(args, train=True)
            .parameters())
    assert info == ["PARAMETERS", f"Number of parameters: {n}",
                    "Number of epochs: 1", "Batch size: 4",
                    f"Learning rate: {args.lr}"]
    assert os.path.exists(os.path.join(args.save_path, "final_psnr.txt"))
