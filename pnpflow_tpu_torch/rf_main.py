"""Rectified-flow entry point (port of ``pnpflow_tpu/rf_main.py``): the working
equivalent of the reference's ``image_generation/main.py``.

Modes (reference ``--mode train|eval|reflow``):

  train           flow-matching training of the config's model on the
                  config's data (synthetic smoke data where the dataset is
                  absent), with the config's Adam, warmup and gradient clip
                  (``losses.py:26-52``) and an EMA at ``model.ema_rate``
  sample          samples from the config's sampler (euler or rk45,
                  ``sigma_variance``, ``sample_N``) into ``samples.npz`` and
                  ``samples.png``
  reflow          the config's ``reflow.*`` block: pairs (z0, x1) from the
                  current weights, then training on them with its
                  t-schedule and loss ('train_reflow'), or both in each step
                  ('train_online_reflow')
  generate_pairs  the pair generation alone, into ``reflow_pairs.npz``

Usage::

  python -m pnpflow_tpu_torch.rf_main --config celeba_hq_pytorch_rf_gaussian \\
      --mode train --workdir ./rf_run [--n_iters N] [--opts key value ...]

``--opts`` takes dotted config keys (``training.batch_size 8``) and
``device cpu``: it runs on ``cuda`` unless asked, and raises
without a GPU.  Every mode loads ``<workdir>/state.msgpack`` when present;
train and reflow write it: JAX's raw ``serialization.to_bytes(params)``
tree of the NCSN++, so either package restores what the other wrote (every
shipped config names ``ncsnpp``; the zoo's other families are built by
``models/zoo.py`` but have no state file here).

As in JAX's ``rf_main``:

* the model sees t * 999, with no floor (the restoration adapter's 1e-3
  floor is not applied);
* the optimizer is optax's chain clip_by_global_norm, scale_by_adam (eps
  outside the root), a linear warmup from 0 (:class:`ClippedAdamWarmup`),
  so the first update is exactly zero;
* dropout is off while training: JAX's ``NCSNpp`` defaults to
  ``deterministic=True`` and its ``rf_main`` never passes it, so the module
  stays in eval mode here.  The reference RectifiedFlow trainer applies the
  config's dropout; both packages depart from it there;
* the EMA is updated each step and, as in JAX, not written;
* an LPIPS ``reflow_loss`` warns and falls back to l2 (the library API,
  ``training/reflow.py``, takes an ``lpips_fn``);
* online reflow generates each pair batch in the reflow module's default 20
  Euler steps, whatever ``sampling.sample_N``.

Draws come from ``torch.Generator``s seeded per run, where JAX derives keys
from the iteration; ``mode_train`` takes ``draws`` to inject (z0, t).  The
weights of a new run come from the seeded ``models/zoo.py:init_model``, not
from flax's ``PRNGKey(0)`` init.
"""

from __future__ import annotations

import argparse
import os
import warnings
from ast import literal_eval

import numpy as np
import torch
import torch.nn as nn

from pnpflow_tpu_torch.device import resolve_device, set_fp32_parity_mode
from pnpflow_tpu_torch.utils.config import CfgNode

f32 = np.float32


def _apply_opts(cfg, opts):
    for key, raw in zip(opts[0::2], opts[1::2]):
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                # e.g. a reflow.* block on a config that has none
                node[p] = CfgNode({})
            node = node[p]
        try:
            val = literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        node[parts[-1]] = val
    return cfg


class RFModel(nn.Module):
    """The continuous-time RF convention: ``forward(x, t)`` feeds the
    model ``t * 999`` (``losses.py:116``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, t):
        return self.model(x, t * 999.0)


class ClippedAdamWarmup(torch.optim.Optimizer):
    """optax's ``chain(clip_by_global_norm(grad_clip), scale_by_adam(b1,
    b2, eps), scale_by_learning_rate(linear_schedule(0, lr, warmup)))``,
    JAX's ``rf_main`` optimizer (``rf_main.py:105-113``), in its arithmetic:

    * the clip scales g to (g / norm) * grad_clip unless norm < grad_clip
      (``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to the norm);
    * Adam's bias-corrected moments, u = mu_hat / (sqrt(nu_hat) + eps);
    * the rate lr * min(k, warmup) / warmup at k = 0, 1, ... updates
      before, so the first update is zero.

    Parameters without a gradient (the frozen Fourier W) are left as they
    are, as JAX's zero gradient leaves them."""

    def __init__(self, params, lr: float, warmup: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 1.0):
        params = [p for p in params if p.requires_grad]
        super().__init__(params, dict(lr=lr, warmup=max(int(warmup), 1),
                                      b1=b1, b2=b2, eps=eps,
                                      grad_clip=grad_clip))
        self.count = 0

    def rate(self, count: int) -> float:
        """The warmup schedule at ``count`` updates before (optax's
        ``linear_schedule(0, lr, warmup)``, in float32)."""
        g = self.param_groups[0]
        lr, steps = f32(g["lr"]), g["warmup"]
        frac = f32(1.0) - f32(min(max(count, 0), steps)) / f32(steps)
        return float((f32(0.0) - lr) * frac + lr)

    @torch.no_grad()
    def step(self, closure=None):
        g = self.param_groups[0]
        ps = [p for p in g["params"] if p.grad is not None]
        grads = [p.grad for p in ps]
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        if not bool(norm < g["grad_clip"]):
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, g["grad_clip"])
        for p in ps:
            if not self.state[p]:
                self.state[p] = {"mu": torch.zeros_like(p),
                                 "nu": torch.zeros_like(p)}
        mus = [self.state[p]["mu"] for p in ps]
        nus = [self.state[p]["nu"] for p in ps]
        torch._foreach_mul_(mus, g["b1"])
        torch._foreach_add_(mus, grads, alpha=1.0 - g["b1"])
        torch._foreach_mul_(nus, g["b2"])
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - g["b2"])
        rate = self.rate(self.count)
        self.count += 1
        bc1 = float(f32(1.0) - f32(g["b1"]) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(g["b2"]) ** f32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(denom, g["eps"])
        upd = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
        torch._foreach_add_(ps, upd, alpha=-rate)


def make_optimizer(params, cfg) -> ClippedAdamWarmup:
    """The config's optimizer (``optim.lr``, ``warmup``, ``beta1``, ``eps``,
    ``grad_clip``)."""
    o = cfg.optim
    return ClippedAdamWarmup(params, lr=o.lr, warmup=o.warmup, b1=o.beta1,
                             eps=o.eps, grad_clip=o.grad_clip)


def _model(cfg, device):
    """The config's model behind :class:`RFModel`, float32, in eval mode
    (dropout off, as JAX's deterministic default)."""
    from pnpflow_tpu_torch.models import zoo

    if cfg.model.name != "ncsnpp":
        raise NotImplementedError(
            "rf_main reads and writes the NCSN++'s state file only; "
            f"model.name {cfg.model.name!r} is built by models/zoo.py")
    return RFModel(zoo.create_model(cfg)).to(device).eval()


def _state_path(workdir):
    return os.path.join(workdir, "state.msgpack")


def _load_or_init(rf: RFModel, workdir, seed: int = 0):
    """The seeded init, or the weights of ``<workdir>/state.msgpack``."""
    from pnpflow_tpu_torch.models.registry import (
        checked_state_dict, read_msgpack)
    from pnpflow_tpu_torch.models.zoo import init_model
    from pnpflow_tpu_torch.utils.jax_params import ncsnpp_state_dict_from_flax

    model = rf.model
    path = _state_path(workdir)
    if not os.path.exists(path):
        dev = next(model.parameters()).device
        init_model(model.cpu(), seed=seed).to(dev)
        return
    tree, _ = read_msgpack(path)
    model.load_state_dict(checked_state_dict(
        model, ncsnpp_state_dict_from_flax(tree, model.sigmas)))
    print("restored", path)


def _save(rf: RFModel, workdir):
    from pnpflow_tpu_torch.models.registry import write_msgpack
    from pnpflow_tpu_torch.utils.jax_params import flax_from_ncsnpp_state_dict

    write_msgpack(flax_from_ncsnpp_state_dict(rf.model.state_dict()),
                  _state_path(workdir))


def _train_state(rf: RFModel, cfg):
    from pnpflow_tpu_torch.training.flow_matching import TrainState

    ema = {n: p.detach().clone() for n, p in rf.named_parameters()}
    return TrainState(rf, make_optimizer(rf.parameters(), cfg), ema, 0)


def _data_batches(cfg, n_iters, batch_size, device):
    """Training batches from the data layer; the synthetic smoke data where
    the config's dataset is not on disk."""
    from pnpflow_tpu_torch.data.datasets import (
        DataLoaders, _ArrayDataset, synthetic_images)

    d = cfg.data
    name = {"CIFAR10": "cifar10", "LSUN": "lsun"}.get(
        d.dataset, str(d.dataset).lower())
    try:
        train = DataLoaders(name, batch_size, batch_size,
                            dim_image=d.image_size,
                            num_channels=d.num_channels).load_data()["train"]
    except (ValueError, OSError, ImportError):
        train = None
    if train is None:
        imgs = synthetic_images(max(batch_size * 4, 64), d.image_size,
                                d.num_channels, seed=0)
        train = _ArrayDataset(imgs, batch_size, shuffle=True)
        print("dataset '{}' unavailable — synthetic smoke data".format(name))
    it = 0
    while it < n_iters:
        for x, _ in train:
            if it >= n_iters:
                return
            yield torch.as_tensor(np.asarray(x, np.float32), device=device)
            it += 1


def mode_train(cfg, workdir, n_iters, device, draws=None):
    """Train ``n_iters`` steps; returns {"losses", "step_seconds"} (the
    seconds between steps' ends as the device sees them).  ``draws(i, x1)
    -> (z0, t)`` replaces step i's draws."""
    from pnpflow_tpu_torch.training.flow_matching import (
        _StepClock, make_fm_train_step_precoupled)

    rf = _model(cfg, device)
    _load_or_init(rf, workdir)
    state = _train_state(rf, cfg)
    step = make_fm_train_step_precoupled(
        ema_decay=float(cfg.model.get("ema_rate", 0.999)))
    gen = torch.Generator(device=device).manual_seed(0)
    clock, losses = _StepClock(device), []
    clock.mark()
    for i, x1 in enumerate(_data_batches(cfg, n_iters,
                                         int(cfg.training.batch_size),
                                         device)):
        if draws is None:
            z0 = torch.randn(x1.shape, generator=gen, device=device)
            t = None
        else:
            z0, t = (torch.as_tensor(np.asarray(a), device=device)
                     for a in draws(i, x1))
        loss = float(step(state, z0, x1, gen, t))
        clock.mark()
        losses.append(loss)
        print("iter {} loss {:.5f}".format(i, loss), flush=True)
    _save(rf, workdir)
    print("saved", _state_path(workdir))
    return {"losses": losses, "step_seconds": clock.seconds()}


def _sample_grid(x, path):
    from pnpflow_tpu_torch.utils.reporting import _grid, write_png

    write_png(path, _grid(np.clip(x, 0.0, 1.0)))


def mode_sample(cfg, workdir, n, device):
    """``n`` samples into ``samples.npz`` and ``samples.png``; returns
    {"nfe", "shape"}."""
    from pnpflow_tpu_torch.training.sampling import get_sampling_fn

    rf = _model(cfg, device)
    _load_or_init(rf, workdir)
    d = cfg.data
    shape = (n, d.image_size, d.image_size, d.num_channels)
    sample = get_sampling_fn(
        cfg, rf, shape, device=device,
        inverse_scaler=(lambda x: (x + 1.0) / 2.0) if d.centered
        else (lambda x: x))
    x, nfe = sample(torch.Generator(device=device).manual_seed(0))
    x = x.float().cpu().numpy()
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "samples.npz")
    np.savez(out, samples=x)
    print("sampled", x.shape, "nfe", nfe, "->", out)
    _sample_grid(x, os.path.join(workdir, "samples.png"))
    return {"nfe": nfe, "shape": list(x.shape)}


def mode_reflow(cfg, workdir, n_iters, device):
    """``n_iters`` reflow steps; returns {"losses"}."""
    from pnpflow_tpu_torch.training.reflow import (
        generate_reflow_pairs, make_online_reflow_step,
        make_reflow_train_step)

    rf = _model(cfg, device)
    _load_or_init(rf, workdir)
    r = cfg.reflow
    loss_type = r.reflow_loss
    if "lpips" in str(loss_type):
        warnings.warn(
            "reflow_loss {} needs LPIPS weights — falling back to l2 "
            "(pass an lpips_fn via the library API for the real loss)"
            .format(loss_type))
        loss_type = "l2"
    bs = int(cfg.training.batch_size)
    d = cfg.data
    shape = (bs, d.image_size, d.image_size, d.num_channels)
    state = _train_state(rf, cfg)
    ema = float(cfg.model.get("ema_rate", 0.9999))
    gen = torch.Generator(device=device).manual_seed(0)
    losses = []
    if r.reflow_type == "train_online_reflow":
        step = make_online_reflow_step(rf, t_schedule=r.reflow_t_schedule,
                                       loss_type=loss_type, ema_decay=ema)
        for i in range(n_iters):
            losses.append(float(step(state, shape, gen)))
            print("iter {} loss {:.5f}".format(i, losses[-1]), flush=True)
    else:
        step = make_reflow_train_step(rf, t_schedule=r.reflow_t_schedule,
                                      loss_type=loss_type, ema_decay=ema)
        steps = int(cfg.sampling.get("sample_N", 100))
        for i in range(n_iters):
            z0, x1 = generate_reflow_pairs(rf, shape, sampler="euler",
                                           steps=steps, generator=gen,
                                           device=device)
            losses.append(float(step(state, z0, x1, gen)))
            print("iter {} loss {:.5f}".format(i, losses[-1]), flush=True)
    _save(rf, workdir)
    print("saved", _state_path(workdir))
    return {"losses": losses}


def mode_generate_pairs(cfg, workdir, device):
    """``reflow.total_number_of_samples`` pairs into ``reflow_pairs.npz``;
    returns {"pairs"}."""
    from pnpflow_tpu_torch.training.reflow import generate_reflow_pairs

    rf = _model(cfg, device)
    _load_or_init(rf, workdir)
    d = cfg.data
    total = int(cfg.reflow.get("total_number_of_samples", 64))
    bs = min(int(cfg.training.batch_size), total)
    shape = (bs, d.image_size, d.image_size, d.num_channels)
    gen = torch.Generator(device=device).manual_seed(0)
    zs, xs, done = [], [], 0
    while done < total:
        z0, x1 = generate_reflow_pairs(
            rf, shape, sampler="euler",
            steps=int(cfg.sampling.get("sample_N", 100)), generator=gen,
            device=device)
        zs.append(z0.cpu().numpy())
        xs.append(x1.float().cpu().numpy())
        done += bs
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(workdir, "reflow_pairs.npz")
    np.savez(out, z0=np.concatenate(zs)[:total],
             x1=np.concatenate(xs)[:total])
    print("wrote {} pairs -> {}".format(total, out))
    return {"pairs": total}


def main(argv=None):
    """Parse JAX ``rf_main``'s flags and run one mode; returns the mode's
    statistics."""
    from pnpflow_tpu_torch.config.rf_configs import available, get_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help="one of: {}".format(", ".join(available())))
    p.add_argument("--mode", required=True,
                   choices=["train", "sample", "reflow", "generate_pairs"])
    p.add_argument("--workdir", default="./rf_run")
    p.add_argument("--n_iters", type=int, default=100)
    p.add_argument("--n_samples", type=int, default=16)
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    ns = p.parse_args(argv)

    cfg = _apply_opts(get_config(ns.config), ns.opts)
    device = resolve_device(cfg.get("device"))
    if device.type == "cuda":
        set_fp32_parity_mode()
    if ns.mode == "train":
        return mode_train(cfg, ns.workdir, ns.n_iters, device)
    if ns.mode == "sample":
        return mode_sample(cfg, ns.workdir, ns.n_samples, device)
    if ns.mode == "reflow":
        return mode_reflow(cfg, ns.workdir, ns.n_iters, device)
    return mode_generate_pairs(cfg, ns.workdir, device)


if __name__ == "__main__":
    main()
