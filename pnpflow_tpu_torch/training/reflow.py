"""Reflow and distillation of rectified flows (port of
``pnpflow_tpu/training/reflow.py``; reference ``run_lib_reflow.py``,
``losses.py:43-146``, ``sde_lib.py:8-107``).

Reflow retrains a rectified flow on couplings it generates itself: draw z0 ~
N(0, s^2 I), integrate the frozen model's ODE from eps to 1 to get x1, then
train on the (z0, x1) pairs with the config's t-schedule and loss:

  t-schedule  't0' (k = 1 distillation), 't1', 'uniform' (full reflow), or
              an int k (a k-step grid) (``losses.py:89-105``)
  loss        'l2', 'lpips', 'lpips+l2' (``losses.py:118-133``; the LPIPS
              ones need t-schedule 't0' and an ``lpips_fn``)

``model_fn(x, t)`` carries the model's t convention (``rf_main``'s t * 999);
the train steps update a ``training/flow_matching.py:TrainState`` whose
model ``model_fn`` calls, through ``flow_matching.apply_updates`` (backward,
the optimizer, the EMA).  Draws come from a ``torch.Generator`` or are
injected (``z0``, ``t``).  An ``lpips_fn(a, b) -> (B,)`` such as
``metrics/lpips.py``'s ``LPIPS.distances`` is differentiated through its
plain convolutions.
"""

from __future__ import annotations

import numpy as np
import torch

from pnpflow_tpu_torch.ops.ode import odeint
from pnpflow_tpu_torch.training.flow_matching import apply_updates

EPS = 1e-3  # reference losses.py eps default / sde_lib ode eps


def sample_reflow_t(batch_size: int, schedule, eps: float = EPS,
                    T: float = 1.0, generator=None, device=None,
                    dtype=torch.float32):
    """Per-sample times of a reflow t-schedule (``losses.py:89-105``)."""
    if schedule == "t0":
        return torch.full((batch_size,), eps, dtype=dtype, device=device)
    if schedule == "t1":
        return torch.full((batch_size,), T, dtype=dtype, device=device)
    if schedule == "uniform":
        u = torch.rand(batch_size, generator=generator, dtype=dtype,
                       device=device)
        return u * (T - eps) + eps
    if isinstance(schedule, int):
        k = torch.randint(0, schedule, (batch_size,), generator=generator,
                          device=device)
        return k.to(dtype) * (T - eps) / schedule + eps
    raise NotImplementedError("reflow t-schedule: {}".format(schedule))


def make_reflow_loss(model_fn, t_schedule="uniform", loss_type="l2",
                     lpips_fn=None, reduce_mean: bool = True,
                     eps: float = EPS):
    """``loss_fn(z0, x1, t)`` on a pair batch: x_t = t x1 + (1 - t) z0, the
    velocity against x1 - z0 (l2, per-sample mean or half sum), or LPIPS of
    z0 + v against x1, or both."""
    if "lpips" in str(loss_type) and lpips_fn is None:
        raise ValueError(
            "loss_type {} needs an lpips_fn (LPIPS weights)".format(loss_type))
    if "lpips" in str(loss_type) and t_schedule != "t0":
        # the reference asserts this (losses.py:124,127)
        raise ValueError("lpips reflow losses require t_schedule 't0'")

    def loss_fn(z0, x1, t):
        te = t[:, None, None, None]
        xt = te * x1 + (1.0 - te) * z0
        v = model_fn(xt, t)
        b = x1.shape[0]
        if loss_type == "l2":
            per = ((v - (x1 - z0)) ** 2).reshape(b, -1)
            per = per.mean(-1) if reduce_mean else 0.5 * per.sum(-1)
        elif loss_type == "lpips":
            per = lpips_fn(z0 + v, x1)
        elif loss_type == "lpips+l2":
            per = lpips_fn(z0 + v, x1) + ((v - (x1 - z0)) ** 2).reshape(
                b, -1).mean(-1)
        else:
            raise NotImplementedError("reflow loss: {}".format(loss_type))
        return per.mean()

    return loss_fn


def make_reflow_train_step(model_fn, *, t_schedule="uniform", loss_type="l2",
                           lpips_fn=None, reduce_mean: bool = True,
                           ema_decay: float = 0.9999, eps: float = EPS):
    """The step ``(state, z0, x1, generator=None, t=None) -> loss`` on
    pre-generated pairs; ``t`` comes from the schedule unless given."""
    loss_fn = make_reflow_loss(model_fn, t_schedule, loss_type, lpips_fn,
                               reduce_mean, eps)

    def train_step(state, z0, x1, generator=None, t=None):
        if t is None:
            t = sample_reflow_t(x1.shape[0], t_schedule, eps,
                                generator=generator, device=x1.device,
                                dtype=x1.dtype)
        return apply_updates(state, loss_fn(z0, x1, t), ema_decay)

    return train_step


@torch.no_grad()
def generate_reflow_pairs(model_fn, shape, sampler: str = "euler",
                          steps: int = 100, init_noise_scale: float = 1.0,
                          ode_tol: float = 1e-5, eps: float = EPS,
                          generator=None, z0=None, device=None):
    """(z0, x1) pairs from the frozen model (``sde_lib.py:37-107``; the
    reference's 'generate_data_from_z0').  ``sampler`` "euler": ``steps``
    fixed steps; "rk45": adaptive dopri5 at ``ode_tol``; else any
    ``ops/ode.py:odeint`` method.  ``z0`` replaces the draw."""
    if z0 is None:
        z0 = init_noise_scale * torch.randn(tuple(shape), generator=generator,
                                            device=device)

    def vfield(x, t):
        return model_fn(x, torch.full((x.shape[0],), t, dtype=z0.dtype,
                                      device=x.device))

    if sampler == "euler":
        # the reference's euler_ode quirk (sde_lib.py:74-94): the t grid is
        # eps + i/N (1 - eps) but dt = 1/N, so it advances by 1, not 1 - eps
        dt = 1.0 / steps
        f32 = np.float32
        x = z0
        for i in range(steps):
            t = f32(i) / f32(steps) * f32(1.0 - eps) + f32(eps)
            x = x + dt * vfield(x, float(t))
        return z0, x
    method = "dopri5" if sampler == "rk45" else sampler
    return z0, odeint(vfield, z0, eps, 1.0, method=method, steps=steps,
                      rtol=ode_tol, atol=ode_tol)


def make_online_reflow_step(model_fn, *, t_schedule="t0", loss_type="l2",
                            lpips_fn=None, reduce_mean: bool = True,
                            ema_decay: float = 0.9999, gen_steps: int = 20,
                            init_noise_scale: float = 1.0, eps: float = EPS):
    """Online reflow ('train_online_reflow'): each step generates its pair
    batch from the current weights (no gradient, Euler in ``gen_steps``)
    and trains on it at once.  ``(state, shape, generator=None, z0=None,
    t=None) -> loss``."""
    loss_fn = make_reflow_loss(model_fn, t_schedule, loss_type, lpips_fn,
                               reduce_mean, eps)

    def train_step(state, shape, generator=None, z0=None, t=None):
        device = next(state.model.parameters()).device
        z0, x1 = generate_reflow_pairs(
            model_fn, shape, sampler="euler", steps=gen_steps,
            init_noise_scale=init_noise_scale, eps=eps, generator=generator,
            z0=z0, device=device)
        if t is None:
            t = sample_reflow_t(shape[0], t_schedule, eps,
                                generator=generator, device=device,
                                dtype=x1.dtype)
        return apply_updates(state, loss_fn(z0, x1, t), ema_decay)

    return train_step
