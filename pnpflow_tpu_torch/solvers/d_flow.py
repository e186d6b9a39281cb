"""D-Flow (Ben-Hamu et al.; port of ``pnpflow_tpu/solvers/d_flow.py``).

1. Invert the measurement: z0 = ODE(H_adj(y), t: 1 -> 0) by adaptive
   dopri5 at rtol = atol = 1e-5, without a gradient (``ops/ode.py``);
2. blend z = sqrt(alpha) z0 + sqrt(1-alpha) eps, eps from a generator
   seeded 1000 + batch;
3. minimise over z with ``torch.optim.LBFGS(history_size=100,
   line_search_fn="strong_wolfe", max_iter=LBFGS_iter)``, stepped
   ``max_iter`` times, as the upstream reference does:

       loss(z) = sum_b ||H(T(z)) - y||^2
                 + lmbda (0.5 clip(||z||^2) - (d-1) log(||z|| + 1e-5))

   where T(z) is ``steps_euler - 1`` midpoint steps of the flow from
   start_time to 1, each under one non-reentrant ``torch.utils.checkpoint``
   (JAX: ``jax.checkpoint`` per scan step), differentiated end to end;
   under ``remat`` each model forward is checkpointed again inside its
   step, as JAX nests ``jax.checkpoint(apply)`` in the step's.

The JAX package runs optax's ``lbfgs`` with a zoom line search instead,
with torch's stopping tests in an early-exit loop; the two optimisers take
different trajectories from the same start, an intended divergence (ROADMAP
queue 1, item 8).  T(z) and the loss and its gradient are held to JAX's.
JAX's ``--opts lbfgs_early_exit`` knob is accepted and changes nothing:
torch's LBFGS applies the reference's own stopping tests.
With ``fused_norm True`` every U-Net GroupNorm runs the ``groupnorm_swish``
kernel forward (again in each checkpoint's recomputation) and its plain
backward; the NCSN++'s ``upfirdn2d`` runs forward and in the adjoint
geometry as its backward.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pnpflow_tpu_torch.ops.ode import odeint_dopri5
from pnpflow_tpu_torch.solvers.base import Solver

f32 = np.float32


def make_forward_flow(model_fn, steps_euler: int, start_time: float):
    """T(z): ``steps_euler - 1`` midpoint steps from start_time to 1, one
    checkpoint each; the times in float32 as JAX's scan computes them."""
    delta = (1.0 - start_time) / (steps_euler - 1)
    half, full = float(f32(delta / 2.0)), float(f32(delta))

    def step(z, t1, t2):
        mid = z + half * model_fn(z, t1)
        return z + full * model_fn(mid, t2)

    def forward(z):
        for i in range(steps_euler - 1):
            t = f32(start_time) + f32(delta) * f32(i)
            t1 = torch.full((z.shape[0],), float(t), dtype=torch.float32,
                            device=z.device)
            t2 = torch.full_like(t1, float(t + f32(delta / 2.0)))
            z = checkpoint(step, z, t1, t2, use_reentrant=False)
        return z

    return forward


def make_loss(forward, H, y, lmbda: float):
    """The D-Flow objective of a latent batch z (a scalar)."""

    def loss_fn(z):
        d = z.shape[1] * z.shape[2] * z.shape[3]
        norm = (z ** 2).sum(dim=(1, 2, 3)).sqrt()
        reg = 0.5 * torch.clamp(norm ** 2, -1e6, 1e6) - (d - 1) * torch.log(
            norm + 1e-5)
        fid = ((H(forward(z)) - y) ** 2).sum(dim=(1, 2, 3))
        return (fid + lmbda * reg).sum()

    return loss_fn


def lbfgs_solve(loss_fn, z, *, max_iter: int, lbfgs_iter: int):
    """``max_iter`` steps of ``torch.optim.LBFGS`` from z -> z."""
    z = z.detach().clone().requires_grad_()
    opt = torch.optim.LBFGS([z], max_iter=lbfgs_iter, history_size=100,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = loss_fn(z)
        loss.backward()
        # LBFGS flattens the gradient with view(-1); the U-Net's gradient
        # reaches z through a channels-last view of its first conv
        z.grad = z.grad.contiguous()
        return loss

    for _ in range(max_iter):
        opt.step(closure)
    return z.detach()


class DFlow(Solver):
    """Reference-compatible wrapper around :func:`make_forward_flow`,
    :func:`make_loss` and :func:`lbfgs_solve`."""

    differentiates = True

    def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                    batch, report_cb=None, z_init=None):
        """``z_init`` replaces the inverted, blended latent (the seam for
        the tests)."""
        args = self.args
        fwd = self.model.forward
        if z_init is None:
            def vfield(z, t):
                return fwd(z, torch.full((z.shape[0],), t,
                                         dtype=torch.float32,
                                         device=z.device))

            z0 = odeint_dopri5(vfield, degradation.H_adj(noisy_img), 1.0,
                               0.0, rtol=1e-5, atol=1e-5)
            gen = torch.Generator(device=z0.device).manual_seed(
                1000 + int(batch))
            alpha = float(args.alpha)
            z_init = math.sqrt(alpha) * z0 + math.sqrt(1.0 - alpha) * (
                torch.randn(z0.shape, generator=gen, device=z0.device,
                            dtype=z0.dtype))
        forward = make_forward_flow(self.model.grad_forward,
                                    int(args.steps_euler),
                                    float(args.start_time))
        z = lbfgs_solve(
            make_loss(forward, degradation.H, noisy_img, float(args.lmbda)),
            z_init, max_iter=int(args.max_iter),
            lbfgs_iter=int(args.LBFGS_iter))
        return forward(z), int(args.max_iter) - 1
