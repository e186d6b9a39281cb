"""PnP-Flow (port of ``pnpflow_tpu/solvers/pnp_flow.py``).

For time steps t = i/N, i = 0..N-1:

  1. data-fidelity gradient step:
       gaussian: z = x - gamma(t) * H_adj(H x - y) / sigma^2, with the
       learning rate pre-scaled by sigma^2, so the effective step is
       gamma(t) * lr_pnp * H_adj(Hx - y);
       laplace: the subgradient H_adj(2 * heaviside(Hx - y, 0) - 1) / sigma
       of ||Hx - y||_1, the learning rate pre-scaled by sigma;
  2. Monte-Carlo averaged flow denoiser: num_samples draws of
       z~ = t z + (1-t) eps,   D(z~, t) = z~ + (1-t) v(z~, t), averaged.

The MC samples are folded into the batch, sample-major, so one U-Net
forward sees S*B images.  ``t`` is computed in float32 as
``float32(i) * float32(1/N)``, as the JAX scan does.
"""

from __future__ import annotations

import numpy as np
import torch

from pnpflow_tpu_torch.solvers.base import Solver, draw_rows


def _gamma(style: str, lr, t, alpha: float):
    """Step-size schedule in float32 arithmetic (``lr``, ``t`` float32)."""
    f32 = np.float32
    if style == "1_minus_t":
        return lr * (f32(1) - t)
    if style == "sqrt_1_minus_t":
        return lr * np.sqrt(f32(1) - t)
    if style == "alpha_1_minus_t":
        return lr * (f32(1) - t) ** f32(alpha)
    return lr


def make_pnp_flow_solver(model_fn, H, H_adj, *, steps: int, num_samples: int,
                         lr_pnp: float, gamma_style: str, alpha: float,
                         noise_type: str, sigma_noise: float, eps_seq=None,
                         rows=None):
    """Build ``solve(y, x, generator, start_iter, n_iters) -> x``, running
    ``n_iters`` PnP steps from global iteration ``start_iter``.

    ``model_fn(x_nhwc, t_vec) -> v``.  ``eps_seq`` is the verification
    seam: a tensor ``(steps, num_samples, b, h, w, c)`` holding the MC noise
    of every global iteration, in place of draws from ``generator``.
    ``rows`` (start, stop, total): draw the MC noise of the whole batch of
    ``total`` and keep these images' (a fanned-out shard).
    """
    if noise_type == "gaussian":
        lr = np.float32(sigma_noise**2 * lr_pnp)
    elif noise_type == "laplace":
        lr = np.float32(sigma_noise * lr_pnp)
    else:
        raise ValueError("Noise type not supported")
    delta = np.float32(1.0 / steps)

    def grad_datafit(x, y):
        r = H(x) - y
        if noise_type == "gaussian":
            return H_adj(r) / sigma_noise**2
        return H_adj(2.0 * (r > 0).to(r.dtype) - 1.0) / sigma_noise

    def denoise_mc(z, t, generator, global_iter):
        b, h, w, c = z.shape
        if eps_seq is not None:
            eps = eps_seq[global_iter].to(device=z.device, dtype=z.dtype)
        else:
            eps = draw_rows(
                lambda s: torch.randn(s, generator=generator,
                                      device=z.device, dtype=z.dtype),
                (num_samples, b, h, w, c), rows, dim=1)
        t_, s_ = float(t), float(np.float32(1) - t)
        flat = (t_ * z[None] + s_ * eps).reshape(num_samples * b, h, w, c)
        t_vec = torch.full((num_samples * b,), t_, dtype=torch.float32,
                           device=z.device)
        denoised = flat + s_ * model_fn(flat, t_vec)
        return denoised.reshape(num_samples, b, h, w, c).mean(dim=0)

    def solve(y, x, generator, start_iter: int, n_iters: int):
        for i in range(start_iter, start_iter + n_iters):
            t = np.float32(i) * delta
            lr_t = float(_gamma(gamma_style, lr, t, alpha))
            z = x - lr_t * grad_datafit(x, y)
            x = denoise_mc(z, t, generator, i)
        return x

    return solve


def report_points(steps: int) -> list:
    """Iterations after which the reference reports: i % 50 == 0 or
    i % (steps // 10) == 0."""
    stride = max(steps // 10, 1)
    return [i for i in range(steps) if i % 50 == 0 or i % stride == 0]


class PnPFlow(Solver):
    """Reference-compatible wrapper around :func:`make_pnp_flow_solver`."""

    def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                    batch, report_cb=None):
        args = self.args
        steps = int(args.steps_pnp)
        solve = make_pnp_flow_solver(
            self.model.forward, degradation.H, degradation.H_adj,
            steps=steps, num_samples=int(args.num_samples),
            lr_pnp=float(args.lr_pnp), gamma_style=args.gamma_style,
            alpha=float(getattr(args, "alpha", 1.0)),
            noise_type=args.noise_type, sigma_noise=float(sigma_noise),
            rows=self.rows,
        )
        gen = torch.Generator(device=noisy_img.device).manual_seed(
            1000 + int(batch))
        x = degradation.H_adj(torch.ones_like(noisy_img))
        done = 0
        for r in (report_points(steps) if report_cb is not None else []):
            x = solve(noisy_img, x, gen, done, r + 1 - done)
            done = r + 1
            report_cb(x, r)
        x = solve(noisy_img, x, gen, done, steps - done)
        return x, steps - 1

