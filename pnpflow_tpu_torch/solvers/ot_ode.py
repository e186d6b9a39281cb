"""OT-ODE (Pokle et al.; port of ``pnpflow_tpu/solvers/ot_ode.py``).

From t0 = start_time, for iterations i = int(steps * t0) .. steps-1 with
t = i / steps (float32):

    v    = v(x, t)
    rt2  = (1-t)^2 / ((1-t)^2 + t^2)
    d    = y - H(x + (1-t) v)
    sol  = solve (rt2 H H^T + sigma^2 I) sol = d          # per problem
    vec  = H_adj(sol)
    g    = vec + (1-t) (dv/dx)^T vec                       # model VJP
    x   += delta (v + ((1-t)/t) gamma(t) g)

with the closed forms of the JAX solver: masks divide by mask*rt2 +
sigma^2, denoising by rt2 + sigma^2, plain super-resolution by rt2' +
sigma^2 with the reference's literal rt2' = (1-t)^2 / ((1-t)^2 +
delta*i^2) (a quirk kept for parity), FFT deblurring in Fourier space, and
anything else (bicubic super-resolution) through batched GMRES
(``ops/linalg.py``).  The model VJP is ``torch.autograd.grad(v, x,
grad_outputs=vec)`` (under ``remat`` the forward is checkpointed and
recomputed by the VJP): with ``fused_norm True`` the U-Net's GroupNorms run the
``groupnorm_swish`` kernel forward and their plain backward; the NCSN++'s
FIR resampling runs ``upfirdn2d`` forward and, as its backward, the same
kernel in the adjoint geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from pnpflow_tpu_torch.ops.linalg import gmres
from pnpflow_tpu_torch.solvers.base import Solver, draw_rows

_MASK_PROBLEMS = ("inpainting", "random_inpainting", "paintbrush_inpainting")
f32 = np.float32


def make_ot_ode_solver(model_fn, degradation, *, problem: str, steps: int,
                       gamma: str, sigma_noise: float):
    """Build ``solve(y, x, start_iter, n_iters) -> x``, running ``n_iters``
    steps from global iteration ``start_iter``; ``model_fn(x, t_vec)``."""
    H, H_adj = degradation.H, degradation.H_adj
    delta = 1.0 / steps
    s2 = sigma_noise ** 2

    if problem in _MASK_PROBLEMS:
        mask = degradation.mask

        def solve_C(d, rt2, i):
            return d / (mask * float(rt2) + s2)

    elif problem == "denoising":

        def solve_C(d, rt2, i):
            return d / float(rt2 + f32(s2))

    elif problem == "superresolution":
        # plain decimation: diag(H H^T) = 1, and the reference's literal
        # rt2' = (1-t)^2 / ((1-t)^2 + delta * i^2) (ot_ode.py:96-97)
        def solve_C(d, rt2, i):
            t = f32(delta) * i
            rt2_ref = (f32(1) - t) ** 2 / ((f32(1) - t) ** 2
                                          + f32(delta) * i ** 2)
            return d / float(rt2_ref + f32(s2))

    elif problem == "gaussian_deblurring_FFT":
        filt = degradation.fft_filter

        def solve_C(d, rt2, i):
            inv = float(rt2) * filt * filt.conj() + s2
            return torch.fft.ifft2(torch.fft.fft2(d, dim=(1, 2)) / inv,
                                   dim=(1, 2)).real

    else:  # GMRES on C = rt2 H H_adj + s2 I

        def solve_C(d, rt2, i):
            def C_op(z):
                return float(rt2) * H(H_adj(z)) + s2 * z

            return gmres(C_op, d, maxiter=100)[0]

    def gamma_fn(t):
        if gamma == "constant":
            return f32(1)
        if gamma == "gamma_t":
            return np.sqrt(t / (t ** 2 + (f32(1) - t) ** 2))
        raise ValueError("Unknown gamma: {}".format(gamma))

    def step(y, x, it: int):
        i = f32(it)
        t = i * f32(delta)
        t_vec = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                           device=x.device)
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            vt = model_fn(xg, t_vec)
            rt2 = (f32(1) - t) ** 2 / ((f32(1) - t) ** 2 + t ** 2)
            x1_hat = x + float(f32(1) - t) * vt.detach()
            vec = H_adj(solve_C(y - H(x1_hat), rt2, i))
            (vjp,) = torch.autograd.grad(vt, xg, grad_outputs=vec)
        g = vec + float(f32(1) - t) * vjp
        coef = (f32(1) - t) / t * gamma_fn(t)
        return x + float(f32(delta)) * (vt.detach() + float(coef) * g)

    def solve(y, x, start_iter: int, n_iters: int):
        for it in range(start_iter, start_iter + n_iters):
            x = step(y, x, it)
        return x

    return solve


def report_points(steps: int, first_iter: int) -> list:
    """Iterations after which the reference reports: i % 10 == 0 or
    i % (steps // 10) == 0 (ot_ode.py:150,200-201)."""
    stride = max(steps // 10, 1)
    return [i for i in range(first_iter, steps)
            if i % 10 == 0 or i % stride == 0]


class OTOde(Solver):
    """Reference-compatible wrapper around :func:`make_ot_ode_solver`."""

    differentiates = True

    def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                    batch, report_cb=None, x_init=None):
        """``x_init`` replaces the initialisation x = t0 H_adj(y) + (1-t0)
        eps, eps drawn from a generator seeded 1000 + batch (the seam
        through which the tests give both packages one start).  eps has
        H_adj(y)'s shape: JAX draws it in y's, which for super-resolution
        does not broadcast against H_adj(y)."""
        args = self.args
        steps = int(args.steps_ode)
        start_time = float(args.start_time)
        first_iter = int(steps * start_time)
        solve = make_ot_ode_solver(
            self.model.grad_forward, degradation, problem=args.problem,
            steps=steps, gamma=args.gamma, sigma_noise=float(sigma_noise))
        if x_init is None:
            gen = torch.Generator(device=noisy_img.device).manual_seed(
                1000 + int(batch))
            y_adj = degradation.H_adj(noisy_img)
            eps = draw_rows(
                lambda s: torch.randn(s, generator=gen, device=y_adj.device,
                                      dtype=y_adj.dtype),
                y_adj.shape, self.rows)
            x_init = start_time * y_adj + (1.0 - start_time) * eps
        x, done = x_init, first_iter
        for r in (report_points(steps, first_iter)
                  if report_cb is not None else []):
            x = solve(noisy_img, x, done, r + 1 - done)
            done = r + 1
            report_cb(x, r)
        x = solve(noisy_img, x, done, steps - done)
        return x, steps - 1
