"""Flow-Priors (OC-Flow / Zhang et al.; port of
``pnpflow_tpu/solvers/flow_priors.py``).

x ~ N(0, I); for each of N ODE steps at t = i/N (1 - eps_t) + eps_t, run K
inner Adam(eta) steps on x minimising

    lmbda ||H(x + v(x,t) dt) - y_next||^2      (gaussian; L1 for laplace)
    + tr(dv/dx) dt                              (Hutchinson, one probe)
    + [iteration 0 only]  0.5 ||x||^2

with y_next = (t+dt) y + (1-(t+dt)) H(x_init) annealing the measurement;
iterations after the first add the interpolation-likelihood gradient
-1/(1-t) (-x + t v(x,t)), v detached; then x += v(x, t) dt.  Adam starts
afresh every outer iteration (the reference re-creates it), written out as
optax's ``adam`` computes it (eps 1e-8, eps_root 0).

The trace term is a JVP inside a gradient: ``torch.func.jvp`` of the model
on an x that records a gradient, then ``torch.autograd.grad``, one probe, no
``vmap``.  ``torch.func.grad`` around the JVP computes the same but wraps
every operation at a second transform level, which about doubles the
host's work per step, and the 4-image U-Net step is host-bound.  With
``fused_norm True`` every U-Net GroupNorm runs the ``groupnorm_swish``
kernel forward, its plain forward-mode rule for the tangent and its plain
backward; the NCSN++'s ``upfirdn2d`` runs the kernel forward, on the
tangent and in the adjoint geometry.  The JVP's primal output is the v of
the fidelity term and of the likelihood gradient (the JAX solver evaluates
v(x, t) three times at the same x; one evaluation is the same value).

Seams: ``x_init`` and ``probes`` (N, K, B, H, W, C Rademacher signs) replace
the draws from a generator seeded 1000 + batch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pnpflow_tpu_torch.solvers.base import Solver, draw_rows

f32 = np.float32
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def rademacher(shape, generator, device):
    """+-1 with probability 1/2 each (rand < 0.5 -> -1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.where(u < 0.5, -1.0, 1.0)


def make_flow_priors_solver(model_fn, H, *, N: int, K: int, lmbda: float,
                            eta: float, start_time: float, noise_type: str,
                            remat: bool = False):
    """Build ``solve(y, h_x_init, x, probe) -> x``; ``probe(i, k)`` gives
    the Rademacher probe of outer iteration i, inner step k.  ``remat``
    runs each JVP inside one non-reentrant checkpoint, so the gradient
    recomputes it: the checkpoint goes around the whole ``torch.func.jvp``,
    since one around the forward inside it saves other tensors in the
    recomputation than in the first pass, which the backward refuses."""
    if start_time > 0.0:
        eps_t = start_time
        dt = (1.0 - eps_t) / N
    else:
        dt = 1.0 / N
        eps_t = 1e-3
    dt32 = float(f32(dt))

    def adam_step(x, g, mu, nu, count):
        mu = float(f32(1 - ADAM_B1)) * g + float(f32(ADAM_B1)) * mu
        nu = float(f32(1 - ADAM_B2)) * g ** 2 + float(f32(ADAM_B2)) * nu
        bc1 = f32(1) - f32(ADAM_B1) ** f32(count)
        bc2 = f32(1) - f32(ADAM_B2) ** f32(count)
        upd = (mu / float(bc1)) / ((nu / float(bc2)).sqrt() + ADAM_EPS)
        return x + float(f32(-eta)) * upd, mu, nu

    def solve(y, h_x_init, x, probe):
        for i in range(N):
            num_t = f32(i) / f32(N) * f32(1.0 - eps_t) + f32(eps_t)
            tn = num_t + f32(dt)
            y_next = float(tn) * y + float(f32(1) - tn) * h_x_init
            t_vec = torch.full((x.shape[0],), float(num_t),
                               dtype=torch.float32, device=x.device)
            fwd = lambda z: model_fn(z, t_vec)  # noqa: E731

            def jvp(x, eps):
                return torch.func.jvp(fwd, (x,), (eps,))

            def grad_fn(x, eps):
                """(d loss / dx, v(x, t)), v detached."""
                with torch.enable_grad():
                    x = x.detach().requires_grad_()
                    if remat:
                        v, jv = checkpoint(jvp, x, eps, use_reentrant=False)
                    else:
                        v, jv = jvp(x, eps)
                    resid = H(x + v * dt32) - y_next
                    if noise_type == "gaussian":
                        fid = lmbda * (resid ** 2).sum(dim=(1, 2, 3))
                    else:
                        fid = lmbda * resid.abs().sum(dim=(1, 2, 3))
                    loss = fid + (jv * eps).sum(dim=(1, 2, 3)) * dt32
                    if i == 0:
                        loss = loss + 0.5 * (x ** 2).sum(dim=(1, 2, 3))
                    (g,) = torch.autograd.grad(loss.sum(), x)
                return g, v.detach()

            mu = nu = torch.zeros_like(x)
            for k in range(K):
                g, pred = grad_fn(x, probe(i, k))
                if i > 0:
                    g = g + float(f32(-1.0) / (f32(1) - num_t)) * (
                        -x + float(num_t) * pred)
                x, mu, nu = adam_step(x, g, mu, nu, k + 1)
            x = x + fwd(x) * dt32
        return x

    return solve


class FlowPriors(Solver):
    """Reference-compatible wrapper around :func:`make_flow_priors_solver`."""

    differentiates = True

    def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                    batch, report_cb=None, x_init=None, probes=None):
        args = self.args
        N, K = int(args.N), int(args.K)
        solve = make_flow_priors_solver(
            self.model.forward, degradation.H, N=N, K=K,
            lmbda=float(args.lmbda), eta=float(args.eta),
            start_time=float(args.start_time), noise_type=args.noise_type,
            remat=self.model.remat)
        dev = noisy_img.device
        gen = torch.Generator(device=dev).manual_seed(1000 + int(batch))
        if x_init is None:
            # in the clean image's shape (flow_priors.py:57-58)
            x_init = draw_rows(
                lambda s: torch.randn(s, generator=gen, device=dev,
                                      dtype=clean_img.dtype),
                clean_img.shape, self.rows)
        if probes is None:
            def probe(i, k):
                return draw_rows(lambda s: rademacher(s, gen, dev),
                                 x_init.shape, self.rows)
        else:
            def probe(i, k):
                return probes[i][k].to(device=dev, dtype=x_init.dtype)
        x = solve(noisy_img, degradation.H(x_init), x_init, probe)
        return x, N - 1
