"""PnP-Diff: the DiffPIR sampler (Zhu et al. 2023) with the DiffUNet.

Port of ``pnpflow_tpu/solvers/pnp_diff.py``, which reimplements what the
reference delegates to ``deepinv.sampling.DiffPIR``:

  betas linear 1e-4..0.02 over T = 1000; sigma_k = sqrt(1-acp_k)/sqrt(acp_k);
  rho_t = lmbda * sigma_n^2 / sigma_t^2; timesteps
  seq = sqrt(linspace(0, T^2, max_iter)) as integers, unique, the last
  pinned to T - 1, walked downwards.

  x_T = sqrt(acp_T) (2 A^+(y) - 1) + sqrt(1 - acp_T) n_0;  per step t -> t':
    x0   = (x_t - sqrt(1-acp_t) eps_theta(x_t, t)) / sqrt(acp_t)
    x0^  = 2 * prox_f((clip(x0, -1, 1) + 1)/2, y01; gamma = 1/(2 rho_t)) - 1
    eps^ = (x_t - sqrt(acp_t) x0^) / sqrt(1-acp_t)
    x_t' = sqrt(acp_t') x0^
           + sqrt(1-acp_t') (sqrt(1-zeta) eps^ + sqrt(zeta) n_k)

The schedules are built in numpy, float64 then float32, as JAX builds them,
and the per-step scalars are taken from them in float32.  eps_theta is the
first C of the DiffUNet's 6 output channels.  The sampler works in [0, 1]
(y01 = (y + 1) / 2); the restored image is the last x_t, in [-1, 1].  The
noise n_0, n_1, ... comes from a ``torch.Generator`` seeded 1000 + batch, or
from ``noise_seq`` (the seam through which the tests give both packages
JAX's draws).  No kernel of the repository runs on this path: the DiffUNet
is plain PyTorch, as JAX's is plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from pnpflow_tpu_torch.solvers.base import Solver, draw_rows

_MASK_PROBLEMS = ("inpainting", "random_inpainting", "paintbrush_inpainting")
_T = 1000


def schedules():
    """``(acp, sigmas)``, float32 arrays of length T."""
    betas = np.linspace(0.1 / _T, 20.0 / _T, _T, dtype=np.float64)
    acp = np.cumprod(1.0 - betas)
    sigmas = np.sqrt(1.0 - acp) / np.sqrt(acp)
    return acp.astype(np.float32), sigmas.astype(np.float32)


def timesteps(max_iter: int):
    """``(t, t_next)``, int64 arrays: the descending DiffPIR timesteps and
    each one's successor, the last landing at 0."""
    seq = np.sqrt(np.linspace(0, _T ** 2, max_iter))
    seq = np.unique(np.clip(seq.astype(np.int64), 0, _T - 1))
    seq[-1] = _T - 1
    desc = seq[::-1].copy()
    return desc, np.concatenate([desc[1:], [0]])


def make_prox(problem, degradation, sigma_noise, noise_type):
    """prox of f(x) = 1/(2 sigma^2) ||Hx - y||^2 at weight 1/gamma, or, for
    laplace noise, the L1 dual prox (100 iterations, returning the iterate
    of the last pre-update dual).  Inputs and output in [0, 1]."""
    H, H_adj = degradation.H, degradation.H_adj
    norm = 1.0 / sigma_noise ** 2

    if noise_type == "laplace":

        def prox(x, y, gamma):
            # the dual prox of ||Ax - y||_1; stepsize 1 (||H|| <= 1 for
            # every operator here)
            u, t = y, x
            for _ in range(100):
                t = x - H_adj(u)
                u_ = u + H(t)
                soft = (torch.clamp_min(u_ - y - gamma, 0.0)
                        + torch.clamp_max(u_ - y + gamma, 0.0))
                u = u_ - (soft + y)
            return t

        return prox

    if problem in _MASK_PROBLEMS:
        mask = degradation.mask

        def prox(x, y, gamma):
            d = H_adj(y) * norm + x / gamma
            return d / (mask * norm + 1.0 / gamma)

    elif problem == "denoising":

        def prox(x, y, gamma):
            d = H_adj(y) * norm + x / gamma
            return d / (norm + 1.0 / gamma)

    elif problem == "gaussian_deblurring_FFT":
        filt = degradation.fft_filter

        def prox(x, y, gamma):
            d = H_adj(y) * norm + x / gamma
            inv = norm * filt * filt.conj() + 1.0 / gamma
            return torch.fft.ifft2(torch.fft.fft2(d, dim=(1, 2)) / inv,
                                   dim=(1, 2)).real

    elif problem == "superresolution":
        # plain decimation: diag(H^T H) is the keep-pixel mask (the
        # bicubic variant has no closed form, in JAX or the reference)
        keep = torch.from_numpy(degradation.keep_mask())

        def prox(x, y, gamma):
            d = H_adj(y) * norm + x / gamma
            return d / (keep.to(x.device) * norm + 1.0 / gamma)

    else:
        raise ValueError("Unsupported pnp_diff problem: {}".format(problem))

    return prox


def make_diffpir_solver(model_fn, prox, H_adj, *, lmbda: float, zeta: float,
                        max_iter: int, sigma_noise: float, rows=None):
    """Build ``solve(y01, generator=None, noise_seq=None) -> x``;
    ``model_fn(x_nhwc, t_vec)`` predicts eps in its first C channels.
    ``noise_seq``, a sequence of tensors, replaces the draws: ``[0]`` is the
    start's noise, ``[k]`` step k's.  ``rows`` (start, stop, total): each
    draw is the whole batch's, these images' kept (a fanned-out shard)."""
    f32 = np.float32
    acp, sigmas = schedules()
    ts, ts_next = timesteps(max_iter)
    rhos = lmbda * sigma_noise ** 2 / np.maximum(sigmas ** 2, 1e-12)
    steps = []
    for t, tn in zip(ts, ts_next):
        at, an = acp[t], acp[tn]
        steps.append(dict(
            t=float(t), sqrt_1m=float(np.sqrt(f32(1) - at)),
            sqrt_at=float(np.sqrt(at)),
            gamma=float(f32(1) / (f32(2) * rhos[t])),
            eps_den=float(np.sqrt(np.maximum(f32(1) - at, f32(1e-12)))),
            sqrt_an=float(np.sqrt(an)),
            sqrt_1m_an=float(np.sqrt(f32(1) - an))))
    root_z, root_1mz = float(np.sqrt(f32(zeta))), float(np.sqrt(f32(1 - zeta)))
    t0 = int(ts[0])

    def noise(k, like, generator, noise_seq):
        if noise_seq is not None:
            return noise_seq[k].to(device=like.device, dtype=like.dtype)
        return draw_rows(
            lambda s: torch.randn(s, generator=generator,
                                  device=like.device, dtype=like.dtype),
            like.shape, rows)

    def solve(y01, generator=None, noise_seq=None):
        x0_init = 2.0 * H_adj(y01) - 1.0
        x = (float(np.sqrt(acp[t0])) * x0_init
             + float(np.sqrt(f32(1) - acp[t0]))
             * noise(0, x0_init, generator, noise_seq))
        c = x.shape[-1]
        for k, s in enumerate(steps, start=1):
            t_vec = torch.full((x.shape[0],), s["t"], dtype=torch.float32,
                               device=x.device)
            eps = model_fn(x, t_vec)[..., :c]
            x0 = (x - s["sqrt_1m"] * eps) / s["sqrt_at"]
            x0_01 = (x0.clamp(-1.0, 1.0) + 1.0) / 2.0
            x0 = 2.0 * prox(x0_01, y01, s["gamma"]) - 1.0
            eps_hat = (x - s["sqrt_at"] * x0) / s["eps_den"]
            x = (s["sqrt_an"] * x0 + s["sqrt_1m_an"]
                 * (root_1mz * eps_hat
                    + root_z * noise(k, x, generator, noise_seq)))
        return x

    return solve


class PnPDiff(Solver):
    """Reference-compatible wrapper (pnp_diff.py:14-90): measurements in
    [-1, 1] handed to the sampler as (y + 1) / 2, metrics reported once, at
    iteration 100."""

    def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                    batch, report_cb=None, noise_seq=None):
        args = self.args
        prox = make_prox(args.problem, degradation, float(sigma_noise),
                         args.noise_type)
        solve = make_diffpir_solver(
            self.model.forward, prox, degradation.H_adj,
            lmbda=float(args.lmbda), zeta=float(args.zeta),
            max_iter=int(args.max_iter), sigma_noise=float(sigma_noise),
            rows=self.rows)
        gen = torch.Generator(device=noisy_img.device).manual_seed(
            1000 + int(batch))
        return solve((noisy_img + 1.0) / 2.0, gen, noise_seq), 100
