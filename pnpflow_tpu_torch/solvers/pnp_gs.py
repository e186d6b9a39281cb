"""Prox-PnP / PnP-GS (Hurault et al.; port of ``pnpflow_tpu/solvers/pnp_gs.py``).

The denoiser is D(x) = x - Dg(x), Dg from a VJP of the U-Net at t = sigma
(``training/denoiser.py``).  Algorithms:

  * ``pgd``: a data-fidelity gradient step with the learning rate
    pre-scaled by sigma^2 (skipped for gaussian denoising; laplace takes
    the sign subgradient H_adj(2 heaviside(Hx - y, 0) - 1) / sigma), then
    the relaxed denoising x = (1 - alpha) z + alpha D(z) at level
    sigma_factor * sigma;
  * ``hqs`` with a closed-form prox per problem:
      - random_inpainting: H(y) - H(Dx) + Dx with the denoiser at level 0.2
        before iteration 20 and sigma after; on the final iteration the
        reference computes Dx and keeps the previous iterate;
      - gaussian_deblurring_FFT: the Fourier prox of
        0.5 ||Hx - y||^2 + 1/(2 alpha) ||x - z||^2, and the objective-gap
        backtracking alpha <- 0.9 alpha, decided on the device;
      - superresolution_bicubic: the block-splitting Fourier prox.

Each iteration takes one U-Net forward and its VJP (under ``remat`` the
forward is checkpointed and recomputed by the VJP): with ``fused_norm True``
(these methods' default) the forward runs the ``groupnorm_swish`` kernel at
every GroupNorm and the VJP its plain backward.  The outer loop runs under
``no_grad`` (``Solver.differentiates``) and each VJP under ``enable_grad``
with a graph that the VJP frees, so no graph lives across iterations.
"""

from __future__ import annotations

import torch

from pnpflow_tpu_torch.ops.degradations import Superresolution
from pnpflow_tpu_torch.solvers.base import Solver
from pnpflow_tpu_torch.training.denoiser import calculate_grad


def _splits_mean(a, sf: int):
    """Mean across the sf x sf contiguous blocks at each within-block
    position (the reference's stacked ``torch.chunk`` blocks): NHWC ->
    (B, H/sf, W/sf, C)."""
    b, h, w, c = a.shape
    return a.reshape(b, sf, h // sf, sf, w // sf, c).mean(dim=(1, 3))


def make_pnp_gs_solver(model_fn, degradation, *, problem: str, algo: str,
                       noise_type: str, sigma_noise: float, lr_pnp: float,
                       sigma_factor: float, max_iter: int):
    """Build ``solve(y, x, alpha_c, start_iter, n_iters) -> (x, alpha_c)``,
    running ``n_iters`` iterations from global iteration ``start_iter``;
    ``alpha_c`` is a 0-dim float32 tensor on x's device (the backtracked
    alpha of deblurring stays there)."""
    H, H_adj = degradation.H, degradation.H_adj
    lr = sigma_noise ** 2 * lr_pnp

    def denoise_Dg(x, sigma, compute_g=False):
        sigma_vec = torch.full((x.shape[0],), sigma, dtype=torch.float32,
                               device=x.device)
        return calculate_grad(model_fn, x, sigma_vec, compute_g=compute_g)

    def grad_datafit(x, y):
        if noise_type == "gaussian":
            return H_adj(H(x) - y) / sigma_noise ** 2
        r = H(x) - y
        return H_adj(2.0 * (r > 0).to(r.dtype) - 1.0) / sigma_noise

    def objective(x, y, lmbda, g):
        if noise_type == "gaussian":
            datafit = 0.5 * ((H(x) - y) ** 2).sum()
        else:
            datafit = (H(x) - y).abs().mean()
        return datafit + lmbda * g

    if algo == "pgd":

        def step(y, x, alpha_c, i):
            if problem != "denoising" or noise_type == "laplace":
                z = x - lr * grad_datafit(x, y)
            else:
                z = x
            Dg, _ = denoise_Dg(z, sigma_factor * sigma_noise)
            return (1.0 - alpha_c) * z + alpha_c * (z - Dg), alpha_c

    elif algo == "hqs" and problem == "random_inpainting":

        def step(y, x, alpha_c, i):
            Dg, _ = denoise_Dg(x, 0.2 if i < 20 else sigma_noise)
            Dx = x - Dg
            if i < max_iter - 1:
                return H(y) - H(Dx) + Dx, alpha_c
            return x, alpha_c

    elif algo == "hqs" and problem == "gaussian_deblurring_FFT":
        filt = degradation.fft_filter

        def prox(z, y, a):
            fft_d = torch.fft.fft2(a * H_adj(y) + z, dim=(1, 2))
            inv = a * filt.conj() * filt + 1.0
            return torch.fft.ifft2(fft_d / inv, dim=(1, 2)).real

        def step(y, x, alpha_c, i):
            Dg, _, g = denoise_Dg(x, 1.8 * sigma_noise, compute_g=True)
            Dx = x - Dg
            z_in = 0.1 * alpha_c * Dx + alpha_c * (1.0 - alpha_c * 0.1) * x
            x_new = prox(z_in, y, alpha_c)
            gap = objective(x_new, y, 0.1, g) - objective(x, y, 0.1, g)
            shrink = gap < 0.1 / alpha_c * ((x_new - x) ** 2).sum()
            return x_new, torch.where(shrink, 0.9 * alpha_c, alpha_c)

    elif algo == "hqs" and problem == "superresolution_bicubic":
        sf = degradation.sf
        filt = degradation.fft_filter

        def prox(z, y, a):
            hat_z = H_adj(y) + z / a
            fft_hat_z = torch.fft.fft2(hat_z, dim=(1, 2))
            top = _splits_mean(filt * fft_hat_z, sf)
            below = _splits_mean(filt.conj() * filt * fft_hat_z, sf) + 1.0 / a
            rc = filt.conj() * (top / below).tile((1, sf, sf, 1))
            sol = torch.fft.ifft2(rc, dim=(1, 2)).real
            return (hat_z - sol) * a

        def step(y, x, alpha_c, i):
            Dg, _, g = denoise_Dg(x, 2.0 * sigma_noise, compute_g=True)
            Dx = x - Dg
            z_in = 0.065 * alpha_c * Dx \
                + alpha_c * (1.0 - alpha_c * 0.065) * x
            return prox(z_in, y, alpha_c), alpha_c

    else:
        raise ValueError(
            "Unsupported pnp_gs algo/problem: {}/{}".format(algo, problem))

    def solve(y, x, alpha_c, start_iter: int, n_iters: int):
        for i in range(start_iter, start_iter + n_iters):
            x, alpha_c = step(y, x, alpha_c, i)
        return x, alpha_c

    return solve


def report_points(max_iter: int) -> list:
    """Iterations after which the reference reports: every 10th (the base
    loop adds max_iter - 1)."""
    return [i for i in range(max_iter) if i % 10 == 0]


def initial_iterate(problem: str, degradation, noisy_img):
    """The reference's start: 1.5 y - H(y) for random inpainting, the
    bicubic operator's H_adj(y) for plain super-resolution, H_adj(y)
    otherwise."""
    if problem == "random_inpainting":
        return 1.5 * noisy_img - degradation.H(noisy_img)
    if problem == "superresolution":
        sr = Superresolution(degradation.sf, degradation.dim_image,
                             mode="bicubic", device=noisy_img.device)
        return sr.H_adj(noisy_img)
    return degradation.H_adj(noisy_img)


class ProxPnP(Solver):
    """Reference-compatible wrapper (pnp_gs.py:11-264).

    alpha is initialised once per ``solve_ip``, and the deblurring
    backtracking's shrunken alpha carries over to later batches, as in the
    reference.  One ``solve_ip`` holds one degradation, noise level and
    noise type, so new physics starts again from ``args.alpha``."""

    differentiates = True

    def solve_ip(self, test_loader, degradation, sigma_noise):
        self._alpha_carry = float(self.args.alpha)
        super().solve_ip(test_loader, degradation, sigma_noise)

    def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                    batch, report_cb=None):
        args = self.args
        max_iter = int(args.max_iter)
        solve = make_pnp_gs_solver(
            self.model.grad_forward, degradation, problem=args.problem,
            algo=args.algo, noise_type=args.noise_type,
            sigma_noise=float(sigma_noise), lr_pnp=float(args.lr_pnp),
            sigma_factor=float(getattr(args, "sigma_factor", 1.0)),
            max_iter=max_iter)
        x = initial_iterate(args.problem, degradation, noisy_img)
        # a solve_batch called outside solve_ip (the serving API) starts
        # from args.alpha, as JAX's does
        alpha_c = torch.tensor(getattr(self, "_alpha_carry",
                                       float(args.alpha)),
                               dtype=torch.float32, device=x.device)
        done = 0
        for r in (report_points(max_iter) if report_cb is not None else []):
            x, alpha_c = solve(noisy_img, x, alpha_c, done, r + 1 - done)
            done = r + 1
            report_cb(x, r)
        x, alpha_c = solve(noisy_img, x, alpha_c, done, max_iter - done)
        self._alpha_carry = float(alpha_c)
        return x, max_iter - 1
