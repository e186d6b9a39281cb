"""PnP-Flow restoration, written plainly from the paper (Martin et al.,
arXiv 2410.02423, Algorithm 1) and annegnx/PnP-Flow's ``pnp_flow.py``.

For t_i = i / N: a gradient step on the data fidelity,
z = x - gamma(t_i) lr sigma^2 H^T (H x - y) / sigma^2, then the flow
denoiser averaged over Monte-Carlo draws, x = mean_s [zs + (1 - t) v(zs, t)]
with zs = t z + (1 - t) eps_s.  The start is H^T(1).  The draws are
``torch.randn((S, b, h, w, c))`` from a generator seeded ``1000 + batch``
on the measurement's device, one call a step: the seeding rule the
restoration API states, so both sides see the same noise.  Scalars follow
the float32 arithmetic of the reference's schedule.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel(sigma: float, size: int) -> np.ndarray:
    x = np.arange((-size) // 2 + 1.0, size // 2 + 1.0)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    k = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


class FFTBlur:
    """Circular Gaussian blur on NHWC images, its adjoint the conjugate
    transfer function.  The kernel's centre sits at the origin."""

    def __init__(self, sigma: float, size: int, dim: int, device):
        canvas = np.zeros((dim, dim), np.float32)
        canvas[:size, :size] = gaussian_kernel(sigma, size)
        canvas = np.roll(canvas, (-(size - 1) // 2,) * 2, axis=(0, 1))
        self.f = torch.from_numpy(np.fft.fft2(canvas).astype(np.complex64)
                                  )[None, :, :, None].to(device)

    def _apply(self, x, f):
        return torch.fft.ifft2(torch.fft.fft2(x, dim=(1, 2)) * f,
                               dim=(1, 2)).real

    def H(self, x):
        return self._apply(x, self.f)

    def H_adj(self, x):
        return self._apply(x, self.f.conj())


def gamma(style: str, lr, t, alpha: float):
    f32 = np.float32
    if style == "1_minus_t":
        return lr * (f32(1) - t)
    if style == "sqrt_1_minus_t":
        return lr * np.sqrt(f32(1) - t)
    if style == "alpha_1_minus_t":
        return lr * (f32(1) - t) ** f32(alpha)
    return lr


class PnPFlow:
    """Steps of one request: :meth:`start`, then :meth:`run` from any step
    with the draws of the steps before it skipped."""

    def __init__(self, model, blur: FFTBlur, traffic: dict):
        self.model, self.blur = model, blur
        self.steps = int(traffic["steps_pnp"])
        self.samples = int(traffic["num_samples"])
        self.lr = np.float32(traffic["sigma_noise"] ** 2 * traffic["lr_pnp"])
        self.sigma = float(traffic["sigma_noise"])
        self.style = traffic["gamma_style"]
        self.alpha = float(traffic["alpha"])
        self.delta = np.float32(1.0 / self.steps)

    def start(self, y):
        return self.blur.H_adj(torch.ones_like(y))

    def run(self, y, x, batch: int, first: int, last: int, stamps=None):
        """Steps ``first`` to ``last`` inclusive from state ``x`` (the state
        after step ``first - 1``); ``stamps[i]`` gets the state after step
        i where ``stamps`` holds the key i."""
        gen = torch.Generator(device=y.device).manual_seed(1000 + int(batch))
        b, h, w, c = y.shape
        shape = (self.samples, b, h, w, c)
        for _ in range(first):
            torch.randn(shape, generator=gen, device=y.device)
        for i in range(first, last + 1):
            t = np.float32(i) * self.delta
            lr_t = float(gamma(self.style, self.lr, t, self.alpha))
            z = x - lr_t * (self.blur.H_adj(self.blur.H(x) - y)
                            / self.sigma ** 2)
            eps = torch.randn(shape, generator=gen, device=y.device)
            tf, sf = float(t), float(np.float32(1) - t)
            zs = (tf * z[None] + sf * eps).reshape(-1, h, w, c)
            tv = torch.full((zs.shape[0],), tf, dtype=torch.float32,
                            device=y.device)
            x = (zs + sf * self.model(zs, tv)).reshape(shape).mean(dim=0)
            if stamps is not None and i in stamps:
                stamps[i] = x
        return x
