"""Degradation (physics) operators: H / H_adj pairs on NHWC tensors.

Port of ``pnpflow_tpu/ops/degradations.py`` for the problems this port runs:
``denoising`` (identity) and ``gaussian_deblurring_FFT`` (circular gaussian
blur through ``torch.fft`` with the exact conjugate adjoint).  The filter is
built in numpy exactly as the JAX package builds it and stored on the
device as complex64.
"""

from __future__ import annotations

import numpy as np
import torch

from pnpflow_tpu_torch.device import resolve_device


def gaussian_2d_kernel(sigma: float, size: int) -> np.ndarray:
    """Normalized 2-D gaussian kernel on the grid arange(-size//2+1,
    size//2+1)."""
    x = np.arange((-size) // 2 + 1.0, size // 2 + 1.0)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    kernel = np.exp(-(xx**2 + yy**2) / (2.0 * sigma**2))
    return (kernel / kernel.sum()).astype(np.float32)


def _embed_and_roll(kernel: np.ndarray, dim: int) -> np.ndarray:
    """Place ``kernel`` top-left in a (dim, dim) zero canvas and roll by
    -(ks-1)//2 so its center sits at the origin (circular convolution)."""
    ks = kernel.shape[0]
    if ks > dim:
        raise ValueError(
            f"blur kernel of size {ks} does not fit a {dim}x{dim} image")
    canvas = np.zeros((dim, dim), dtype=np.float32)
    canvas[:ks, :ks] = kernel
    shift = -(ks - 1) // 2
    return np.roll(canvas, (shift, shift), axis=(0, 1))


class Degradation:
    """A linear measurement operator: H and H_adj on NHWC tensors."""

    def H(self, x):
        raise NotImplementedError

    def H_adj(self, x):
        raise NotImplementedError


class Denoising(Degradation):
    """Identity operator."""

    def H(self, x):
        return x

    def H_adj(self, x):
        return x


class GaussianDeblurring(Degradation):
    """Circular gaussian blur via FFT with exact conjugate adjoint (FFT mode
    only; the direct-convolution mode is not ported yet)."""

    def __init__(self, sigma_blur: float, kernel_size: int,
                 num_channels: int = 3, dim_image: int = 128, device=None):
        self.sigma = sigma_blur
        self.kernel_size = kernel_size
        self.kernel = gaussian_2d_kernel(sigma_blur, kernel_size)
        filt = _embed_and_roll(self.kernel, dim_image)
        # (1, H, W, 1) complex64, broadcast over batch and channels
        self.fft_filter = torch.from_numpy(
            np.fft.fft2(filt).astype(np.complex64)[None, :, :, None]
        ).to(resolve_device(device))

    def _apply(self, x, filt):
        return torch.fft.ifft2(
            torch.fft.fft2(x, dim=(1, 2)) * filt, dim=(1, 2)
        ).real

    def H(self, x):
        return self._apply(x, self.fft_filter)

    def H_adj(self, x):
        return self._apply(x, self.fft_filter.conj())


def make_degradation(args, device=None):
    """Build (degradation, sigma_noise) for ``args.problem`` with the
    reference CLI's per-problem noise defaults."""
    problem = args.problem
    dim = args.dim_image

    def sigma(gauss):
        return 0.3 if args.noise_type == "laplace" else gauss

    if problem == "denoising":
        resolve_device(device)
        return Denoising(), sigma(0.2)
    if problem == "gaussian_deblurring_FFT":
        sigma_blur = 1.0 if dim == 128 else 3.0
        return (
            GaussianDeblurring(sigma_blur, 61, args.num_channels, dim,
                               device=device),
            sigma(0.05),
        )
    raise NotImplementedError(
        "problem {!r} is not ported yet (ROADMAP queue 1, item 6: the "
        "remaining degradations)".format(problem)
    )
