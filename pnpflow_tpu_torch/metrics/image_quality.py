"""Restoration metrics on NHWC tensors: PSNR and SSIM.

Port of ``pnpflow_tpu/metrics/image_quality.py``.  PSNR is the per-image
10*log10(range^2 / mse) averaged over the batch (torchmetrics' reduction);
SSIM is ignite's gaussian-window SSIM: 11x11 window sigma 1.5, k1=0.01,
k2=0.03, reflect padding, a depthwise valid convolution, and the per-pixel
map averaged over everything.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred, target, data_range: float = 1.0):
    """Mean per-image PSNR over the batch (NHWC)."""
    mse = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    val = 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-20))
    return val.mean()


def _gaussian_window(kernel_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d(x, window):
    """Depthwise valid conv of an NCHW x with a (k, k) window."""
    c = x.shape[1]
    k = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(x, k, groups=c)


def ssim(pred, target, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Structural similarity, ignite-compatible."""
    window = torch.from_numpy(_gaussian_window(kernel_size, sigma)).to(
        pred.device)
    pad = (kernel_size - 1) // 2

    def prep(a):
        a = a.float().permute(0, 3, 1, 2)
        return F.pad(a, (pad, pad, pad, pad), mode="reflect")

    x, y = prep(pred), prep(target)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _filter2d(x, window)
    mu_y = _filter2d(y, window)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y

    sigma_xx = _filter2d(x * x, window) - mu_xx
    sigma_yy = _filter2d(y * y, window) - mu_yy
    sigma_xy = _filter2d(x * y, window) - mu_xy

    a1 = 2 * mu_xy + c1
    a2 = 2 * sigma_xy + c2
    b1 = mu_xx + mu_yy + c1
    b2 = sigma_xx + sigma_yy + c2
    return ((a1 * a2) / (b1 * b2)).mean()
