"""LPIPS with the AlexNet trunk (port of ``pnpflow_tpu/metrics/lpips.py``).

The reference scores LPIPS with the ``lpips`` package's pretrained AlexNet
(utils.py:677-724).  Those weights cannot be downloaded here, so this
module implements the LPIPS architecture (the AlexNet feature trunk, the
per-layer non-negative 1x1 heads, the ImageNet input scaling) and loads
converted weights from ``{output_root}/model/lpips_alex.npz`` when present,
in the JAX package's layout (``conv{i}_w`` HWIO, ``conv{i}_b``, ``lin{i}_w``),
transposed once into ``nn.Conv2d`` weights.  ``utils/lpips_convert.py``
writes that file from a torch LPIPS checkpoint.  Without the file LPIPS
reporting is skipped with one warning (PSNR and SSIM are unaffected).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pnpflow_tpu_torch.device import resolve_device

# AlexNet conv trunk (features): (out_ch, kernel, stride, pad)
_ALEX_LAYOUT = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
# max-pool 3/2 (VALID) after trunk layers 0 and 1
_POOL_AFTER = {0, 1}

# LPIPS input scaling (the 'scaling_layer') of [-1, 1] inputs
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

# (path, device) -> LPIPS module, the last one asked for only: a process
# that reports under several output roots keeps one network on the device
_CACHE: dict = {}
_WARNED: set = set()


def _normalize(feat, eps=1e-10):
    """Unit-normalize over channels, eps outside the square root."""
    return feat / (feat.pow(2).sum(dim=1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """``LPIPS()(x, y)``: the distance of NHWC images in [-1, 1], averaged
    over H and W per layer, summed over layers, then averaged over the
    batch."""

    def __init__(self, weights: dict):
        super().__init__()
        self.convs = nn.ModuleList()
        cin = 3
        for i, (cout, k, stride, pad) in enumerate(_ALEX_LAYOUT):
            conv = nn.Conv2d(cin, cout, k, stride=stride, padding=pad)
            w = np.asarray(weights[f"conv{i}_w"], np.float32)
            if w.shape != (k, k, cin, cout):
                raise ValueError(f"conv{i}_w: shape {w.shape}, expected "
                                 f"{(k, k, cin, cout)}")
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(
                    np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
                conv.bias.copy_(torch.from_numpy(np.asarray(
                    weights[f"conv{i}_b"], np.float32)))
            self.convs.append(conv)
            self.register_buffer(f"lin{i}", torch.from_numpy(np.asarray(
                weights[f"lin{i}_w"], np.float32).reshape(-1)))
            cin = cout
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))
        self.requires_grad_(False)

    def forward(self, x, y):
        return self.distances(x, y).mean()

    def distances(self, x, y):
        """The per-image distances, (B,): what reflow's LPIPS losses take
        (their gradient in x runs through the plain convolutions)."""
        n = x.shape[0]
        # both images through the trunk as one batch
        h = torch.cat([x, y]).permute(0, 3, 1, 2).float()
        h = (h - self.shift) / self.scale
        total = 0.0
        for i, conv in enumerate(self.convs):
            h = F.relu(conv(h))
            diff = (_normalize(h[:n]) - _normalize(h[n:])) ** 2
            lin = getattr(self, f"lin{i}")
            total = total + (diff * lin[None, :, None, None]).sum(
                dim=1).mean(dim=(1, 2))
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, 3, stride=2)
        return total


def get_lpips_fn(args, device=None):
    """The LPIPS module on ``device`` (``cuda`` unless asked otherwise),
    cached by (path, device) (the last pair asked for), or None with one
    warning per path when the weight file is absent.  It raises on images
    on another device, as any module does."""
    dev = resolve_device(device)
    path = os.path.abspath(os.path.join(
        getattr(args, "output_root", "./"), "model", "lpips_alex.npz"))
    key = (path, str(dev))
    if key in _CACHE:
        return _CACHE[key]
    if not os.path.exists(path):
        if path not in _WARNED:
            warnings.warn(
                "LPIPS weights not found at {} — skipping LPIPS reporting "
                "(PSNR/SSIM unaffected). Convert torch LPIPS weights with "
                "pnpflow_tpu_torch.utils.lpips_convert.".format(path))
            _WARNED.add(path)
        return None
    with np.load(path) as f:
        weights = {k: f[k] for k in f.files}
    _CACHE.clear()
    _CACHE[key] = LPIPS(weights).to(dev).eval()
    return _CACHE[key]
