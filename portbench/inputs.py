"""What the benchmark makes from the seed and hands to both sides: weights
and clean images, on the device, in a few large calls."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def weight_rules(model: nn.Module, cfg: dict) -> list:
    """(name, shape, mean, scale) of every parameter, every one at a real
    scale (a seeded init that leaves the last convs near zero would make
    every comparison vacuous): GroupNorm scales 1 + 0.2 N, other vectors
    0.1 N, the Fourier projection fourier_scale N, weights N / sqrt(fan_in)."""
    norm_weights = {id(m.weight) for m in model.modules()
                    if isinstance(m, nn.GroupNorm)}
    rules = []
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if id(p) in norm_weights:
            rules.append((name, shape, 1.0, 0.2))
        elif name.endswith(".W") and p.dim() == 1:
            rules.append((name, shape, 0.0, float(cfg["fourier_scale"])))
        elif p.dim() == 1:
            rules.append((name, shape, 0.0, 0.1))
        else:
            fan_in = shape[0] if name.endswith(".W") else p[0].numel()
            rules.append((name, shape, 0.0, fan_in ** -0.5))
    return rules


def make_weights(model: nn.Module, cfg: dict, seed: int, device) -> dict:
    """A state dict of ``model``'s parameters drawn from ``seed`` on
    ``device``: one normal draw for all of them, then a scale per leaf."""
    rules = weight_rules(model, cfg)
    total = sum(int(torch.Size(s).numel()) for _, s, _, _ in rules)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, mean, scale in rules:
        n = int(torch.Size(shape).numel())
        out[name] = flat[at:at + n].view(shape).mul_(scale).add_(mean)
        at += n
    return out


def clean_images(gen: torch.Generator, n: int, size: int, channels: int,
                 device) -> torch.Tensor:
    """NHWC images in [-1, 1]: uniform noise at an eighth of the size,
    bilinearly enlarged, so each has the smooth structure of a photograph
    rather than white noise."""
    low = torch.rand((n, channels, max(size // 8, 2), max(size // 8, 2)),
                     generator=gen, device=device)
    img = F.interpolate(low, size=(size, size), mode="bilinear",
                        align_corners=False)
    return (2.0 * img - 1.0).permute(0, 2, 3, 1).contiguous()
