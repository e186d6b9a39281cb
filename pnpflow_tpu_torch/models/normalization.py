"""Normalization zoo of the NCSN score models, on NHWC tensors (port of
``pnpflow_tpu/models/normalization.py``).

InstanceNorm, InstanceNorm++, VarianceNorm, NoneNorm and GroupNorm(32), the
class-conditional forms, and ``get_normalization`` keyed on
``config.model.normalization`` (reference ``normalization.py:22-215``).
Statistics are plain reductions over H and W, as in the JAX package:
biased variance and eps 1e-5 as torch's ``InstanceNorm2d``, and the
*unbiased* variance of the per-channel means in InstanceNorm++ (the
reference's ``torch.var``).  The conditional forms gather per-class affine
rows from a table by integer label.

Each module takes its channel count when it is built (flax infers it at
the first call).  Parameter names are the flax ones (``alpha``, ``gamma``,
``beta``; a class table ``embed`` inside ``embed_ga`` / ``embed_beta`` /
``embed``; GroupNorm32's ``gn``), so ``utils/jax_params.py`` carries them
across by path.  :func:`init_norms` draws them as the flax initializers
do, from a ``torch.Generator``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F


def instance_norm(x, eps: float = 1e-5):
    """torch ``InstanceNorm2d(affine=False)``: per sample and channel over
    H and W, biased variance."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _standardized_means(x):
    """The per-channel means standardized across channels (unbiased
    variance), InstanceNorm++'s re-injected term: (B, C)."""
    means = x.mean(dim=(1, 2))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=True)
    return (means - m) * torch.rsqrt(v + 1e-5)


def _normal_1(shape):
    """A parameter drawn by :func:`init_norms` from N(1, 0.02^2)."""
    p = nn.Parameter(torch.ones(shape))
    p.init = "normal"
    return p


class InstanceNorm2d(nn.Module):
    """Parameter-free instance norm."""

    def __init__(self, num_features: int):
        super().__init__()

    def forward(self, x):
        return instance_norm(x)


class VarianceNorm2d(nn.Module):
    """x / sqrt(var_hw + 1e-5) times a per-channel ``alpha``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.alpha = _normal_1(num_features)

    def forward(self, x):
        v = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return self.alpha * x * torch.rsqrt(v + 1e-5)


class NoneNorm2d(nn.Module):
    """Identity."""

    def __init__(self, num_features: int):
        super().__init__()

    def forward(self, x):
        return x


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++: IN(x) plus the standardized per-channel means
    times ``alpha``, then ``gamma`` and ``beta``."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.alpha = _normal_1(num_features)
        self.gamma = _normal_1(num_features)
        if bias:
            self.beta = nn.Parameter(torch.zeros(num_features))
        self.bias = bias

    def forward(self, x):
        h = instance_norm(x) + _standardized_means(x)[:, None, None, :] * \
            self.alpha
        out = self.gamma * h
        return out + self.beta if self.bias else out


class _ClassEmbed(nn.Module):
    """A per-class table ``embed`` (num_classes, width), rows gathered by
    integer label.  ``init``: "uniform" U[0, 1), "normal" N(1, 0.02^2),
    "zeros", or "uniform_zeros" (the first half of each row U[0, 1), the
    rest 0: the reference's scale-and-bias tables)."""

    def __init__(self, num_classes: int, width: int, init: str = "uniform"):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(num_classes, width))
        self.embed.init = init

    def forward(self, y):
        return self.embed[y.long()]


def _cond(v):
    return v[:, None, None, :]


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Class-conditional InstanceNorm++: gamma and alpha from ``embed_ga``,
    beta from ``embed_beta``."""

    def __init__(self, num_features: int, num_classes: int,
                 bias: bool = True):
        super().__init__()
        c = num_features
        self.c, self.bias = c, bias
        self.embed_ga = _ClassEmbed(num_classes, 2 * c, "normal")
        if bias:
            self.embed_beta = _ClassEmbed(num_classes, c, "zeros")

    def forward(self, x, y):
        ga = self.embed_ga(y)
        gamma, alpha = ga[:, :self.c], ga[:, self.c:]
        h = instance_norm(x) + _cond(_standardized_means(x)) * _cond(alpha)
        out = _cond(gamma) * h
        return out + _cond(self.embed_beta(y)) if self.bias else out


class ConditionalInstanceNorm2d(nn.Module):
    """IN with a per-class affine."""

    def __init__(self, num_features: int, num_classes: int,
                 bias: bool = True):
        super().__init__()
        self.c, self.bias = num_features, bias
        self.embed = _ClassEmbed(num_classes, (2 if bias else 1) *
                                 num_features,
                                 "uniform_zeros" if bias else "uniform")

    def forward(self, x, y):
        g = self.embed(y)
        h = instance_norm(x)
        if self.bias:
            return _cond(g[:, :self.c]) * h + _cond(g[:, self.c:])
        return _cond(g) * h


class ConditionalVarianceNorm2d(nn.Module):
    """Variance norm with a per-class gain."""

    def __init__(self, num_features: int, num_classes: int,
                 bias: bool = False):
        super().__init__()
        self.embed = _ClassEmbed(num_classes, num_features, "normal")

    def forward(self, x, y):
        v = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return _cond(self.embed(y)) * x * torch.rsqrt(v + 1e-5)


class ConditionalNoneNorm2d(nn.Module):
    """A per-class affine, no normalization."""

    def __init__(self, num_features: int, num_classes: int,
                 bias: bool = True):
        super().__init__()
        self.c, self.bias = num_features, bias
        self.embed = _ClassEmbed(num_classes, (2 if bias else 1) *
                                 num_features,
                                 "uniform_zeros" if bias else "uniform")

    def forward(self, x, y):
        g = self.embed(y)
        if self.bias:
            return _cond(g[:, :self.c]) * x + _cond(g[:, self.c:])
        return _cond(g) * x


class GroupNorm32(nn.Module):
    """GroupNorm(32 groups, eps 1e-5) on NHWC, as ``gn``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.gn = nn.GroupNorm(32, num_features, eps=1e-5)

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2).contiguous(), 32,
                         self.gn.weight, self.gn.bias, self.gn.eps)
        return y.permute(0, 2, 3, 1)


def get_normalization(name: str, conditional: bool = False,
                      num_classes: int | None = None):
    """The norm class keyed on ``config.model.normalization`` (reference
    ``normalization.py:22-40``): called with the channel count."""
    if conditional:
        if name == "InstanceNorm++":
            return functools.partial(ConditionalInstanceNorm2dPlus,
                                     num_classes=num_classes)
        raise NotImplementedError(
            "{} not implemented for conditional".format(name))
    if name == "InstanceNorm":
        return InstanceNorm2d
    if name == "InstanceNorm++":
        return InstanceNorm2dPlus
    if name == "VarianceNorm":
        return VarianceNorm2d
    if name == "GroupNorm":
        return GroupNorm32
    raise ValueError("Unknown normalization: {}".format(name))


@torch.no_grad()
def init_norms(model: nn.Module, generator: torch.Generator):
    """Draw every tagged norm parameter as the flax initializers do: N(1,
    0.02^2), U[0, 1), zeros, or the half-uniform tables; GroupNorm (1, 0)."""
    for mod in model.modules():
        if isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for p in model.parameters():
        kind = getattr(p, "init", None)
        if kind == "normal":
            p.copy_(1.0 + 0.02 * torch.randn(p.shape, generator=generator))
        elif kind == "uniform":
            p.copy_(torch.rand(p.shape, generator=generator))
        elif kind == "uniform_zeros":
            half = p.shape[1] // 2
            p.zero_()
            p[:, :half] = torch.rand((p.shape[0], half), generator=generator)
        elif kind == "zeros":
            p.zero_()
    for mod in model.modules():
        if isinstance(mod, InstanceNorm2dPlus) and mod.bias:
            mod.beta.zero_()
