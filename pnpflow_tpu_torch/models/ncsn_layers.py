"""RefineNet layer zoo of the NCSNv1/v2 score models, on NHWC tensors (port
of ``pnpflow_tpu/models/ncsn_layers.py``).

The reference's torch port of the ermongroup ncsn(v2) blocks
(``image_generation/models/layers.py:133-507``): CRP, RCU, MSF and Refine
blocks, ConvMeanPool, MeanPoolConv, UpsampleConv and the (conditional)
residual block with down-sampling and dilation, beside the pools and the
align-corners bilinear resize they use.  Plain PyTorch throughout: the JAX
package computes them outside any kernel of its own too.

What the JAX module changed against the reference, kept here:

* dilated 3x3 convs pad by the dilation.  The reference passes padding 1
  with dilation 2 and 4 (``layers.py:464-467``), which shrinks the maps and
  crashes the residual add, so its dilated branch cannot run; padding by
  the dilation is the upstream ermongroup behaviour and keeps the shape.
* the reference's ``ncsn_conv3x3(bias=False)`` dies at construction
  (``conv.bias.data`` on None, ``layers.py:113-114``), so none of its
  CRP, RCU or Refine blocks, and no NCSNv2, can be built.  Here a
  ``bias=False`` conv simply has no bias, as in JAX.
* the MSF resize is ``align_corners=True`` bilinear, written as two 1-D
  interpolation matrices (:func:`interpolate_bilinear_ac`), the JAX
  module's own arithmetic.

Modules take their channel counts when they are built (flax infers them at
the first call); submodule and parameter names are the flax ones, so
``utils/jax_params.py`` carries the weights across by path.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def get_act(name: str) -> Callable:
    """The activation keyed on ``config.model.nonlinearity``."""
    name = name.lower()
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return functools.partial(F.leaky_relu, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError("activation function does not exist!")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class NCSNConv(nn.Module):
    """A 3x3 (padded by its dilation) or 1x1 conv on NHWC.  Weight (O, I,
    k, k) and bias both start U(-1/sqrt(fan_in), 1/sqrt(fan_in)) times
    ``init_scale`` (torch's default, ``layers.py:44-51,108-115``), drawn by
    :func:`init_ncsn`."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = True, dilation: int = 1,
                 init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        if bias:
            self.bias = nn.Parameter(torch.zeros(cout))
        else:
            self.register_parameter("bias", None)
        self.stride, self.dilation = stride, dilation
        self.padding = dilation if kernel == 3 else 0
        self.ncsn_scale = 1e-10 if init_scale == 0 else init_scale

    def forward(self, x):
        y = F.conv2d(_nchw(x), self.weight, self.bias, self.stride,
                     self.padding, self.dilation)
        return _nhwc(y)


def ncsn_conv(cin, cout, kernel=3, stride=1, bias=True, dilation=1,
              init_scale=1.0):
    return NCSNConv(cin, cout, kernel, stride, bias, dilation, init_scale)


def max_pool_5x5(x):
    """5x5 stride-1 max pool, padding 2."""
    return _nhwc(F.max_pool2d(_nchw(x), 5, stride=1, padding=2))


def avg_pool_5x5(x):
    """5x5 stride-1 average pool, padding 2, padding counted (torch's
    default)."""
    return _nhwc(F.avg_pool2d(_nchw(x), 5, stride=1, padding=2))


def avg_pool_2x2(x):
    """2x2 stride-2 mean pool."""
    return _nhwc(F.avg_pool2d(_nchw(x), 2))


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D linear interpolation matrix with align_corners=True semantics."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        w = src - lo
        m[i, lo] += 1.0 - w
        m[i, hi] += w
    return m


def interpolate_bilinear_ac(x, out_hw):
    """NHWC bilinear resize with align_corners=True (torch
    ``F.interpolate`` semantics, ``layers.py:248``) as two matrix
    products."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    mh = torch.from_numpy(_interp_matrix(h, oh)).to(x)
    mw = torch.from_numpy(_interp_matrix(w, ow)).to(x)
    y = torch.einsum("Oh,bhwc->bOwc", mh, x)
    return torch.einsum("Ow,bhwc->bhOc", mw, y)


class CRPBlock(nn.Module):
    """Chained residual pooling (``layers.py:133-154``)."""

    def __init__(self, features: int, n_stages: int = 2, act=F.relu,
                 maxpool: bool = True):
        super().__init__()
        for i in range(n_stages):
            self.add_module(f"conv_{i}", ncsn_conv(features, features,
                                                   bias=False))
        self.n_stages, self.act = n_stages, act
        self.pool = max_pool_5x5 if maxpool else avg_pool_5x5

    def forward(self, x):
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            path = getattr(self, f"conv_{i}")(self.pool(path))
            x = path + x
        return x


class CondCRPBlock(nn.Module):
    """Conditional CRP: a conditional norm per stage, average pool
    (``layers.py:157-180``)."""

    def __init__(self, features: int, n_stages: int, norm, act=F.relu):
        super().__init__()
        for i in range(n_stages):
            self.add_module(f"norm_{i}", norm(features))
            self.add_module(f"conv_{i}", ncsn_conv(features, features,
                                                   bias=False))
        self.n_stages, self.act = n_stages, act

    def forward(self, x, y):
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            path = getattr(self, f"norm_{i}")(path, y)
            path = getattr(self, f"conv_{i}")(avg_pool_5x5(path))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units (``layers.py:183-204``)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 act=F.relu):
        super().__init__()
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"conv_{i}_{j}", ncsn_conv(
                    features, features, bias=False))
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

    def forward(self, x):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"conv_{i}_{j}")(self.act(x))
            x = x + residual
        return x


class CondRCUBlock(nn.Module):
    """Conditional RCU (``layers.py:207-231``)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, norm,
                 act=F.relu):
        super().__init__()
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"norm_{i}_{j}", norm(features))
                self.add_module(f"conv_{i}_{j}", ncsn_conv(
                    features, features, bias=False))
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

    def forward(self, x, y):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"norm_{i}_{j}")(x, y)
                x = getattr(self, f"conv_{i}_{j}")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: a conv per input, resized to ``shape`` and
    summed (``layers.py:234-250``)."""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        for i, c in enumerate(in_planes):
            self.add_module(f"conv_{i}", ncsn_conv(c, features))
        self.n = len(in_planes)

    def forward(self, xs, shape):
        out = None
        for i, x in enumerate(xs):
            h = interpolate_bilinear_ac(getattr(self, f"conv_{i}")(x), shape)
            out = h if out is None else out + h
        return out


class CondMSFBlock(nn.Module):
    """Conditional MSF (``layers.py:253-274``)."""

    def __init__(self, in_planes: Sequence[int], features: int, norm):
        super().__init__()
        for i, c in enumerate(in_planes):
            self.add_module(f"norm_{i}", norm(c))
            self.add_module(f"conv_{i}", ncsn_conv(c, features))

    def forward(self, xs, y, shape):
        out = None
        for i, x in enumerate(xs):
            h = getattr(self, f"norm_{i}")(x, y)
            h = interpolate_bilinear_ac(getattr(self, f"conv_{i}")(h), shape)
            out = h if out is None else out + h
        return out


class RefineBlock(nn.Module):
    """RefineNet block: an RCU adapter per input, MSF fusion, CRP, an
    output RCU (``layers.py:277-310``)."""

    def __init__(self, in_planes: Sequence[int], features: int, act=F.relu,
                 start: bool = False, end: bool = False,
                 maxpool: bool = True):
        super().__init__()
        for i, c in enumerate(in_planes):
            self.add_module(f"adapt_{i}", RCUBlock(c, 2, 2, act))
        if len(in_planes) > 1:
            self.msf = MSFBlock(in_planes, features)
        self.crp = CRPBlock(features, 2, act, maxpool)
        self.output = RCUBlock(features, 3 if end else 1, 2, act)
        self.n = len(in_planes)

    def forward(self, xs, output_shape):
        hs = [getattr(self, f"adapt_{i}")(x) for i, x in enumerate(xs)]
        h = self.msf(hs, output_shape) if self.n > 1 else hs[0]
        return self.output(self.crp(h))


class CondRefineBlock(nn.Module):
    """Conditional RefineNet block (``layers.py:313-348``)."""

    def __init__(self, in_planes: Sequence[int], features: int, norm,
                 act=F.relu, start: bool = False, end: bool = False):
        super().__init__()
        for i, c in enumerate(in_planes):
            self.add_module(f"adapt_{i}", CondRCUBlock(c, 2, 2, norm, act))
        if len(in_planes) > 1:
            self.msf = CondMSFBlock(in_planes, features, norm)
        self.crp = CondCRPBlock(features, 2, norm, act)
        self.output = CondRCUBlock(features, 3 if end else 1, 2, norm, act)
        self.n = len(in_planes)

    def forward(self, xs, y, output_shape):
        hs = [getattr(self, f"adapt_{i}")(x, y) for i, x in enumerate(xs)]
        h = self.msf(hs, y, output_shape) if self.n > 1 else hs[0]
        return self.output(self.crp(h, y), y)


class ConvMeanPool(nn.Module):
    """A conv ('same' for its kernel), then a 2x2 mean pool; with
    ``adjust_padding`` one row and column of zeros first, at the top and
    left (``layers.py:351-369``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 biases: bool = True, adjust_padding: bool = False):
        super().__init__()
        self.conv = ncsn_conv(cin, cout, kernel, bias=biases)
        self.adjust_padding = adjust_padding

    def forward(self, x):
        if self.adjust_padding:
            x = F.pad(x, (0, 0, 1, 0, 1, 0))
        return avg_pool_2x2(self.conv(x))


class MeanPoolConv(nn.Module):
    """A 2x2 mean pool, then a conv (``layers.py:372-381``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 biases: bool = True):
        super().__init__()
        self.conv = ncsn_conv(cin, cout, kernel, bias=biases)

    def forward(self, x):
        return self.conv(avg_pool_2x2(x))


class UpsampleConv(nn.Module):
    """The reference's cat-4 + PixelShuffle(2) upsample, then a conv
    (``layers.py:384-394``).  Not a nearest upsample where C > 1: output
    channel c's quadrant (i, j) reads channel (4c + 2i + j) mod C, a fixed
    channel shuffle, kept as the reference computes it."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 biases: bool = True):
        super().__init__()
        self.conv = ncsn_conv(cin, cout, kernel, bias=biases)

    def forward(self, x):
        b, h, w, c = x.shape
        rows = []
        for i in range(2):
            quads = [x[..., (4 * np.arange(c) + 2 * i + j) % c]
                     for j in range(2)]
            rows.append(torch.stack(quads, dim=3))       # (b, h, w, 2, c)
        up = torch.stack(rows, dim=2).reshape(b, 2 * h, 2 * w, c)
        return self.conv(up)


class _ResidualBase(nn.Module):
    """The NCSNv2 pre-activation residual block and its conditional form
    (``layers.py:397-507``): down-sampling (ConvMeanPool) or dilation (the
    convs padded by it; a dilated "down" block does not down-sample, as in
    the reference), a conv or 1x1 shortcut where the width changes."""

    conditional = False

    def __init__(self, cin: int, features: int, resample=None, act=F.elu,
                 norm=None, adjust_padding: bool = False, dilation: int = 1):
        super().__init__()
        if resample not in (None, "down"):
            raise ValueError("invalid resample value")
        self.act = act
        self.norm1 = norm(cin)
        if resample == "down":
            self.conv1 = ncsn_conv(cin, cin, dilation=dilation)
            self.norm2 = norm(cin)
            if dilation > 1:
                self.conv2 = ncsn_conv(cin, features, dilation=dilation)
                self.shortcut = ncsn_conv(cin, features, dilation=dilation)
            else:
                self.conv2 = ConvMeanPool(cin, features, 3,
                                          adjust_padding=adjust_padding)
                self.shortcut = ConvMeanPool(cin, features, 1,
                                             adjust_padding=adjust_padding)
        else:
            self.conv1 = ncsn_conv(cin, features, dilation=dilation)
            self.norm2 = norm(features)
            self.conv2 = ncsn_conv(features, features, dilation=dilation)
            if features != cin:
                self.shortcut = (ncsn_conv(cin, features, dilation=dilation)
                                 if dilation > 1 else
                                 ncsn_conv(cin, features, 1))

    def _norm(self, norm, h, y):
        return norm(h, y) if self.conditional else norm(h)

    def forward(self, x, y=None):
        h = self.act(self._norm(self.norm1, x, y))
        h = self.conv1(h)
        h = self.act(self._norm(self.norm2, h, y))
        h = self.conv2(h)
        shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
        return shortcut + h


class ResidualBlock(_ResidualBase):
    """The NCSNv2 residual block; ``norm`` takes the channel count."""


class ConditionalResidualBlock(_ResidualBase):
    """The class-conditional residual block; ``norm(c)(x, y)``."""

    conditional = True


@torch.no_grad()
def init_ncsn(model: nn.Module, generator: torch.Generator):
    """Draw every :class:`NCSNConv`'s weight and bias from U(-b, b) times
    its scale, b = 1/sqrt(fan_in), as the JAX ``_NCSNConv`` does."""
    for mod in model.modules():
        if isinstance(mod, NCSNConv):
            w = mod.weight
            bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
            for p in (w, mod.bias):
                if p is not None:
                    p.copy_(mod.ncsn_scale * torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator))
