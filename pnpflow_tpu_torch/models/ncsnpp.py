"""NCSN++ score/velocity network in PyTorch, NHWC activations: the
``rectified`` backbone.

Port of ``pnpflow_tpu/models/ncsnpp.py`` (the RectifiedFlow NCSN++ for
CelebA-HQ / AFHQ-Cat 256x256): Gaussian-Fourier log-t embedding (or the
positional embedding with its SMLD noise table), BigGAN or DDPM residual
blocks with FIR up/downsampling, NIN attention at the configured
resolutions, the input_skip / output_skip pyramids with a 'sum' combine,
skip_rescale (x + h)/sqrt(2) and the scale_by_sigma output division.

Parameters keep the reference torch layout: every submodule sits in
``all_modules`` in the order the forward consumes it (``all_modules.{i}.
GroupNorm_0.weight``, ``all_modules.{i}.Conv2d_0.weight``, ...), beside the
``sigmas`` buffer; the Fourier ``all_modules.0.W`` is a frozen parameter.
So a RectifiedFlow ``state_dict`` loads with ``load_state_dict``, and
``pnpflow_tpu/utils/ncsnpp_convert.py:convert_ncsnpp_state_dict`` maps the
port's ``state_dict`` onto the JAX parameter tree.

The FIR resampling goes through ``ops/upfirdn.py`` (the ``upfirdn2d`` kernel
on CUDA tensors).  GroupNorm is plain ``F.group_norm`` (``min(C // 4, 32)``
groups, eps 1e-6), and the convolutions and attention products are plain
``F.conv2d`` / ``torch.matmul``: the JAX package computes them outside any
kernel of its own too.  ``dtype`` is the compute dtype; parameters stay
float32 and are cast per call, and GroupNorm statistics stay float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pnpflow_tpu_torch.models.unet import sinusoidal_embedding
from pnpflow_tpu_torch.ops.upfirdn import (
    conv_downsample_2d, downsample_2d, naive_downsample_2d, naive_upsample_2d,
    upsample_2d, upsample_conv_2d)

_SQRT2 = math.sqrt(2.0)


def _group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(ch // 4, 32), ch, eps=1e-6)


def _gn(x, norm: nn.GroupNorm):
    """GroupNorm on NHWC with float32 statistics, output NHWC-contiguous in
    x's dtype (the FIR kernel reads it as it lies).  The input goes in as a
    contiguous NCHW copy, as the CUDA group_norm makes it anyway: under a
    JVP inside ``torch.func.grad`` group_norm's decomposition views its
    input, which a channels-last view refuses."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2).contiguous(),
                     norm.num_groups, norm.weight, norm.bias, norm.eps)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _scaled(mod: nn.Module, init_scale: float) -> nn.Module:
    """Tag a layer with its ``vs_init`` scale for :func:`init_ncsnpp`."""
    mod.init_scale = init_scale
    return mod


def conv3x3(cin: int, cout: int, init_scale: float = 1.0) -> nn.Conv2d:
    return _scaled(nn.Conv2d(cin, cout, 3, padding=1), init_scale)


def conv1x1(cin: int, cout: int, init_scale: float = 1.0) -> nn.Conv2d:
    return _scaled(nn.Conv2d(cin, cout, 1), init_scale)


def _conv(x, conv: nn.Conv2d, dtype):
    """A plain NHWC convolution through a channels_last view."""
    if conv.kernel_size == (1, 1):
        w = conv.weight[:, :, 0, 0].to(dtype)
        return torch.matmul(x, w.t()) + conv.bias.to(dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dtype),
                 conv.bias.to(dtype), conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1).contiguous()


def _dense(x, lin: nn.Linear, dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class NIN(nn.Module):
    """1x1 dense over the channel axis: ``x @ W + b`` with W (in, out)."""

    def __init__(self, cin: int, cout: int, init_scale: float = 1.0):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))
        self.init_scale = init_scale

    def forward(self, x):
        dt = x.dtype
        return torch.matmul(x, self.W.to(dt)) + self.b.to(dt)


class GaussianFourierProjection(nn.Module):
    """sin/cos of 2*pi*W*x; W (embedding_size,) is frozen."""

    def __init__(self, embedding_size: int, scale: float = 16.0):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(embedding_size),
                              requires_grad=False)
        self.scale = scale

    def forward(self, x):
        proj = x.float()[:, None] * self.W[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class AttnBlockpp(nn.Module):
    """NIN-based single-head attention with float32 logits."""

    def __init__(self, ch: int, init_scale: float = 0.0,
                 skip_rescale: bool = True):
        super().__init__()
        self.GroupNorm_0 = _group_norm(ch)
        self.NIN_0 = NIN(ch, ch)
        self.NIN_1 = NIN(ch, ch)
        self.NIN_2 = NIN(ch, ch)
        self.NIN_3 = NIN(ch, ch, init_scale=init_scale)
        self.skip_rescale = skip_rescale

    def forward(self, x):
        b, hh, ww, c = x.shape
        h = _gn(x, self.GroupNorm_0)
        q = self.NIN_0(h).reshape(b, hh * ww, c)
        k = self.NIN_1(h).reshape(b, hh * ww, c)
        v = self.NIN_2(h).reshape(b, hh * ww, c)
        w = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        w = torch.softmax(w, dim=-1).to(v.dtype)
        h = torch.matmul(w.float(), v.float()).to(x.dtype)
        h = self.NIN_3(h.reshape(b, hh, ww, c))
        out = x + h
        return out / _SQRT2 if self.skip_rescale else out


class FIRConv(nn.Module):
    """The weight (O, I, 3, 3) and bias of a FIR resample fused with a
    3x3 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.init_scale = 1.0


class Upsample(nn.Module):
    """FIR / nearest upsample, optionally fused with a 3x3 conv."""

    def __init__(self, ch: int, out_ch: int | None = None,
                 with_conv: bool = False, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, fir_kernel
        if with_conv and fir:
            self.Conv2d_0 = FIRConv(ch, out_ch)
        elif with_conv:
            self.Conv_0 = conv3x3(ch, out_ch)

    def forward(self, x):
        dt = x.dtype
        if not self.fir:
            y = naive_upsample_2d(x)
            return _conv(y, self.Conv_0, dt) if self.with_conv else y
        if not self.with_conv:
            return upsample_2d(x, self.fir_kernel, factor=2)
        y = upsample_conv_2d(x, self.Conv2d_0.weight, k=self.fir_kernel,
                             factor=2)
        return y + self.Conv2d_0.bias.to(y.dtype)


class Downsample(nn.Module):
    """FIR / average-pool downsample, optionally fused with a 3x3 conv."""

    def __init__(self, ch: int, out_ch: int | None = None,
                 with_conv: bool = False, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, fir_kernel
        if with_conv and fir:
            self.Conv2d_0 = FIRConv(ch, out_ch)
        elif with_conv:
            self.Conv_0 = _scaled(nn.Conv2d(ch, out_ch, 3, stride=2), 1.0)

    def forward(self, x):
        dt = x.dtype
        if not self.fir:
            if self.with_conv:
                return _conv(F.pad(x, (0, 0, 0, 1, 0, 1)), self.Conv_0, dt)
            return naive_downsample_2d(x)
        if not self.with_conv:
            return downsample_2d(x, self.fir_kernel, factor=2)
        y = conv_downsample_2d(x, self.Conv2d_0.weight, k=self.fir_kernel,
                               factor=2)
        return y + self.Conv2d_0.bias.to(y.dtype)


class ResnetBlockBigGAN(nn.Module):
    """BigGAN residual block with in-block FIR resampling."""

    def __init__(self, in_ch: int, out_ch: int | None = None,
                 temb_dim: int | None = None, up: bool = False,
                 down: bool = False, dropout: float = 0.0, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 skip_rescale: bool = True, init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        self.fir, self.fir_kernel = fir, fir_kernel
        self.dropout, self.skip_rescale = dropout, skip_rescale
        self.GroupNorm_0 = _group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = _scaled(nn.Linear(temb_dim, out_ch), 1.0)
        self.GroupNorm_1 = _group_norm(out_ch)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch or up or down:
            self.Conv_2 = conv1x1(in_ch, out_ch)

    def forward(self, x, temb=None):
        dt = x.dtype
        h = F.silu(_gn(x, self.GroupNorm_0))
        if self.up:
            if self.fir:
                h = upsample_2d(h, self.fir_kernel, factor=2)
                x = upsample_2d(x, self.fir_kernel, factor=2)
            else:
                h, x = naive_upsample_2d(h), naive_upsample_2d(x)
        elif self.down:
            if self.fir:
                h = downsample_2d(h, self.fir_kernel, factor=2)
                x = downsample_2d(x, self.fir_kernel, factor=2)
            else:
                h, x = naive_downsample_2d(h), naive_downsample_2d(x)
        h = _conv(h, self.Conv_0, dt)
        if temb is not None:
            h = h + _dense(F.silu(temb), self.Dense_0, dt)[:, None, None, :]
        h = F.silu(_gn(h, self.GroupNorm_1))
        h = F.dropout(h, self.dropout, self.training)
        h = _conv(h, self.Conv_1, dt)
        if hasattr(self, "Conv_2"):
            x = _conv(x, self.Conv_2, dt)
        out = x + h
        return out / _SQRT2 if self.skip_rescale else out


class ResnetBlockDDPM(nn.Module):
    """DDPM residual block (no in-block resampling; a NIN shortcut when the
    channel count changes)."""

    def __init__(self, in_ch: int, out_ch: int | None = None,
                 temb_dim: int | None = None, conv_shortcut: bool = False,
                 dropout: float = 0.0, skip_rescale: bool = True,
                 init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.dropout, self.skip_rescale = dropout, skip_rescale
        self.GroupNorm_0 = _group_norm(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = _scaled(nn.Linear(temb_dim, out_ch), 1.0)
        self.GroupNorm_1 = _group_norm(out_ch)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def forward(self, x, temb=None):
        dt = x.dtype
        h = F.silu(_gn(x, self.GroupNorm_0))
        h = _conv(h, self.Conv_0, dt)
        if temb is not None:
            h = h + _dense(F.silu(temb), self.Dense_0, dt)[:, None, None, :]
        h = F.silu(_gn(h, self.GroupNorm_1))
        h = F.dropout(h, self.dropout, self.training)
        h = _conv(h, self.Conv_1, dt)
        if hasattr(self, "Conv_2"):
            x = _conv(x, self.Conv_2, dt)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        out = x + h
        return out / _SQRT2 if self.skip_rescale else out


class Combine(nn.Module):
    """Progressive-input combiner: 1x1 conv of the pyramid, then sum or
    concat."""

    def __init__(self, cin: int, cout: int, method: str = "sum"):
        super().__init__()
        self.Conv_0 = conv1x1(cin, cout)
        self.method = method

    def forward(self, x, y):
        h = _conv(x, self.Conv_0, y.dtype)
        if self.method == "cat":
            return torch.cat([h, y], dim=-1)
        return h + y


class NCSNpp(nn.Module):
    """NCSN++ on NHWC images: ``forward(x, time_cond) -> float32``.

    ``time_cond`` is t*999 (fourier) or the integer noise label
    (positional); the model exposes ``nf``, ``ch_mult``, ``num_res_blocks``
    and ``attn_resolutions`` for the checkpoint fingerprint.
    """

    def __init__(self, image_size: int = 256, num_channels: int = 3,
                 nf: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 2, 2, 2),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 conditional: bool = True, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 skip_rescale: bool = True, resblock_type: str = "biggan",
                 progressive: str = "output_skip",
                 progressive_input: str = "input_skip",
                 progressive_combine: str = "sum",
                 embedding_type: str = "fourier", fourier_scale: float = 16.0,
                 init_scale: float = 0.0, scale_by_sigma: bool = True,
                 sigma_min: float = 0.01, sigma_max: float = 50.0,
                 num_scales: int = 1000, centered: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if resblock_type not in ("biggan", "ddpm"):
            raise ValueError(f"unknown resblock_type {resblock_type!r}")
        if embedding_type not in ("fourier", "positional"):
            raise ValueError(f"unknown embedding_type {embedding_type!r}")
        self.image_size, self.num_channels, self.nf = image_size, num_channels, nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.resblock_type, self.conditional = resblock_type, conditional
        self.fir_kernel = tuple(fir_kernel)
        self.progressive, self.progressive_input = progressive, progressive_input
        self.embedding_type, self.scale_by_sigma = embedding_type, scale_by_sigma
        self.centered, self.dtype = centered, dtype
        sigmas = np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min),
                                    num_scales))
        self.register_buffer("sigmas", torch.tensor(sigmas, dtype=torch.float32))

        nres = len(ch_mult)
        all_res = [image_size // (2**i) for i in range(nres)]
        ddpm = resblock_type == "ddpm"
        mods = []
        if embedding_type == "fourier":
            mods.append(GaussianFourierProjection(nf, fourier_scale))
            embed_dim = 2 * nf
        else:
            embed_dim = nf
        temb_dim = None
        if conditional:
            mods.append(_scaled(nn.Linear(embed_dim, nf * 4), 1.0))
            mods.append(_scaled(nn.Linear(nf * 4, nf * 4), 1.0))
            temb_dim = nf * 4

        def res_block(cin, cout=None, up=False, down=False):
            if ddpm:
                return ResnetBlockDDPM(cin, cout, temb_dim, dropout=dropout,
                                       skip_rescale=skip_rescale,
                                       init_scale=init_scale)
            return ResnetBlockBigGAN(cin, cout, temb_dim, up=up, down=down,
                                     dropout=dropout, fir=fir,
                                     fir_kernel=fir_kernel,
                                     skip_rescale=skip_rescale,
                                     init_scale=init_scale)

        def attn_block(ch):
            return AttnBlockpp(ch, init_scale=init_scale,
                               skip_rescale=skip_rescale)

        mods.append(conv3x3(num_channels, nf))
        hs_c, in_ch = [nf], nf
        for lev in range(nres):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[lev]
                mods.append(res_block(in_ch, out_ch))
                in_ch = out_ch
                if all_res[lev] in self.attn_resolutions:
                    mods.append(attn_block(in_ch))
                hs_c.append(in_ch)
            if lev != nres - 1:
                if ddpm:
                    mods.append(Downsample(in_ch, with_conv=resamp_with_conv,
                                           fir=fir, fir_kernel=fir_kernel))
                else:
                    mods.append(res_block(in_ch, down=True))
                if progressive_input == "input_skip":
                    mods.append(Combine(num_channels, in_ch,
                                        progressive_combine))
                    if progressive_combine == "cat":
                        in_ch *= 2
                hs_c.append(in_ch)

        mods += [res_block(in_ch), attn_block(in_ch), res_block(in_ch)]

        for lev in reversed(range(nres)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[lev]
                mods.append(res_block(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if all_res[lev] in self.attn_resolutions:
                mods.append(attn_block(in_ch))
            if progressive == "output_skip":
                mods.append(_group_norm(in_ch))
                mods.append(conv3x3(in_ch, num_channels, init_scale))
            if lev != 0:
                if ddpm:
                    mods.append(Upsample(in_ch, with_conv=resamp_with_conv,
                                         fir=fir, fir_kernel=fir_kernel))
                else:
                    mods.append(res_block(in_ch, up=True))
        assert not hs_c
        if progressive != "output_skip":
            mods.append(_group_norm(in_ch))
            mods.append(conv3x3(in_ch, num_channels, init_scale))
        self.all_modules = nn.ModuleList(mods)

    def forward(self, x, time_cond):
        if x.dim() != 4 or x.shape[-1] != self.num_channels:
            raise ValueError(f"expected NHWC input, got {tuple(x.shape)}")
        dt = self.dtype
        mods = iter(self.all_modules)
        nres = len(self.ch_mult)
        all_res = [self.image_size // (2**i) for i in range(nres)]
        ddpm = self.resblock_type == "ddpm"
        x = x.to(dt).contiguous()

        if self.embedding_type == "fourier":
            used_sigmas = time_cond
            temb = next(mods)(torch.log(time_cond.float()))
        else:
            used_sigmas = self.sigmas[time_cond.long()]
            temb = sinusoidal_embedding(time_cond, self.nf)
        if self.conditional:
            temb = _dense(temb, next(mods), dt)
            temb = _dense(F.silu(temb), next(mods), dt)
        else:
            temb = None

        if not self.centered:
            x = 2.0 * x - 1.0

        input_pyramid = x if self.progressive_input != "none" else None
        hs = [_conv(x, next(mods), dt)]
        for lev in range(nres):
            for _ in range(self.num_res_blocks):
                h = next(mods)(hs[-1], temb)
                if all_res[lev] in self.attn_resolutions:
                    h = next(mods)(h)
                hs.append(h)
            if lev != nres - 1:
                h = next(mods)(hs[-1]) if ddpm else next(mods)(hs[-1], temb)
                if self.progressive_input == "input_skip":
                    input_pyramid = downsample_2d(input_pyramid,
                                                  self.fir_kernel, factor=2)
                    h = next(mods)(input_pyramid, h)
                hs.append(h)

        h = next(mods)(hs[-1], temb)
        h = next(mods)(h)
        h = next(mods)(h, temb)

        pyramid = None
        for lev in reversed(range(nres)):
            for _ in range(self.num_res_blocks + 1):
                h = next(mods)(torch.cat([h, hs.pop()], dim=-1), temb)
            if all_res[lev] in self.attn_resolutions:
                h = next(mods)(h)
            if self.progressive == "output_skip":
                if lev != nres - 1:
                    pyramid = upsample_2d(pyramid, self.fir_kernel, factor=2)
                p = F.silu(_gn(h, next(mods)))
                p = _conv(p, next(mods), dt)
                pyramid = p if pyramid is None else pyramid + p
            if lev != 0:
                h = next(mods)(h) if ddpm else next(mods)(h, temb)
        assert not hs

        if self.progressive == "output_skip":
            h = pyramid
        else:
            h = F.silu(_gn(h, next(mods)))
            h = _conv(h, next(mods), dt)
        if self.scale_by_sigma:
            h = h / used_sigmas[:, None, None, None].to(h.dtype)
        return h.float()


def make_ncsnpp(args, dtype=torch.float32) -> NCSNpp:
    """The rectified-flow configuration (CelebA-HQ / AFHQ-Cat 256^2)."""
    return NCSNpp(image_size=args.dim_image, num_channels=args.num_channels,
                  dtype=dtype)



def make_ncsnpp_from_config(config, dtype=torch.float32) -> NCSNpp:
    """NCSN++ from a reference-shaped config tree (the ``model.*`` and
    ``data.*`` keys of ``config/rf_configs.py``), as the JAX
    ``make_ncsnpp_from_config``: both resblock types, either embedding,
    ``fir`` True or False, the progressive pyramids or none."""
    m, d = config.model, config.data
    return NCSNpp(
        image_size=d.image_size, num_channels=d.num_channels, nf=m.nf,
        ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions), dropout=m.dropout,
        resamp_with_conv=m.resamp_with_conv, conditional=m.conditional,
        fir=m.fir, fir_kernel=tuple(m.fir_kernel),
        skip_rescale=m.skip_rescale,
        resblock_type=m.get("resblock_type", "biggan"),
        progressive=m.progressive, progressive_input=m.progressive_input,
        progressive_combine=m.progressive_combine,
        embedding_type=m.get("embedding_type", "fourier"),
        fourier_scale=m.fourier_scale, init_scale=m.init_scale,
        scale_by_sigma=m.scale_by_sigma,
        sigma_min=m.get("sigma_min", 0.01), sigma_max=m.get("sigma_max", 50.0),
        num_scales=m.get("num_scales", 1000),
        centered=d.get("centered", True), dtype=dtype)

@torch.no_grad()
def init_ncsnpp(model: NCSNpp, seed: int = 0) -> NCSNpp:
    """Seeded init following the JAX ``vs_init``: variance-scaling fan_avg
    uniform with limit sqrt(3 * max(scale, 1e-10) / fan_avg) for every
    tagged weight (``init_scale`` 0 makes Conv_1, NIN_3 and the output
    convs near zero, as in the JAX package), zero biases, GroupNorm (1, 0),
    Fourier W ~ N(0, fourier_scale^2).  Draws from a CPU generator."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, GaussianFourierProjection):
            mod.W.copy_(torch.randn(mod.W.shape, generator=gen) * mod.scale)
        elif hasattr(mod, "init_scale"):
            w = mod.W if isinstance(mod, NIN) else mod.weight
            rf = w[0, 0].numel() if w.dim() == 4 else 1
            fan_avg = (w.shape[0] + w.shape[1]) * rf / 2.0
            lim = math.sqrt(3.0 * max(mod.init_scale, 1e-10) / fan_avg)
            w.copy_(torch.empty(w.shape).uniform_(-lim, lim, generator=gen))
            (mod.b if isinstance(mod, NIN) else mod.bias).zero_()
    return model
