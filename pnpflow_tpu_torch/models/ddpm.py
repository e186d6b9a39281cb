"""The DDPM noise network on NHWC tensors (port of
``pnpflow_tpu/models/ddpm.py``).

The reference DDPM (``image_generation/models/ddpm.py:39-181``, blocks
``layers.py:558-662``): sinusoidal conditioning, residual blocks with
GroupNorm(32, eps 1e-6) and a NIN shortcut, NIN attention, nearest-2x up
and strided (0, 1)-padded down resampling, a near-zero final conv, and the
NCSN-style ``scale_by_sigma`` division by ``sigmas[labels]``.  Plain
PyTorch, as the JAX module is plain XLA.

Parameters keep the reference torch layout: every module sits in
``all_modules`` in construction order (``all_modules.{i}.GroupNorm_0.
weight``, ``all_modules.{i}.Conv_0.weight``, ...) beside the ``sigmas``
buffer, so a reference DDPM ``state_dict`` loads with ``load_state_dict``
(strict), and ``pnpflow_tpu/utils/ddpm_convert.py:convert_ddpm_state_dict``
carries the port's weights to the JAX tree.  As in the reference every
residual block has its ``Dense_0`` even when the model is unconditional
(the forward then leaves it unused).  Weights start from
``models/ncsnpp.py:init_ncsnpp``'s seeded variance-scaling draw.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pnpflow_tpu_torch.models.ncsn_layers import get_act
from pnpflow_tpu_torch.models.ncsnpp import (
    NIN, _conv, _dense, _gn, _scaled, conv3x3)
from pnpflow_tpu_torch.models.unet import sinusoidal_embedding


def _gn32(ch: int) -> nn.GroupNorm:
    """GroupNorm(32, eps 1e-6), DDPM's norm (``layers.py:625``)."""
    return nn.GroupNorm(32, ch, eps=1e-6)


class ResnetBlockDDPM(nn.Module):
    """GN-act-conv, + the time embedding, GN-act-dropout-conv (init scale
    0), a NIN or conv shortcut where the width changes
    (``layers.py:619-662``)."""

    def __init__(self, act, in_ch: int, out_ch: int | None = None,
                 temb_dim: int | None = None, conv_shortcut: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act, self.dropout = act, dropout
        self.GroupNorm_0 = _gn32(in_ch)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = _scaled(nn.Linear(temb_dim, out_ch), 1.0)
        self.GroupNorm_1 = _gn32(out_ch)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=0.0)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def forward(self, x, temb=None):
        dt = x.dtype
        h = _conv(self.act(_gn(x, self.GroupNorm_0)), self.Conv_0, dt)
        if temb is not None:
            h = h + _dense(self.act(temb), self.Dense_0, dt)[:, None, None, :]
        h = self.act(_gn(h, self.GroupNorm_1))
        h = F.dropout(h, self.dropout, self.training)
        h = _conv(h, self.Conv_1, dt)
        if hasattr(self, "Conv_2"):
            x = _conv(x, self.Conv_2, dt)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        return x + h


class AttnBlockDDPM(nn.Module):
    """NIN attention behind GroupNorm(32), no skip rescale
    (``layers.py:558-581``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.GroupNorm_0 = _gn32(ch)
        self.NIN_0, self.NIN_1, self.NIN_2 = (NIN(ch, ch) for _ in range(3))
        self.NIN_3 = NIN(ch, ch, init_scale=0.0)

    def forward(self, x):
        b, hh, ww, c = x.shape
        h = _gn(x, self.GroupNorm_0)
        q, k, v = (m(h).reshape(b, hh * ww, c)
                   for m in (self.NIN_0, self.NIN_1, self.NIN_2))
        w = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        w = torch.softmax(w, dim=-1)
        h = torch.matmul(w, v.float()).to(x.dtype).reshape(b, hh, ww, c)
        return x + self.NIN_3(h)


class UpsampleDDPM(nn.Module):
    """Nearest 2x, then a 3x3 conv with ``with_conv`` (``layers.py:584-596``)."""

    def __init__(self, ch: int, with_conv: bool = False):
        super().__init__()
        if with_conv:
            self.Conv_0 = conv3x3(ch, ch)

    def forward(self, x):
        h = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _conv(h, self.Conv_0, x.dtype) if hasattr(
            self, "Conv_0") else h


class DownsampleDDPM(nn.Module):
    """A stride-2 3x3 conv after a (0, 1) pad of each spatial axis (the
    reference's 'SAME' emulation, ``layers.py:599-616``), or a 2x2 average
    pool."""

    def __init__(self, ch: int, with_conv: bool = False):
        super().__init__()
        if with_conv:
            self.Conv_0 = _scaled(nn.Conv2d(ch, ch, 3, stride=2), 1.0)

    def forward(self, x):
        if hasattr(self, "Conv_0"):
            return _conv(F.pad(x, (0, 0, 0, 1, 0, 1)), self.Conv_0, x.dtype)
        b, h, w, c = x.shape
        return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class DDPM(nn.Module):
    """The DDPM U-Net: ``forward(x, labels)`` on NHWC ``x``; ``labels`` are
    the timesteps (the sinusoidal embedding's argument) and, with
    ``scale_by_sigma``, the indices into ``sigmas``."""

    def __init__(self, nf: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.1, resamp_with_conv: bool = True,
                 conditional: bool = True, image_size: int = 32,
                 channels: int = 3, centered: bool = True,
                 scale_by_sigma: bool = False, nonlinearity: str = "swish",
                 sigmas: Sequence[float] = (50.0, 0.01)):
        super().__init__()
        self.act = get_act(nonlinearity)
        self.nf, self.ch_mult = nf, tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.conditional, self.centered = conditional, centered
        self.scale_by_sigma, self.image_size = scale_by_sigma, image_size
        self.register_buffer("sigmas", torch.tensor(
            np.asarray(sigmas, np.float32)))
        nres = len(ch_mult)
        all_res = [image_size // (2 ** i) for i in range(nres)]

        def block(cin, cout=None):
            return ResnetBlockDDPM(self.act, cin, cout, temb_dim=4 * nf,
                                   dropout=dropout)

        mods = []
        if conditional:
            mods.append(_scaled(nn.Linear(nf, nf * 4), 1.0))
            mods.append(_scaled(nn.Linear(nf * 4, nf * 4), 1.0))
        mods.append(conv3x3(channels, nf))
        hs_c, in_ch = [nf], nf
        for lev in range(nres):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[lev]
                mods.append(block(in_ch, out_ch))
                in_ch = out_ch
                if all_res[lev] in self.attn_resolutions:
                    mods.append(AttnBlockDDPM(in_ch))
                hs_c.append(in_ch)
            if lev != nres - 1:
                mods.append(DownsampleDDPM(in_ch, resamp_with_conv))
                hs_c.append(in_ch)
        mods += [block(in_ch), AttnBlockDDPM(in_ch), block(in_ch)]
        for lev in reversed(range(nres)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[lev]
                mods.append(block(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if all_res[lev] in self.attn_resolutions:
                mods.append(AttnBlockDDPM(in_ch))
            if lev != 0:
                mods.append(UpsampleDDPM(in_ch, resamp_with_conv))
        assert not hs_c
        mods.append(_gn32(in_ch))
        mods.append(conv3x3(in_ch, channels, init_scale=0.0))
        self.all_modules = nn.ModuleList(mods)

    def forward(self, x, labels):
        mods = iter(self.all_modules)
        nres = len(self.ch_mult)
        all_res = [self.image_size // (2 ** i) for i in range(nres)]
        dt = x.dtype
        if self.conditional:
            temb = sinusoidal_embedding(labels, self.nf)
            temb = _dense(temb, next(mods), dt)
            temb = _dense(self.act(temb), next(mods), dt)
        else:
            temb = None
        h = x if self.centered else 2.0 * x - 1.0

        hs = [_conv(h.contiguous(), next(mods), dt)]
        for lev in range(nres):
            for _ in range(self.num_res_blocks):
                h = next(mods)(hs[-1], temb)
                if all_res[lev] in self.attn_resolutions:
                    h = next(mods)(h)
                hs.append(h)
            if lev != nres - 1:
                hs.append(next(mods)(hs[-1]))
        h = next(mods)(hs[-1], temb)
        h = next(mods)(h)
        h = next(mods)(h, temb)
        for lev in reversed(range(nres)):
            for _ in range(self.num_res_blocks + 1):
                h = next(mods)(torch.cat([h, hs.pop()], dim=-1), temb)
            if all_res[lev] in self.attn_resolutions:
                h = next(mods)(h)
            if lev != 0:
                h = next(mods)(h)
        assert not hs
        h = self.act(_gn(h, next(mods)))
        h = _conv(h, next(mods), dt)
        if self.scale_by_sigma:
            h = h / self.sigmas[labels.long()][:, None, None, None]
        return h
