"""Guided-diffusion UNet ("DiffUNet") in PyTorch: the pnp_diff prior.

Port of ``pnpflow_tpu/models/diffunet.py``, the OpenAI guided-diffusion
256x256 unconditional UNet in the DiffPIR ``ffhq_10m`` configuration:
model_channels 128, channel_mult (1, 1, 2, 2, 4, 4), one res block a level,
attention at downsample ratios 16 and 8 with 64-channel heads, scale-shift
GroupNorm conditioning, resblock up/down sampling, 6 output channels (the
epsilon prediction is the first ``in_channels``).

The forward takes and returns NHWC, as every model of the port does, and
runs NCHW inside, the layout of ``F.conv2d``, ``F.group_norm``,
``F.interpolate`` and ``F.avg_pool2d``.  GroupNorm(32, eps 1e-5) is plain
``F.group_norm`` and attention plain ``torch.matmul`` and softmax: the JAX
package computes them outside any kernel of its own too.

Parameter names follow the flax module names (``down_{l}_res_{i}.in_norm``,
``mid_attn.qkv``, ``up_{l}_upsample.out_conv``, ...), so
``utils/jax_params.py:diffunet_state_dict_from_flax`` only transposes.  The
module exposes ``num_res_blocks`` and none of ``ch``, ``nf``, ``ch_mult``
and ``attn_resolutions``: the checkpoint fingerprint reads those fields
where they exist, and the JAX DiffUNet has only the first.  The model runs
in float32 whatever dtype the caller asks for, as JAX's ``make_diffunet``
drops it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """guided-diffusion's sinusoidal embedding: cat(cos, sin) with freqs
    exp(-ln(P) * i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _gn32(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-5)


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResBlock(nn.Module):
    """Scale-shift-norm ResBlock with optional in-block 2x nearest up or
    2x2 average-pool down sampling (NCHW)."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_norm = _gn32(in_ch)
        self.in_conv = _conv3x3(in_ch, out_ch)
        self.emb_dense = nn.Linear(emb_ch, 2 * out_ch)
        self.out_norm = _gn32(out_ch)
        self.out_conv = _conv3x3(out_ch, out_ch)
        if in_ch != out_ch:
            self.skip_conv = nn.Conv2d(in_ch, out_ch, 1)

    def _resample(self, z):
        if self.up:
            return F.interpolate(z, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(z, 2)
        return z

    def forward(self, x, emb):
        h = F.silu(self.in_norm(x))
        h = self.in_conv(self._resample(h))
        x = self._resample(x)
        scale, shift = self.emb_dense(F.silu(emb)).chunk(2, dim=-1)
        h = self.out_norm(h) * (1.0 + scale[:, :, None, None]) \
            + shift[:, :, None, None]
        h = self.out_conv(F.silu(h))
        if hasattr(self, "skip_conv"):
            x = self.skip_conv(x)
        return x + h


class AttentionBlock(nn.Module):
    """Multi-head self-attention over the spatial grid: qkv split as
    [q | k | v] along the channels, heads of ``num_head_channels``."""

    def __init__(self, ch: int, num_head_channels: int = 64):
        super().__init__()
        self.heads = max(ch // num_head_channels, 1)
        self.norm = _gn32(ch)
        self.qkv = nn.Linear(ch, 3 * ch)
        self.proj = nn.Linear(ch, ch)

    def forward(self, x):
        b, c, hh, ww = x.shape
        heads, hd = self.heads, c // self.heads
        h = self.norm(x).reshape(b, c, hh * ww).transpose(1, 2)
        q, k, v = (z.reshape(b, hh * ww, heads, hd).transpose(1, 2)
                   for z in self.qkv(h).chunk(3, dim=-1))
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2))
                          / math.sqrt(hd), dim=-1)
        o = torch.matmul(w, v).transpose(1, 2).reshape(b, hh * ww, c)
        return x + self.proj(o).transpose(1, 2).reshape(b, c, hh, ww)


class DiffUNet(nn.Module):
    """guided-diffusion UNet ``(x_nhwc, t) -> (B, H, W, out_channels)``,
    ``t`` the raw diffusion timestep."""

    def __init__(self, in_channels: int = 3, out_channels: int = 6,
                 model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 num_res_blocks: int = 1,
                 attention_ds: Sequence[int] = (16, 8),
                 num_head_channels: int = 64):
        super().__init__()
        self.in_channels = in_channels
        self.model_channels = mc = model_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.attention_ds = tuple(attention_ds)
        emb = 4 * mc
        nlev = len(channel_mult)

        def attn(name, ch):
            self.add_module(name, AttentionBlock(ch, num_head_channels))

        self.time_dense_0 = nn.Linear(mc, emb)
        self.time_dense_1 = nn.Linear(emb, emb)
        self.in_conv = _conv3x3(in_channels, mc)
        hs, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_res_{i}",
                                ResBlock(ch, mc * mult, emb))
                ch = mc * mult
                if ds in self.attention_ds:
                    attn(f"down_{level}_attn_{i}", ch)
                hs.append(ch)
            if level != nlev - 1:
                self.add_module(f"down_{level}_downsample",
                                ResBlock(ch, ch, emb, down=True))
                hs.append(ch)
                ds *= 2
        self.mid_res_0 = ResBlock(ch, ch, emb)
        attn("mid_attn", ch)
        self.mid_res_1 = ResBlock(ch, ch, emb)
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_res_{i}",
                                ResBlock(ch + hs.pop(), mc * mult, emb))
                ch = mc * mult
                if ds in self.attention_ds:
                    attn(f"up_{level}_attn_{i}", ch)
            if level != 0:
                self.add_module(f"up_{level}_upsample",
                                ResBlock(ch, ch, emb, up=True))
                ds //= 2
        assert not hs
        self.out_norm = _gn32(ch)
        self.out_conv = _conv3x3(ch, out_channels)

    def forward(self, x, t):
        if x.dim() != 4 or x.shape[-1] != self.in_channels:
            raise ValueError(f"expected NHWC input, got {tuple(x.shape)}")
        mods = dict(self.named_children())
        emb = self.time_dense_0(timestep_embedding(t, self.model_channels))
        emb = self.time_dense_1(F.silu(emb))
        nlev = len(self.channel_mult)
        hs = [self.in_conv(x.float().permute(0, 3, 1, 2))]
        for level in range(nlev):
            for i in range(self.num_res_blocks):
                h = mods[f"down_{level}_res_{i}"](hs[-1], emb)
                if f"down_{level}_attn_{i}" in mods:
                    h = mods[f"down_{level}_attn_{i}"](h)
                hs.append(h)
            if level != nlev - 1:
                hs.append(mods[f"down_{level}_downsample"](hs[-1], emb))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(hs[-1], emb)), emb)
        for level in reversed(range(nlev)):
            for i in range(self.num_res_blocks + 1):
                h = mods[f"up_{level}_res_{i}"](
                    torch.cat([h, hs.pop()], dim=1), emb)
                if f"up_{level}_attn_{i}" in mods:
                    h = mods[f"up_{level}_attn_{i}"](h)
            if level != 0:
                h = mods[f"up_{level}_upsample"](h, emb)
        assert not hs
        h = self.out_conv(F.silu(self.out_norm(h)))
        return h.permute(0, 2, 3, 1).contiguous()


def make_diffunet(args) -> DiffUNet:
    """The DiffPIR ``ffhq_10m`` configuration for ``args.num_channels``."""
    return DiffUNet(in_channels=args.num_channels)


@torch.no_grad()
def init_diffunet(model: DiffUNet, seed: int = 0) -> DiffUNet:
    """Seeded init following flax's defaults for the JAX DiffUNet: every
    conv and dense kernel lecun-normal (a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in) but the zero-init output
    convs (each ResBlock's ``out_conv`` and the model's) and attention
    ``proj``; biases 0; GroupNorm (1, 0).  With those zeros the model's
    output is 0, as JAX's random init is.  Draws from a CPU generator."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, mod in model.named_modules():
        if isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            mod.bias.zero_()
            if name.rsplit(".", 1)[-1] in ("out_conv", "proj"):
                w.zero_()
                continue
            fan_in = w[0].numel()
            # flax's truncated normal: std / .87962566103423978 restores
            # the variance the truncation at +-2 removes
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
    return model


@torch.no_grad()
def init_diffunet_real_scale(model: DiffUNet, seed: int = 0) -> DiffUNet:
    """Every parameter drawn at a real scale, for comparisons on random
    weights (the zero-init output convs and attention projections of
    :func:`init_diffunet` make the output 0, and any comparison vacuous):
    GroupNorm scales 1 + 0.2 N, other vectors 0.1 N, weights N / sqrt(fan
    in), drawn in ``named_parameters`` order from a CPU generator."""
    norms = {id(mod.weight) for mod in model.modules()
             if isinstance(mod, nn.GroupNorm)}
    gen = torch.Generator().manual_seed(int(seed))
    for p in model.parameters():
        draw = torch.randn(p.shape, generator=gen)
        if id(p) in norms:
            p.copy_(1.0 + 0.2 * draw)
        elif p.dim() == 1:
            p.copy_(0.1 * draw)
        else:
            p.copy_(draw / p[0].numel() ** 0.5)
    return model
