"""Plain float32 velocity U-Net, the yardstick of the PnP-Flow U-Net cells.

The architecture of annegnx/PnP-Flow's ``UNet`` (utils.py:170-180): swish,
GroupNorm(32, eps 1e-6), a sinusoidal t-embedding through a two-layer MLP,
residual blocks with a t-embedding projection, single-head self-attention
at the configured resolutions, a skip-concat up path.  Written in NCHW with
``F.conv2d`` and ``F.group_norm`` only, so it shares no code, layout or
kernel with the program.  Its modules are registered in the program's
order and under its names, so one state dict loads into both and a seeded
init draws the same numbers for both (:func:`init_vs`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def sinusoidal(t, dim: int):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def gn_swish(x, norm: nn.GroupNorm, swish: bool = True):
    y = F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)
    return F.silu(y) if swish else y


class TimeMLP(nn.Module):
    def __init__(self, ch: int, hidden: int):
        super().__init__()
        self.ch = ch
        self.main = nn.Sequential(nn.Linear(ch, hidden), nn.SiLU(),
                                  nn.Linear(hidden, hidden))

    def forward(self, t):
        return self.main(sinusoidal(t, self.ch))


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.temb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb):
        h = self.conv1(gn_swish(x, self.norm1))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(gn_swish(h, self.norm2))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, ch: int, groups: int, eps: float):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=eps)
        self.attn_q = nn.Conv2d(ch, ch, 1)
        self.attn_k = nn.Conv2d(ch, ch, 1)
        self.attn_v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = gn_swish(x, self.norm, swish=False)
        q = self.attn_q(h).reshape(b, c, hh * ww).transpose(1, 2)
        k = self.attn_k(h).reshape(b, c, hh * ww)
        v = self.attn_v(h).reshape(b, c, hh * ww).transpose(1, 2)
        w = torch.softmax(torch.bmm(q, k) * c ** -0.5, dim=-1)
        h = torch.bmm(w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class Up(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.up_conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.up_conv(F.interpolate(x, scale_factor=2.0,
                                          mode="nearest"))


class UNet(nn.Module):
    """``forward(x_nhwc, t) -> v_nhwc`` in float32."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch, mult = cfg["ch"], cfg["ch_mult"]
        nres, attn = cfg["num_res_blocks"], set(cfg["attn_resolutions"])
        g, eps, cimg = cfg["groups"], cfg["eps"], cfg["num_channels"]
        temb = 4 * ch
        self.temb_net = TimeMLP(ch, temb)
        self.begin_conv = nn.Conv2d(cimg, ch, 3, padding=1)
        hs, cur, res = [ch], ch, cfg["image_size"]
        self.down_modules = nn.ModuleList()
        for lev, m in enumerate(mult):
            mods = nn.ModuleDict()
            for b in range(nres):
                mods[f"{lev}a_{b}a_block"] = ResBlock(cur, ch * m, temb, g,
                                                      eps)
                cur = ch * m
                if res in attn:
                    mods[f"{lev}a_{b}b_attn"] = Attention(cur, g, eps)
                hs.append(cur)
            if lev != len(mult) - 1:
                mods[f"{lev}b_downsample"] = nn.Conv2d(cur, cur, 3, stride=2,
                                                       padding=1)
                hs.append(cur)
                res //= 2
            self.down_modules.append(mods)
        self.mid_modules = nn.ModuleList([
            ResBlock(cur, cur, temb, g, eps), Attention(cur, g, eps),
            ResBlock(cur, cur, temb, g, eps)])
        self.up_modules = nn.ModuleList()
        for lev in reversed(range(len(mult))):
            mods = nn.ModuleDict()
            for b in range(nres + 1):
                mods[f"{lev}a_{b}a_block"] = ResBlock(
                    cur + hs.pop(), ch * mult[lev], temb, g, eps)
                cur = ch * mult[lev]
                if res in attn:
                    mods[f"{lev}a_{b}b_attn"] = Attention(cur, g, eps)
            if lev != 0:
                mods[f"{lev}b_upsample"] = Up(cur)
                res *= 2
            self.up_modules.append(mods)
        self.end_conv = nn.Sequential(nn.GroupNorm(g, cur, eps=eps),
                                      nn.SiLU(),
                                      nn.Conv2d(cur, cimg, 3, padding=1))
        self.nlev, self.nres = len(mult), nres

    def forward(self, x, t):
        temb = self.temb_net(t)
        hs = [self.begin_conv(x.float().permute(0, 3, 1, 2))]
        for lev in range(self.nlev):
            mods = self.down_modules[lev]
            for b in range(self.nres):
                h = mods[f"{lev}a_{b}a_block"](hs[-1], temb)
                if f"{lev}a_{b}b_attn" in mods:
                    h = mods[f"{lev}a_{b}b_attn"](h)
                hs.append(h)
            if f"{lev}b_downsample" in mods:
                hs.append(mods[f"{lev}b_downsample"](hs[-1]))
        h = self.mid_modules[0](hs[-1], temb)
        h = self.mid_modules[2](self.mid_modules[1](h), temb)
        for i, lev in enumerate(reversed(range(self.nlev))):
            mods = self.up_modules[i]
            for b in range(self.nres + 1):
                h = mods[f"{lev}a_{b}a_block"](torch.cat([h, hs.pop()], 1),
                                               temb)
                if f"{lev}a_{b}b_attn" in mods:
                    h = mods[f"{lev}a_{b}b_attn"](h)
            if f"{lev}b_upsample" in mods:
                h = mods[f"{lev}b_upsample"](h)
        return self.end_conv(h).permute(0, 2, 3, 1)


@torch.no_grad()
def init_vs(model: nn.Module, seed: int) -> nn.Module:
    """The flow-matching trainer's seeded init, as annegnx/PnP-Flow's JAX
    counterpart ``vs_init`` states it: variance-scaling fan_avg uniform,
    limit sqrt(3 * scale / fan_avg), scale 1e-10 for the residual ``conv2``,
    the attention ``proj_out`` and the last conv; zero biases; GroupNorm
    (1, 0).  Drawn module by module in registration order from one CPU
    generator."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, mod in model.named_modules():
        if isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            rf = w[0, 0].numel() if w.dim() == 4 else 1
            fan_avg = (w.shape[0] + w.shape[1]) * rf / 2.0
            near_zero = (name.rsplit(".", 1)[-1] in ("conv2", "proj_out")
                         or name == "end_conv.2")
            lim = math.sqrt(3.0 * (1e-10 if near_zero else 1.0) / fan_avg)
            w.copy_(torch.empty(w.shape).uniform_(-lim, lim, generator=gen))
            mod.bias.zero_()
    return model


# the model the harness finds by the configuration's ``arch``
Model = UNet
