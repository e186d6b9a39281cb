"""Plain float32 NCSN++, the yardstick of the RectifiedFlow cells.

The architecture of gnobitab/RectifiedFlow's ``ncsnpp.py`` as its
``celeba_hq_pytorch_rf_gaussian`` config sets it (BigGAN blocks with FIR
resampling, attention at the listed resolutions, the input_skip /
output_skip pyramids with a 'sum' combine, skip_rescale, a Gaussian
Fourier embedding of log t and the scale_by_sigma division), with the
rectified-flow time input max(t, floor) * 999.  NCHW, ``F.conv2d``,
``F.group_norm`` and a zero-inserting depthwise ``F.conv2d`` for the FIR:
no code, layout or kernel of the program.  Modules are registered in the
reference's order under its names (``all_modules.{i}...``), so one state
dict loads into both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def fir_taps(k, gain: float = 1.0):
    k = np.asarray(k, dtype=np.float64)
    k = np.outer(k, k)
    return (k / k.sum() * gain).astype(np.float32)


def upfirdn(x, taps: np.ndarray, up: int, down: int, pad: tuple):
    """NCHW upfirdn2d: zero-insert by ``up``, pad, true convolution with the
    taps, keep every ``down``-th sample; float32."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.from_numpy(taps[::-1, ::-1].copy()).to(x.device)
    y = F.conv2d(x, k[None, None].expand(c, 1, *k.shape).contiguous(),
                 groups=c)
    return y[:, :, ::down, ::down]


def fir_up(x, k):
    taps = fir_taps(k, 4.0)
    p = taps.shape[0] - 2
    return upfirdn(x, taps, 2, 1, ((p + 1) // 2 + 1, p // 2))


def fir_down(x, k):
    taps = fir_taps(k)
    p = taps.shape[0] - 2
    return upfirdn(x, taps, 1, 2, ((p + 1) // 2, p // 2))


def gn(ch: int, eps: float):
    return nn.GroupNorm(min(ch // 4, 32), ch, eps=eps)


class NIN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return torch.einsum("nchw,co->nohw", x, self.W) \
            + self.b[None, :, None, None]


class Fourier(nn.Module):
    def __init__(self, size: int, scale: float):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(size), requires_grad=False)
        self.scale = scale

    def forward(self, x):
        proj = x[:, None] * self.W[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class Attn(nn.Module):
    def __init__(self, ch: int, eps: float):
        super().__init__()
        self.GroupNorm_0 = gn(ch, eps)
        self.NIN_0, self.NIN_1 = NIN(ch, ch), NIN(ch, ch)
        self.NIN_2, self.NIN_3 = NIN(ch, ch), NIN(ch, ch)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.GroupNorm_0(x)
        q = self.NIN_0(h).reshape(b, c, hh * ww).transpose(1, 2)
        k = self.NIN_1(h).reshape(b, c, hh * ww)
        v = self.NIN_2(h).reshape(b, c, hh * ww).transpose(1, 2)
        w = torch.softmax(torch.bmm(q, k) * c ** -0.5, dim=-1)
        h = torch.bmm(w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return (x + self.NIN_3(h)) / SQRT2


class BigGAN(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, eps: float, k,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down, self.k = up, down, k
        self.GroupNorm_0 = gn(cin, eps)
        self.Conv_0 = nn.Conv2d(cin, cout, 3, padding=1)
        self.Dense_0 = nn.Linear(temb, cout)
        self.GroupNorm_1 = gn(cout, eps)
        self.Conv_1 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout or up or down:
            self.Conv_2 = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb):
        h = F.silu(self.GroupNorm_0(x))
        if self.up:
            h, x = fir_up(h, self.k), fir_up(x, self.k)
        elif self.down:
            h, x = fir_down(h, self.k), fir_down(x, self.k)
        h = self.Conv_0(h) + self.Dense_0(F.silu(temb))[:, :, None, None]
        h = self.Conv_1(F.silu(self.GroupNorm_1(h)))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return (x + h) / SQRT2


class Combine(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 1)

    def forward(self, x, y):
        return self.Conv_0(x) + y


class NCSNpp(nn.Module):
    """``forward(x_nhwc, t) -> v_nhwc`` in float32, t in [0, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        nf, mult = cfg["nf"], cfg["ch_mult"]
        nres, k, eps = cfg["num_res_blocks"], cfg["fir_kernel"], cfg["eps"]
        cimg, size = cfg["num_channels"], cfg["image_size"]
        self.cfg = cfg
        self.register_buffer("sigmas", torch.tensor(np.exp(np.linspace(
            np.log(50.0), np.log(0.01), 1000)), dtype=torch.float32))
        all_res = [size // 2 ** i for i in range(len(mult))]
        attn = set(cfg["attn_resolutions"])
        temb = 4 * nf
        mods = [Fourier(nf, cfg["fourier_scale"]), nn.Linear(2 * nf, temb),
                nn.Linear(temb, temb), nn.Conv2d(cimg, nf, 3, padding=1)]
        hs, cur = [nf], nf
        for lev, m in enumerate(mult):
            for _ in range(nres):
                mods.append(BigGAN(cur, nf * m, temb, eps, k))
                cur = nf * m
                if all_res[lev] in attn:
                    mods.append(Attn(cur, eps))
                hs.append(cur)
            if lev != len(mult) - 1:
                mods.append(BigGAN(cur, cur, temb, eps, k, down=True))
                mods.append(Combine(cimg, cur))
                hs.append(cur)
        mods += [BigGAN(cur, cur, temb, eps, k), Attn(cur, eps),
                 BigGAN(cur, cur, temb, eps, k)]
        for lev in reversed(range(len(mult))):
            for _ in range(nres + 1):
                mods.append(BigGAN(cur + hs.pop(), nf * mult[lev], temb, eps,
                                   k))
                cur = nf * mult[lev]
            if all_res[lev] in attn:
                mods.append(Attn(cur, eps))
            mods.append(gn(cur, eps))
            mods.append(nn.Conv2d(cur, cimg, 3, padding=1))
            if lev != 0:
                mods.append(BigGAN(cur, cur, temb, eps, k, up=True))
        self.all_modules = nn.ModuleList(mods)
        self.all_res, self.attn = all_res, attn

    def forward(self, x, t):
        cfg, k = self.cfg, self.cfg["fir_kernel"]
        nlev, nres = len(cfg["ch_mult"]), cfg["num_res_blocks"]
        sigma = torch.clamp_min(t.float(), cfg["t_floor"]) * cfg["t_scale"]
        mods = iter(self.all_modules)
        temb = next(mods)(torch.log(sigma))
        temb = next(mods)(temb)
        temb = next(mods)(F.silu(temb))
        x = x.float().permute(0, 3, 1, 2)
        pyr = x
        hs = [next(mods)(x)]
        for lev in range(nlev):
            for _ in range(nres):
                h = next(mods)(hs[-1], temb)
                if self.all_res[lev] in self.attn:
                    h = next(mods)(h)
                hs.append(h)
            if lev != nlev - 1:
                h = next(mods)(hs[-1], temb)
                pyr = fir_down(pyr, k)
                hs.append(next(mods)(pyr, h))
        h = next(mods)(hs[-1], temb)
        h = next(mods)(h)
        h = next(mods)(h, temb)
        out = None
        for lev in reversed(range(nlev)):
            for _ in range(nres + 1):
                h = next(mods)(torch.cat([h, hs.pop()], dim=1), temb)
            if self.all_res[lev] in self.attn:
                h = next(mods)(h)
            if lev != nlev - 1:
                out = fir_up(out, k)
            norm, conv = next(mods), next(mods)
            p = conv(F.silu(norm(h)))
            out = p if out is None else out + p
            if lev != 0:
                h = next(mods)(h, temb)
        return (out / sigma[:, None, None, None]).permute(0, 2, 3, 1)


# the model the harness finds by the configuration's ``arch``
Model = NCSNpp
