"""Velocity U-Net in PyTorch, NHWC activations.

Port of ``pnpflow_tpu/models/unet.py``: Swish activations, GroupNorm(32, eps
1e-6), sinusoidal t-embedding -> 2-layer MLP, residual blocks with a
t-embedding projection, single-head self-attention at the configured
resolutions, a skip-concat up path, and variance-scaling fan_avg uniform
init with near-zero final convs.

Parameters keep the reference torch module layout (``down_modules.{L}.
{L}a_{B}a_block.conv1.weight``, ``mid_modules.{0,1,2}``, ``end_conv.{0,2}``,
...), so a published ``.pt`` state_dict loads as it is and
``pnpflow_tpu.utils.torch_convert.convert_unet_state_dict`` maps the port's
``state_dict`` onto the JAX parameter tree.

Activations stay NHWC-contiguous between layers, so both kernels read
channels contiguously; plain convolutions take ``x.permute(0, 3, 1, 2)``, a
channels_last view.  ``fused_norm`` selects the GroupNorm path:

* ``False``: plain PyTorch GroupNorm + swish, plain convolutions;
* ``True``: every GroupNorm through the ``groupnorm_swish`` kernel;
* ``"bm"``: every GroupNorm through ``groupnorm_swish_bm``, the same
  kernel as ``True`` under the JAX package's batch-minor entry;
* ``"conv"``: every ResidualBlock conv (and the begin conv) through the
  fused ``conv3x3_gn`` kernel, whose prologue applies the preceding
  GroupNorm + swish from the moments the previous kernel emitted.
  Attention norms stay plain, as in the JAX package.  The kernel has no
  backward and no forward-mode rule, so this mode is forward-only: it
  raises where a gradient or a tangent would be taken (differentiate with
  ``False``, ``True`` or ``"bm"``);
* ``"dot"``, ``"tview"``, ``"bf16stats"``: the JAX package's XLA-only
  GroupNorm variants, in plain PyTorch (no kernel: JAX's are plain XLA
  too), differentiable like ``False``: moments as sums in float32 over
  the (h w) axis then the group (``"dot"``, JAX's contraction against a
  ones vector) or over a (b, g, hw cg) view (``"tview"``), one pass
  E[x^2] - E[x]^2, the normalize in float32; ``"bf16stats"`` keeps
  everything in the compute dtype, two-pass mean and centred variance.
  Where JAX accumulates a bfloat16 ``"bf16stats"`` reduction in bfloat16,
  torch's sum accumulates wider and rounds once, so bf16 results differ by
  a few bfloat16 ulps.

``dtype`` is the compute dtype (float32 or bfloat16); parameters stay
float32 and are cast per call (the conv kernel's reordered weights are
cached per dtype).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pnpflow_tpu_torch.ops.fused_conv_gn import (
    channel_moments, concat_moments, conv3x3_gn, gn_prologue)
from pnpflow_tpu_torch.ops.gn_swish import (
    gn_swish_reference, groupnorm_swish, needs_autograd)
from pnpflow_tpu_torch.ops.gn_swish_bm import groupnorm_swish_bm

FUSED_NORMS = (False, True, "bm", "conv", "dot", "tview", "bf16stats")


def check_fused_norm(fused_norm):
    if fused_norm not in FUSED_NORMS:
        raise ValueError(f"unknown fused_norm {fused_norm!r}: one of "
                         f"{FUSED_NORMS}")
    return fused_norm


def _finish(y, weight, bias, swish: bool):
    y = y * weight + bias
    return y * torch.sigmoid(y) if swish else y


def gn_f32_stats(x, weight, bias, swish: bool, groups: int = 32,
                 eps: float = 1e-6):
    """JAX's ``DotStatsGroupNorm`` and ``TViewStatsGroupNorm``: each
    group's sums of x and of x*x (the square in x's dtype) in float32, the
    one-pass variance, the normalize in float32, cast back to x's dtype.
    JAX's two lay their reductions out differently for the TPU (per-channel
    sums then per-group, or a transposed view); the arithmetic is the same,
    so the port has one function for both."""
    b, h, w, c = x.shape
    cg = c // groups
    xt = x.reshape(b, h * w, groups, cg).transpose(1, 2).reshape(
        b, groups, h * w * cg)
    inv_n = 1.0 / (h * w * cg)
    mean = xt.float().sum(2) * inv_n
    var = (xt * xt).float().sum(2) * inv_n - mean * mean
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None, None, :]
    inv_c = inv.repeat_interleave(cg, dim=1)[:, None, None, :]
    return _finish((x.float() - mean_c) * inv_c, weight, bias,
                   swish).to(x.dtype)


def gn_lowprec_stats(x, weight, bias, swish: bool, groups: int = 32,
                     eps: float = 1e-6):
    """JAX's ``LowPrecStatsGroupNorm``: the statistics in x's dtype, two
    passes (mean, then the centred variance), the rsqrt in float32 and cast
    back; scale, bias and swish in x's dtype."""
    b, h, w, c = x.shape
    dt = x.dtype
    xg = x.reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True, dtype=dt)
    d = xg - mean
    var = (d * d).mean(dim=(1, 3), keepdim=True, dtype=dt)
    inv = torch.rsqrt(var.float() + eps).to(dt)
    y = (d * inv).reshape(b, h, w, c)
    return _finish(y, weight.to(dt), bias.to(dt), swish)


_PLAIN_NORMS = {"dot": gn_f32_stats, "tview": gn_f32_stats,
                "bf16stats": gn_lowprec_stats}


def sinusoidal_embedding(t, dim: int):
    """freqs exp(-log(10000) * i / (dim/2 - 1)), concat(sin, cos)."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(10000.0) / (half - 1))
    )
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _linear(x, lin: nn.Linear, dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _conv(x, conv: nn.Conv2d, dtype):
    """A plain NHWC convolution through a channels_last view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dtype),
                 conv.bias.to(dtype), conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1).contiguous()


def _conv1x1(x, conv: nn.Conv2d, dtype):
    w = conv.weight[:, :, 0, 0].to(dtype)
    return torch.matmul(x, w.t()) + conv.bias.to(dtype)


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)`` that also serves the fused
    kernel its weights as HWIO ``(3, 3, C, CO)``, reordered once per dtype
    and device and cached until the weight changes: ``load_state_dict``
    or an in-place update (an optimizer step), which bumps the tensor's
    version counter.  A weight made under ``torch.inference_mode`` has no
    version counter; it can change in place only inside that mode, where
    no optimizer runs."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)
        self._hwio = (None, None)

    def _load_from_state_dict(self, *args, **kwargs):
        self._hwio = (None, None)
        super()._load_from_state_dict(*args, **kwargs)

    def kernel_weight(self, dtype):
        w = self.weight
        key = (dtype, w.device, w.data_ptr(),
               None if w.is_inference() else w._version)
        if self._hwio[0] != key:
            self._hwio = (key, w.detach().permute(2, 3, 1, 0)
                          .to(dtype).contiguous())
        return self._hwio[1]


def check_forward_only(module: nn.Module, *inputs):
    """Raise where ``fused_norm "conv"`` would be differentiated: under a
    recorded gradient, a ``torch.func`` transform or a forward-AD level.
    Its kernel has no backward and no forward-mode rule, and detached
    weights would drop the gradients of every conv without a word."""
    if needs_autograd(*inputs, *module.parameters()):
        raise RuntimeError(
            'fused_norm "conv" is forward-only and cannot be differentiated '
            "(no gradient, no JVP): use fused_norm False, True or \"bm\", "
            "or run under torch.no_grad() / torch.inference_mode() with no "
            "torch.func transform")


def _gn(x, norm: nn.GroupNorm, fused, swish: bool):
    if fused is True:
        return groupnorm_swish(x, norm.weight, norm.bias, 32, 1e-6, swish)
    if fused == "bm":
        return groupnorm_swish_bm(x, norm.weight, norm.bias, 32, 1e-6, swish)
    if fused in _PLAIN_NORMS:
        return _PLAIN_NORMS[fused](x, norm.weight, norm.bias, swish)
    return gn_swish_reference(x, norm.weight, norm.bias, 32, 1e-6, swish)


def _group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-6)


class TimestepEmbedding(nn.Module):
    """sinusoidal(ch) -> Linear(4ch) -> swish -> Linear(4ch)."""

    def __init__(self, embedding_dim: int, hidden_dim: int, output_dim: int):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.main = nn.Sequential(
            nn.Linear(embedding_dim, hidden_dim), nn.SiLU(),
            nn.Linear(hidden_dim, output_dim),
        )

    def forward(self, t, dtype=torch.float32):
        temb = sinusoidal_embedding(t, self.embedding_dim)
        temb = F.silu(_linear(temb, self.main[0], dtype))
        return _linear(temb, self.main[2], dtype)


class ResidualBlock(nn.Module):
    """norm-swish-conv + temb add + norm-swish-conv + shortcut."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int,
                 fused_norm=False):
        super().__init__()
        self.fused_norm = check_fused_norm(fused_norm)
        self.norm1 = _group_norm(in_ch)
        self.conv1 = Conv3x3(in_ch, out_ch)
        self.temb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = _group_norm(out_ch)
        self.conv2 = Conv3x3(out_ch, out_ch)
        if in_ch != out_ch:
            self.shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb, x_moments=None):
        dt = x.dtype
        if self.fused_norm == "conv":
            return self._fused(x, temb, x_moments)
        h = _gn(x, self.norm1, self.fused_norm, True)
        h = _conv(h, self.conv1, dt)
        h = h + _linear(F.silu(temb), self.temb_proj, dt)[:, None, None, :]
        h = _gn(h, self.norm2, self.fused_norm, True)
        h = _conv(h, self.conv2, dt)
        if hasattr(self, "shortcut"):
            x = _conv1x1(x, self.shortcut, dt)
        return x + h

    def _fused(self, x, temb, x_moments):
        """The whole block as two fused conv kernels; each GroupNorm rides
        its conv's prologue from the previous kernel's moments.  Returns
        ``(out, moments)``.  Forward-only: ``VelocityUNet.forward`` refuses
        a recorded gradient before the first block."""
        dt = x.dtype
        hw = x.shape[1] * x.shape[2]
        if x_moments is None:
            x_moments = channel_moments(x)
        tv = _linear(F.silu(temb), self.temb_proj, dt)
        pro1 = gn_prologue(x_moments, hw, self.norm1.weight, self.norm1.bias)
        h, mh = conv3x3_gn(x, self.conv1.kernel_weight(dt), self.conv1.bias,
                           prologue=pro1, sample_bias=tv.float())
        pro2 = gn_prologue(mh, hw, self.norm2.weight, self.norm2.bias)
        xres = (_conv1x1(x, self.shortcut, dt) if hasattr(self, "shortcut")
                else x)
        return conv3x3_gn(h, self.conv2.kernel_weight(dt), self.conv2.bias,
                          prologue=pro2, residual=xres)


class SelfAttention(nn.Module):
    """Single-head self-attention over the (H*W, C) tokens: q/k/v 1x1
    convs, softmax(q k^T / sqrt(C)) with fp32 logits, zero-init output
    projection, residual add."""

    def __init__(self, ch: int, fused_norm=False):
        super().__init__()
        self.fused_norm = fused_norm
        self.norm = _group_norm(ch)
        self.attn_q = nn.Conv2d(ch, ch, 1)
        self.attn_k = nn.Conv2d(ch, ch, 1)
        self.attn_v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, hh, ww, c = x.shape
        dt = x.dtype
        h = _gn(x, self.norm, self.fused_norm, False)
        q = _conv1x1(h, self.attn_q, dt).reshape(b, hh * ww, c)
        k = _conv1x1(h, self.attn_k, dt).reshape(b, hh * ww, c)
        v = _conv1x1(h, self.attn_v, dt).reshape(b, hh * ww, c)
        attn = torch.bmm(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        h = torch.bmm(attn.float(), v.float()).to(dt).reshape(b, hh, ww, c)
        return x + _conv1x1(h, self.proj_out, dt)


class Upsample(nn.Module):
    """nearest 2x upsample + 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.up_conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _conv(x, self.up_conv, x.dtype)


class VelocityUNet(nn.Module):
    """Flow-matching velocity field v(x, t) on NHWC images."""

    def __init__(self, input_channels: int = 3, input_height: int = 128,
                 ch: int = 32, output_channels: int | None = None,
                 ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 6,
                 attn_resolutions: Sequence[int] = (16, 8),
                 dtype=torch.float32, fused_norm=False):
        super().__init__()
        self.input_channels = input_channels
        self.input_height = input_height
        self.ch = ch
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.dtype = dtype
        self.fused_norm = fused = check_fused_norm(fused_norm)
        attn_fused = False if fused == "conv" else fused
        out_ch = output_channels or input_channels
        temb_ch = ch * 4
        nlev = len(ch_mult)

        self.temb_net = TimestepEmbedding(ch, temb_ch, temb_ch)
        self.begin_conv = Conv3x3(input_channels, ch)

        hs_ch, cur, res = [ch], ch, input_height
        self.down_modules = nn.ModuleList()
        for lev in range(nlev):
            mods = nn.ModuleDict()
            block_out = ch * ch_mult[lev]
            for b in range(num_res_blocks):
                mods[f"{lev}a_{b}a_block"] = ResidualBlock(
                    cur, block_out, temb_ch, fused)
                cur = block_out
                if res in self.attn_resolutions:
                    mods[f"{lev}a_{b}b_attn"] = SelfAttention(cur, attn_fused)
                hs_ch.append(cur)
            if lev != nlev - 1:
                mods[f"{lev}b_downsample"] = nn.Conv2d(
                    cur, cur, 3, stride=2, padding=1)
                hs_ch.append(cur)
                res //= 2
            self.down_modules.append(mods)

        self.mid_modules = nn.ModuleList([
            ResidualBlock(cur, cur, temb_ch, fused),
            SelfAttention(cur, attn_fused),
            ResidualBlock(cur, cur, temb_ch, fused),
        ])

        self.up_modules = nn.ModuleList()
        for lev in reversed(range(nlev)):
            mods = nn.ModuleDict()
            block_out = ch * ch_mult[lev]
            for b in range(num_res_blocks + 1):
                mods[f"{lev}a_{b}a_block"] = ResidualBlock(
                    cur + hs_ch.pop(), block_out, temb_ch, fused)
                cur = block_out
                if res in self.attn_resolutions:
                    mods[f"{lev}a_{b}b_attn"] = SelfAttention(cur, attn_fused)
            if lev != 0:
                mods[f"{lev}b_upsample"] = Upsample(cur)
                res *= 2
            self.up_modules.append(mods)
        assert not hs_ch

        self.end_conv = nn.Sequential(
            _group_norm(cur), nn.SiLU(), nn.Conv2d(cur, out_ch, 3, padding=1))

    def forward(self, x, t):
        if x.dim() != 4 or x.shape[-1] != self.input_channels:
            raise ValueError(f"expected NHWC input, got {tuple(x.shape)}")
        if x.shape[1] != self.input_height:
            # attention placement was fixed at construction from input_height
            raise ValueError(f"model built for {self.input_height}^2 inputs, "
                             f"got {tuple(x.shape)}")
        dt = self.dtype
        fc = self.fused_norm == "conv"
        nlev = len(self.ch_mult)
        x = x.to(dt).contiguous()
        temb = self.temb_net(t, dt)

        def block(mod, h, m):
            out = mod(h, temb, x_moments=m)
            return out if fc else (out, None)

        def attn(mod, h):
            h = mod(h)
            return h, (channel_moments(h) if fc else None)

        if fc:
            check_forward_only(self, x, t)
            h0, m0 = conv3x3_gn(x, self.begin_conv.kernel_weight(dt),
                                self.begin_conv.bias)
        else:
            h0, m0 = _conv(x, self.begin_conv, dt), None
        hs, ms = [h0], [m0]
        for lev in range(nlev):
            mods = self.down_modules[lev]
            for b in range(self.num_res_blocks):
                h, m = block(mods[f"{lev}a_{b}a_block"], hs[-1], ms[-1])
                if f"{lev}a_{b}b_attn" in mods:
                    h, m = attn(mods[f"{lev}a_{b}b_attn"], h)
                hs.append(h)
                ms.append(m)
            if lev != nlev - 1:
                d = _conv(hs[-1], mods[f"{lev}b_downsample"], dt)
                hs.append(d)
                ms.append(channel_moments(d) if fc else None)

        h, m = block(self.mid_modules[0], hs[-1], ms[-1])
        h, m = attn(self.mid_modules[1], h)
        h, m = block(self.mid_modules[2], h, m)

        for i, lev in enumerate(reversed(range(nlev))):
            mods = self.up_modules[i]
            for b in range(self.num_res_blocks + 1):
                skip, skip_m = hs.pop(), ms.pop()
                hin = torch.cat([h, skip], dim=-1)
                min_ = concat_moments(m, skip_m) if fc else None
                h, m = block(mods[f"{lev}a_{b}a_block"], hin, min_)
                if f"{lev}a_{b}b_attn" in mods:
                    h, m = attn(mods[f"{lev}a_{b}b_attn"], h)
            if lev != 0:
                h = mods[f"{lev}b_upsample"](h)
                m = channel_moments(h) if fc else None
        assert not hs

        norm, end = self.end_conv[0], self.end_conv[2]
        if fc:
            a, c = gn_prologue(m, h.shape[1] * h.shape[2], norm.weight,
                               norm.bias)
            hf = h.float() * a[:, None, None, :] + c[:, None, None, :]
            h = (hf * torch.sigmoid(hf)).to(dt)
        else:
            h = _gn(h, norm, self.fused_norm, True)
        return _conv(h, end, dt).float()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded variance-scaling fan_avg uniform init (the JAX ``vs_init``):
    limit sqrt(3 * scale / fan_avg), scale 1 everywhere except the
    residual ``conv2``, attention ``proj_out`` and ``end_conv`` convs, whose
    scale 0 becomes 1e-10 as in ``vs_init`` (near zero, not zero).  Biases
    start at 0, GroupNorm at (1, 0).  Draws from a CPU generator, so the
    weights do not depend on the device."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, mod in model.named_modules():
        if isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            rf = w[0, 0].numel() if w.dim() == 4 else 1
            fan_avg = (w.shape[0] + w.shape[1]) * rf / 2.0
            leaf = name.rsplit(".", 1)[-1]
            zero = leaf in ("conv2", "proj_out") or name == "end_conv.2"
            scale = 1e-10 if zero else 1.0
            lim = math.sqrt(3.0 * scale / fan_avg)
            w.copy_(torch.empty(w.shape).uniform_(-lim, lim, generator=gen))
            mod.bias.zero_()
    return model
