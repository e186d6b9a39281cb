"""Fused conv3x3 + GroupNorm-epilogue kernel (CUDA C++, sm_90a).

Replaces the TPU kernel ``pnpflow_tpu/ops/fused_conv_gn.py:_kernel``
(launched by ``_conv3x3_gn_impl``, entry ``conv3x3_gn``):

  swish(x*a + b')  ->  3x3 same conv  ->  + bias (+ temb) (+ residual)
  -> cast  ->  per-channel (sum, sumsq) over H*W of the written output.

The prologue is the GroupNorm normalize + swish that precedes every conv of
a ResidualBlock, folded to a per-(sample, channel) affine by
:func:`gn_prologue` from the moments the *previous* kernel emitted; so no
GroupNorm statistics pass re-reads an activation.  Per-channel moments stay
valid through the decoder's channel concats (:func:`concat_moments`).

What bounds it on an H100: at the U-Net's float32 shapes, operations
(2*N*H*W*9*C*CO over the 67 TFLOP/s float32 rate); in bf16 at the wide
64x64 layers, bytes (input, weights, residual and output over 3.35 TB/s).
What the design does about it: the source (``csrc/conv3x3_gn.cu``) is a
register-tiled implicit GEMM on the CUDA cores that keeps the prologue, the
epilogue and the moment sums out of device memory; tensor cores (wgmma)
and TMA are later work.

Beside the kernel: :func:`conv3x3_gn_reference`, the plain PyTorch version
(used for CPU tensors and as the kernel's yardstick), and the three helpers
as torch ops.  Unlike the TPU entry there is no size gate: every shape the
U-Net passes, including the 3-channel begin conv, takes the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pnpflow_tpu_torch.ops import _build

__all__ = [
    "conv3x3_gn",
    "conv3x3_gn_reference",
    "channel_moments",
    "concat_moments",
    "gn_prologue",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HAS_PROLOGUE, _HAS_SAMPLE_BIAS, _HAS_RESIDUAL, _EMIT_MOMENTS = 1, 2, 4, 8


def channel_moments(x):
    """Per-channel (sum, sumsq) over H*W in f32: (N, H, W, C) -> (N, 2, C)."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1)


def concat_moments(*moms):
    """Moments of a channel-concat = concat of channel moments."""
    return torch.cat(moms, dim=-1)


def gn_prologue(moments, count: int, scale, bias, num_groups: int = 32,
                eps: float = 1e-6):
    """GroupNorm normalize folded to per-(sample, channel) affine (a, b').

    moments: (N, 2, C) channel (sum, sumsq) over ``count`` = H*W elements.
    Returns a, b' (N, C) f32 with GN(x)*scale + bias == x*a + b'.
    """
    n, _, c = moments.shape
    gs = c // num_groups
    s = moments[:, 0, :].reshape(n, num_groups, gs).sum(-1)
    sq = moments[:, 1, :].reshape(n, num_groups, gs).sum(-1)
    cnt = float(count * gs)
    mean = s / cnt
    var = sq / cnt - mean * mean
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    mean_c = mean.repeat_interleave(gs, dim=-1)
    rstd_c = rstd.repeat_interleave(gs, dim=-1)
    a = rstd_c * scale.float()[None, :]
    b = bias.float()[None, :] - mean_c * a
    return a, b


def conv3x3_gn_reference(x, w, b, *, prologue=None, sample_bias=None,
                         residual=None, emit_moments: bool = True):
    """Plain PyTorch version of :func:`conv3x3_gn` (same arguments).

    The conv runs in float32 on the x-dtype values, as the JAX reference's
    ``preferred_element_type=float32`` conv does.
    """
    if prologue is not None:
        a, pb = prologue
        xf = x.float() * a[:, None, None, :] + pb[:, None, None, :]
        x = (xf * torch.sigmoid(xf)).to(x.dtype)
    wk = w.to(x.dtype).float().permute(3, 2, 0, 1)          # HWIO -> OIHW
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wk, padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    if sample_bias is not None:
        y = y + sample_bias.float()[:, None, None, :]
    if residual is not None:
        y = y + residual.float()
    yo = y.to(x.dtype).contiguous()
    return yo, (channel_moments(yo) if emit_moments else None)


def _require(t, name, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device} (got {t.dtype} on {t.device})")


def conv3x3_gn(x, w, b, *, prologue=None, sample_bias=None, residual=None,
               emit_moments: bool = True):
    """swish(x*a + b') -> 3x3 same conv -> +bias(+temb)(+residual), with
    per-channel (sum, sumsq) moments of the written output.

    x: (N, H, W, C) float32 or bf16; w: HWIO (3, 3, C, CO) in x's dtype;
    b: (CO,) f32; prologue: None or (a, b') each (N, C) f32;
    sample_bias: (N, CO) f32 or None; residual: (N, H, W, CO) in x's dtype
    or None.  Returns ``(y, moments)``: y (N, H, W, CO) in x's dtype,
    moments (N, 2, CO) f32, or None when ``emit_moments=False``.

    CPU tensors take :func:`conv3x3_gn_reference`; CUDA tensors launch the
    kernel (counted in ``conv3x3_gn.launches``) or raise.
    """
    kw = dict(prologue=prologue, sample_bias=sample_bias, residual=residual,
              emit_moments=emit_moments)
    if x.device.type == "cpu":
        return conv3x3_gn_reference(x, w, b, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("x must be NHWC and w HWIO")
    n, h, wd, c = x.shape
    co = w.shape[-1]
    dev, f32 = x.device, torch.float32
    _require(x, "x", (n, h, wd, c), x.dtype, dev)
    _require(w, "w", (3, 3, c, co), x.dtype, dev)
    _require(b, "b", (co,), f32, dev)
    flags = _EMIT_MOMENTS if emit_moments else 0
    pa = pb = sb = res = None
    if prologue is not None:
        pa, pb = prologue
        _require(pa, "prologue[0]", (n, c), f32, dev)
        _require(pb, "prologue[1]", (n, c), f32, dev)
        flags |= _HAS_PROLOGUE
    if sample_bias is not None:
        sb = sample_bias
        _require(sb, "sample_bias", (n, co), f32, dev)
        flags |= _HAS_SAMPLE_BIAS
    if residual is not None:
        res = residual
        _require(res, "residual", (n, h, wd, co), x.dtype, dev)
        flags |= _HAS_RESIDUAL

    launch = _build.load("conv3x3_gn")
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=dev)
    mom = (torch.empty((n, 2, co), dtype=f32, device=dev)
           if emit_moments else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(_DTYPE_CODE[x.dtype], ptr(x), ptr(w), ptr(b), ptr(pa),
                     ptr(pb), ptr(sb), ptr(res), ptr(y), ptr(mom),
                     n, h, wd, c, co, flags, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_gn launch failed (error {err})")
    conv3x3_gn.launches += 1
    return y, mom


conv3x3_gn.launches = 0
