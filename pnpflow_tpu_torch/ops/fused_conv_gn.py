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

What bounds it on an H100: in bf16, bytes (input, weights, residual and
output over 3.35 TB/s); in float32, operations, since fp32 accuracy on the
tensor cores takes three TF32 products per product (3xTF32, 495 TFLOP/s),
still faster than the CUDA cores' 67 TFLOP/s.  What the design does about
it (``csrc/conv3x3_gn.cu``): an implicit GEMM on the tensor cores (bf16
``mma.sync`` m16n8k16; fp32 as 3xTF32 m16n8k8) whose blocks own a tile of
whole image rows x output channels, sized per call by :func:`launch_plan`
so that small batches still fill the 132 SMs; the input is staged once per
channel chunk with a 1-pixel halo and the prologue applied, and the 9 taps
read shifted windows of it; weights stream through a ``cp.async`` ring; the
prologue, epilogue and moment sums stay out of device memory but for one
small (N, T, 2, CO) partial-moment workspace, reduced in a fixed order.

Beside the kernel: :func:`conv3x3_gn_reference`, the plain PyTorch version
(used for CPU tensors and as the kernel's yardstick), and the three helpers
as torch ops.  Unlike the TPU entry there is no size gate: every shape the
U-Net passes, including the 3-channel begin conv, takes the kernel (output
channels a multiple of 32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pnpflow_tpu_torch.ops import _build

__all__ = [
    "conv3x3_gn",
    "conv3x3_gn_reference",
    "channel_moments",
    "concat_moments",
    "gn_prologue",
    "launch_plan",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HAS_PROLOGUE, _HAS_SAMPLE_BIAS, _HAS_RESIDUAL, _EMIT_MOMENTS = 1, 2, 4, 8
SMS = 132                 # streaming multiprocessors of an H100 SXM
# the kernel's (pixels, output channels) block tiles, most work per block
# first; each warp computes 32 x 32 of it
TILES = ((128, 64), (64, 128), (128, 32), (64, 64), (64, 32))


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


class LaunchPlan(NamedTuple):
    """A block owns ``bm`` pixels, ``bm // tw`` rows of ``tw`` columns of one
    sample, by ``bn`` output channels; a sample has ``tiles_y * tiles_x``
    pixel tiles.  Tiles at the right and bottom edges may reach past the
    image; the kernel masks those pixels."""
    bm: int
    bn: int
    tw: int
    tiles_y: int
    tiles_x: int

    def blocks(self, n, co):
        return n * self.tiles_y * self.tiles_x * (co // self.bn)

    def tile(self, bid, co):
        """The kernel's decode of block ``bid`` (an int or an integer array):
        ``(sample, first row, first column, first output channel)``."""
        co_tiles = co // self.bn
        ptile, co0 = bid // co_tiles, (bid % co_tiles) * self.bn
        per = self.tiles_y * self.tiles_x
        n, t = ptile // per, ptile % per
        r = self.bm // self.tw
        return n, (t // self.tiles_x) * r, (t % self.tiles_x) * self.tw, co0


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, h: int, w: int, co: int) -> LaunchPlan:
    """The block tile for an (n, h, w, *) -> co conv: the tile with the
    most work per block that still gives at least :data:`SMS` blocks, else
    the one that gives the most blocks.  A tile's width is the largest power
    of two <= w (at most its pixel count), and a 128-pixel tile never spans
    more rows than the image has."""
    if co % 32:
        raise ValueError(f"conv3x3_gn kernel takes output channels in "
                         f"multiples of 32, got {co}")
    best = None
    for bm, bn in TILES:
        if co % bn:
            continue
        tw = min(bm, 1 << (w.bit_length() - 1))
        r = bm // tw
        if bm > 64 and r > h:
            continue
        plan = LaunchPlan(bm, bn, tw, -(-h // r), -(-w // tw))
        if plan.blocks(n, co) >= SMS:
            return plan
        if best is None or plan.blocks(n, co) > best.blocks(n, co):
            best = plan
    return best


def _require(t, name, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device} (got {t.dtype} on {t.device})")


def _check_args(x, w, b, prologue, sample_bias, residual):
    """Check the arguments as the kernel takes them; returns the launch
    flags without the moment bit."""
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
    flags = 0
    if prologue is not None:
        _require(prologue[0], "prologue[0]", (n, c), f32, dev)
        _require(prologue[1], "prologue[1]", (n, c), f32, dev)
        flags |= _HAS_PROLOGUE
    if sample_bias is not None:
        _require(sample_bias, "sample_bias", (n, co), f32, dev)
        flags |= _HAS_SAMPLE_BIAS
    if residual is not None:
        _require(residual, "residual", (n, h, wd, co), x.dtype, dev)
        flags |= _HAS_RESIDUAL
    return flags


def conv3x3_gn(x, w, b, *, prologue=None, sample_bias=None, residual=None,
               emit_moments: bool = True):
    """swish(x*a + b') -> 3x3 same conv -> +bias(+temb)(+residual), with
    per-channel (sum, sumsq) moments of the written output.

    x: (N, H, W, C) float32 or bf16; w: HWIO (3, 3, C, CO) in x's dtype,
    CO a multiple of 32; b: (CO,) f32; prologue: None or (a, b') each (N, C)
    f32; sample_bias: (N, CO) f32 or None; residual: (N, H, W, CO) in x's
    dtype or None; all contiguous.  Returns ``(y, moments)``: y (N, H, W,
    CO) in x's dtype, moments (N, 2, CO) f32, or None when
    ``emit_moments=False``.

    The arguments are checked as the kernel takes them on every device, so
    a CPU run finds what the card would refuse; then CPU tensors take
    :func:`conv3x3_gn_reference` and CUDA tensors launch the kernel
    (counted in ``conv3x3_gn.launches``) or raise.
    """
    flags = _check_args(x, w, b, prologue, sample_bias, residual)
    n, h, wd, c = x.shape
    co = w.shape[-1]
    plan = launch_plan(n, h, wd, co)
    if x.device.type == "cpu":
        return conv3x3_gn_reference(
            x, w, b, prologue=prologue, sample_bias=sample_bias,
            residual=residual, emit_moments=emit_moments)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if emit_moments:
        flags |= _EMIT_MOMENTS
    pa, pb = prologue if prologue is not None else (None, None)

    launch = _build.load("conv3x3_gn")
    dev = x.device
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=dev)
    mom = ws = None
    if emit_moments:
        mom = torch.empty((n, 2, co), dtype=torch.float32, device=dev)
        ws = torch.empty((n, plan.tiles_y * plan.tiles_x, 2, co),
                         dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(_DTYPE_CODE[x.dtype], ptr(x), ptr(w), ptr(b), ptr(pa),
                     ptr(pb), ptr(sample_bias), ptr(residual), ptr(y),
                     ptr(mom), ptr(ws), n, h, wd, c, co, flags, plan.bm,
                     plan.bn, plan.tw, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_gn launch failed (error {err})")
    _build.count_launch(conv3x3_gn)
    return y, mom


conv3x3_gn.launches = 0
