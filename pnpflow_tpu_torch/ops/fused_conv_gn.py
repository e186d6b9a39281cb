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

What bounds it on an H100: in bf16, bytes at the 64x64 and 32x32 sites
(input, residual and output over 3.35 TB/s) and operations at 16x16 and
8x8; in float32, operations, since fp32 accuracy on the tensor cores takes
three TF32 products per product (3xTF32, 495 TFLOP/s), still faster than the
CUDA cores' 67 TFLOP/s.  What the design does about it
(``csrc/conv3x3_gn.cu``): an implicit GEMM on ``wgmma`` with both operands
in shared memory (the halo tile, staged once per channel chunk with the
prologue applied, and the weights), weights by TMA through an mbarrier ring
kept full by one producer warp, the input and the residual by TMA where
their rows are whole 16-byte vectors, pixel tiles of 64-256 rows that span
several whole samples where a sample is small, sized per call by
:func:`launch_plan` so that small batches still fill the 132 SMs, and the
moments reduced in the same launch (the last block of each slice, elected
by an atomic ticket, sums the partials in a fixed order).  The weights
reach the kernel packed by :func:`pack_weight`, cached on the weight
tensor.

Beside the kernel: :func:`conv3x3_gn_reference`, the plain PyTorch version
(used for CPU tensors and as the kernel's yardstick), and the three helpers
as torch ops.  Unlike the TPU entry there is no size gate: every shape the
U-Net passes, including the 3-channel begin conv, takes the kernel (output
channels a multiple of 32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
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
    "pack_weight",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HAS_PROLOGUE, _HAS_SAMPLE_BIAS, _HAS_RESIDUAL, _EMIT_MOMENTS = 1, 2, 4, 8
SMS = 132                 # streaming multiprocessors of an H100 SXM
KBYTES = 64               # bytes of input channels per K step of the kernel
# the kernel's (pixels, output channels) block tiles, in the order the plan
# tries them (a 64-pixel tile by 64 or 128 channels would never be taken:
# the 128-pixel tile by half the channels, tried first, gives at least as
# many blocks); (consumer warpgroups, m64 row blocks a warpgroup) of each
# pixel count
TILES = ((128, 128), (256, 64), (128, 64), (256, 32), (128, 32), (64, 32))
WARPGROUPS = {64: (1, 1), 128: (2, 1), 256: (2, 2)}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def tile_key(dtype, bm, bn):
    """The name under which ``conv3x3_gn.tiles`` counts a launch: one per
    kernel function (dtype, pixels, channels)."""
    return f"{_DTYPE_NAME[dtype]}/{bm}x{bn}"


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


def _tf32(v):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = (v.view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def pack_weight(w):
    """HWIO ``(3, 3, C, CO)`` -> the kernel's weight rows: ``(CO, K)``,
    K = nch * 9 * kch in the order (channel chunk, tap, channel), where a
    chunk is :data:`KBYTES` of channels (kch = 32 bf16 or 16 fp32) and
    channels past C are zero.  float32 gives ``(2 * CO, K)``: the TF32
    halves big = tf32(w) and then small = tf32(w - big) of 3xTF32, since
    ``wgmma`` takes TF32 weights only K-major."""
    _, _, c, co = w.shape
    kch = KBYTES // w.element_size()
    nch = -(-c // kch)
    wt = w.permute(3, 0, 1, 2).reshape(co, 9, c)
    if nch * kch != c:
        wt = F.pad(wt, (0, nch * kch - c))
    wt = wt.reshape(co, 9, nch, kch).transpose(1, 2).reshape(co, -1)
    if w.dtype == torch.float32:
        big = _tf32(wt.contiguous())
        return torch.cat([big, _tf32(wt - big)]).contiguous()
    return wt.contiguous()


def _packed(w):
    """:func:`pack_weight` of ``w``, kept on the tensor until it changes (a
    new storage or an in-place update, which bumps its version counter; an
    inference tensor has none and changes only inside inference mode, where
    no optimizer runs)."""
    key = (w.data_ptr(), None if w.is_inference() else w._version)
    hit = getattr(w, "_conv3x3_gn_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_weight(w.detach()))
        w._conv3x3_gn_packed = hit
    return hit[1]


class LaunchPlan(NamedTuple):
    """A block owns ``bm`` pixels, ``samples`` whole-sample slabs of ``rows``
    rows x ``tw`` columns (both multiples of 8), by ``bn`` output channels.
    Its pixels are ordered slab, 8-column group, row, column, so that each
    64-pixel ``wgmma`` block is 8 rows x 8 columns of one sample, and each
    slab's halo comes from its own sample.  A sample has ``tiles_y *
    tiles_x`` pixel tiles; tiles at the right and bottom edges, and slabs
    past the last sample, may reach past the data: the kernel masks them."""
    bm: int
    bn: int
    tw: int
    rows: int
    samples: int
    tiles_y: int
    tiles_x: int

    def groups(self, n):
        """Tiles of ``samples`` samples along the batch."""
        return -(-n // self.samples)

    def blocks(self, n, co):
        return self.groups(n) * self.tiles_y * self.tiles_x * (co // self.bn)

    def tile(self, bid, co):
        """The kernel's decode of block ``bid`` (an int or an integer array):
        ``(first sample, first row, first column, first output channel)``."""
        co_tiles = co // self.bn
        ptile, co0 = bid // co_tiles, (bid % co_tiles) * self.bn
        per = self.tiles_y * self.tiles_x
        grp, t = ptile // per, ptile % per
        return (grp * self.samples, (t // self.tiles_x) * self.rows,
                (t % self.tiles_x) * self.tw, co0)

    def pixels(self, bid, co):
        """(sample, row, column) of every pixel of block ``bid``'s tile, in
        the kernel's order, each of shape ``(len(bid), bm)``."""
        n0, y0, x0, _ = self.tile(np.asarray(bid), co)
        m = np.arange(self.bm)
        slab = self.rows * self.tw
        s, mm = m // slab, m % slab
        cg, r, cc = mm // (8 * self.rows), mm % (8 * self.rows) // 8, mm % 8
        return (n0[:, None] + s, y0[:, None] + r,
                x0[:, None] + 8 * cg + cc)


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, h: int, w: int, co: int) -> LaunchPlan:
    """The block tile for an (n, h, w, *) -> co conv: the first of
    :data:`TILES` that gives at least :data:`SMS` blocks, else the one that
    gives the most.  A tile's width is the largest power of two <= w, within
    8 and min(32, bm / 8); its slab has as many rows as the image, rounded
    up to a power of two, within 8 and the tile; the tile holds as many
    slabs (samples) as fit."""
    if co % 32:
        raise ValueError(f"conv3x3_gn kernel takes output channels in "
                         f"multiples of 32, got {co}")
    best = None
    for bm, bn in TILES:
        if co % bn:
            continue
        tw = max(8, min(1 << (w.bit_length() - 1), bm // 8, 32))
        rows = max(8, min(bm // tw, 1 << (h - 1).bit_length()))
        plan = LaunchPlan(bm, bn, tw, rows, bm // (rows * tw), -(-h // rows),
                          -(-w // tw))
        if plan.blocks(n, co) >= SMS:
            return plan
        if best is None or plan.blocks(n, co) > best.blocks(n, co):
            best = plan
    return best


_TICKETS = {}


def _tickets(dev, stream, count):
    """Zeroed int32 tickets for the moment election, one buffer per device
    and stream: the kernel leaves them zero, and launches on one stream run
    in order."""
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 4096), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


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


def _launch_args(x, w, b, flags, plan, prologue, sample_bias, residual,
                 emit_moments):
    """The kernel's C arguments for checked CUDA tensors and their plan:
    ``(args, y, moments)``, y and the moments (or None) being the tensors
    the launch fills.  Launch with x's card current: the stream is its
    current stream.  (Measurements launch other builds of the same source
    with these arguments.)"""
    n, h, wd, c = x.shape
    co = w.shape[-1]
    if emit_moments:
        flags |= _EMIT_MOMENTS
    pa, pb = prologue if prologue is not None else (None, None)
    dev = x.device
    wp = _packed(w)
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=dev)
    mom = ws = tickets = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    if emit_moments:
        # one allocation: the moments, then the (N, T, 2, CO) partials
        m = n * 2 * co
        buf = torch.empty(m * (1 + plan.tiles_y * plan.tiles_x),
                          dtype=torch.float32, device=dev)
        mom, ws = buf[:m].view(n, 2, co), buf[m:]
        tickets = _tickets(dev, stream, plan.groups(n) * (co // plan.bn))

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (_DTYPE_CODE[x.dtype], ptr(x), ptr(wp), ptr(b), ptr(pa), ptr(pb),
            ptr(sample_bias), ptr(residual), ptr(y), ptr(mom), ptr(ws),
            ptr(tickets), n, h, wd, c, co, flags, plan.bm, plan.bn, plan.tw,
            plan.rows, stream)
    return args, y, mom


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
    (counted in ``conv3x3_gn.launches``, and by kernel function in
    ``conv3x3_gn.tiles``) or raise.
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
    launch = _build.load("conv3x3_gn")
    args, y, mom = _launch_args(x, w, b, flags, plan, prologue, sample_bias,
                                residual, emit_moments)
    with torch.cuda.device(x.device):
        err = launch(*args)
    if err != 0:
        raise RuntimeError(f"conv3x3_gn launch failed (error {err})")
    _build.count_launch(conv3x3_gn,
                        tiles=tile_key(x.dtype, plan.bm, plan.bn))
    return y, mom


conv3x3_gn.launches = 0
# launches by kernel function, as tile_key names them
conv3x3_gn.tiles = dict.fromkeys(
    (tile_key(d, bm, bn) for d in _DTYPE_CODE for bm, bn in TILES), 0)
