"""Two-phase fused GroupNorm(32, eps 1e-6) [+ swish] on NHWC, in Triton.

Replaces the TPU kernel
``pnpflow_tpu/ops/pallas_kernels.py:_gn_swish_bm_kernel`` (launched by
``_gn_swish_bm_pallas``, entry ``groupnorm_swish_bm``), the U-Net's
``fused_norm "bm"`` path.  It computes the same function as
``groupnorm_swish`` (``ops/gn_swish.py``): per sample and group, float32
statistics E[x] and max(E[x^2] - E[x]^2, 0) over the group's (H, W, C/G)
slab, then (x - mean) * rsqrt(var + eps) * scale + bias, an optional swish,
and a store in x's dtype.

On the TPU the layout was the point: the kernel read the activations
batch-minor, as XLA had laid them out, with a sequential two-phase grid that
carried the moment sums in VMEM scratch.  Here blocks run in parallel and
carry nothing between them, so the two phases are two launches:

1. a grid over (sample, HW tile): each program loads whole NHWC rows (every
   channel of a pixel, contiguous and coalesced), sums x and x^2 per channel
   in float32 and writes its tile's partials to a (N, T, 2, C) workspace;
2. a grid over (sample, HW tile): each program sums its sample's T partials
   in a fixed order, pools them into group statistics, then normalizes,
   applies the swish and stores its tile.

No atomics, so results repeat exactly from run to run.  Channels are held as
a (group, channel-in-group) tile, so group sizes that are not a power of two
(3, 6, 12 in the U-Net) are masked rather than gathered.

What bounds it on an H100: bytes.  Two reads and one write of each element
(the TPU design's traffic), against a least time of 2 * N*H*W*C * itemsize
over 3.35 TB/s, the same bound as ``groupnorm_swish``'s.

Beside the kernel: :func:`groupnorm_swish_bm`, an autograd function whose
backward is the plain copy of ``_gn_swish_vjp_bwd``, as the JAX entry shares
that backward.  The plain version, for CPU tensors and as the yardstick, is
``groupnorm_swish``'s own :func:`~pnpflow_tpu_torch.ops.gn_swish.gn_swish_reference`,
since the function is the same.
"""

from __future__ import annotations

import functools

import torch

from pnpflow_tpu_torch.ops.gn_swish import (
    gn_swish_backward, gn_swish_reference)

__all__ = ["groupnorm_swish_bm", "groupnorm_swish_bm_fwd"]

TILE_ELEMS = 4096     # elements of one (rows, groups, channels) load
MAX_TILES = 32        # HW tiles per sample: programs of one sample


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def moments_kernel(x_ptr, ws_ptr, HW, C, CG, ROWS, T,
                       BLOCK_HW: tl.constexpr, BLOCK_G: tl.constexpr,
                       BLOCK_CG: tl.constexpr):
        n = tl.program_id(0)
        t = tl.program_id(1)
        g = tl.arange(0, BLOCK_G)[None, :, None]
        j = tl.arange(0, BLOCK_CG)[None, None, :]
        ch = g * CG + j                                   # (1, G, CG)
        cmask = (j < CG) & (ch < C)
        r0 = t * ROWS
        r1 = tl.minimum(r0 + ROWS, HW)
        base = n.to(tl.int64) * HW * C
        s1 = tl.zeros([BLOCK_HW, BLOCK_G, BLOCK_CG], tl.float32)
        s2 = tl.zeros([BLOCK_HW, BLOCK_G, BLOCK_CG], tl.float32)
        for start in range(r0, r1, BLOCK_HW):
            rows = (start + tl.arange(0, BLOCK_HW))[:, None, None]
            mask = (rows < r1) & cmask
            v = tl.load(x_ptr + base + rows * C + ch, mask=mask,
                        other=0.0).to(tl.float32)
            s1 += v
            s2 += v * v
        out = ws_ptr + (n * T + t).to(tl.int64) * 2 * C
        g2 = tl.arange(0, BLOCK_G)[:, None]
        j2 = tl.arange(0, BLOCK_CG)[None, :]
        ch2 = g2 * CG + j2                                # (G, CG)
        m2 = (j2 < CG) & (ch2 < C)
        tl.store(out + ch2, tl.sum(s1, axis=0), mask=m2)
        tl.store(out + C + ch2, tl.sum(s2, axis=0), mask=m2)

    @triton.jit
    def normalize_kernel(x_ptr, ws_ptr, scale_ptr, bias_ptr, y_ptr, HW, C,
                         CG, ROWS, T, eps, inv_n, SWISH: tl.constexpr,
                         BLOCK_HW: tl.constexpr, BLOCK_G: tl.constexpr,
                         BLOCK_CG: tl.constexpr):
        n = tl.program_id(0)
        t = tl.program_id(1)
        g = tl.arange(0, BLOCK_G)[:, None]
        j = tl.arange(0, BLOCK_CG)[None, :]
        ch = g * CG + j                                   # (G, CG)
        cmask = (j < CG) & (ch < C)
        # this sample's partials, summed in a fixed order
        s1 = tl.zeros([BLOCK_G, BLOCK_CG], tl.float32)
        s2 = tl.zeros([BLOCK_G, BLOCK_CG], tl.float32)
        wbase = ws_ptr + n.to(tl.int64) * T * 2 * C
        for k in range(0, T):
            s1 += tl.load(wbase + k * 2 * C + ch, mask=cmask, other=0.0)
            s2 += tl.load(wbase + k * 2 * C + C + ch, mask=cmask, other=0.0)
        mean = tl.sum(s1, axis=1) * inv_n                 # (G,)
        var = tl.maximum(tl.sum(s2, axis=1) * inv_n - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        sc = tl.load(scale_ptr + ch, mask=cmask, other=0.0)
        bi = tl.load(bias_ptr + ch, mask=cmask, other=0.0)
        mean3 = mean[None, :, None]
        rstd3 = rstd[None, :, None]
        sc3 = sc[None, :, :]
        bi3 = bi[None, :, :]
        ch3 = ch[None, :, :]
        cmask3 = cmask[None, :, :]

        r0 = t * ROWS
        r1 = tl.minimum(r0 + ROWS, HW)
        base = n.to(tl.int64) * HW * C
        for start in range(r0, r1, BLOCK_HW):
            rows = (start + tl.arange(0, BLOCK_HW))[:, None, None]
            mask = (rows < r1) & cmask3
            offs = base + rows * C + ch3
            v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = (v - mean3) * rstd3 * sc3 + bi3
            if SWISH:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return moments_kernel, normalize_kernel


def _pow2(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tiling(hw: int, c: int, num_groups: int) -> dict:
    """Block sizes, rows per program and programs per sample for one
    shape: whole rows of a (BLOCK_G, BLOCK_CG) channel tile, about
    TILE_ELEMS elements per load, and T <= MAX_TILES programs per sample
    so that the partials phase 2 re-reads stay small beside the tile."""
    block_g, block_cg = _pow2(num_groups), _pow2(c // num_groups)
    block_hw = max(TILE_ELEMS // (block_g * block_cg), 1)
    tiles = min(MAX_TILES, max(1, hw // 128))
    rows = _cdiv(_cdiv(hw, tiles), block_hw) * block_hw
    return dict(BLOCK_HW=block_hw, BLOCK_G=block_g, BLOCK_CG=block_cg,
                rows=rows, tiles=_cdiv(hw, rows))


def groupnorm_swish_bm_fwd(x, scale, bias, num_groups: int = 32,
                           eps: float = 1e-6, swish: bool = True):
    """Forward only.  CPU tensors take :func:`gn_swish_reference`; CUDA
    tensors launch the two Triton kernels (one launch counted in
    ``.launches``) or raise."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("scale and bias must have shape (C,)")
    if x.device.type == "cpu":
        return gn_swish_reference(x, scale, bias, num_groups, eps, swish)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.device != x.device or p.dtype != torch.float32
                or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {x.device}")
    n, h, w, _ = x.shape
    hw, cg = h * w, c // num_groups
    til = tiling(hw, c, num_groups)
    blocks = dict(BLOCK_HW=til["BLOCK_HW"], BLOCK_G=til["BLOCK_G"],
                  BLOCK_CG=til["BLOCK_CG"])
    rows, tiles = til["rows"], til["tiles"]
    moments, normalize = _triton_kernels()
    ws = torch.empty((n, tiles, 2, c), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    moments[(n, tiles)](x, ws, hw, c, cg, rows, tiles, **blocks, num_warps=4)
    normalize[(n, tiles)](x, ws, scale, bias, y, hw, c, cg, rows, tiles,
                          float(eps), 1.0 / (hw * cg), SWISH=bool(swish),
                          **blocks, num_warps=4)
    groupnorm_swish_bm_fwd.launches += 1
    return y


groupnorm_swish_bm_fwd.launches = 0


class _GroupNormSwishBM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, swish):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, swish)
        return groupnorm_swish_bm_fwd(x, scale, bias, num_groups, eps, swish)

    @staticmethod
    def backward(ctx, dy):
        return (*gn_swish_backward(*ctx.saved_tensors, *ctx.cfg, dy),
                None, None, None)


def groupnorm_swish_bm(x, scale, bias, num_groups: int = 32,
                       eps: float = 1e-6, swish: bool = True):
    """GroupNorm(num_groups, eps) [+ swish] on NHWC through the two-phase
    kernel, differentiable."""
    return _GroupNormSwishBM.apply(x, scale, bias, num_groups, eps, swish)
