"""Fused GroupNorm(32, eps 1e-6) [+ swish] on NHWC, as a Triton kernel.

Replaces the TPU kernel ``pnpflow_tpu/ops/pallas_kernels.py:_gn_swish_kernel``
(launched by ``_gn_swish_fwd_pallas``, entry ``groupnorm_swish``).

What it computes: per sample and per group, one-pass float32 statistics
E[x], E[x^2] - E[x]^2 (clamped at 0, as flax's GroupNorm does) over the
group's (H, W, C/G) slab; then (x - mean) * rsqrt(var + eps) * scale + bias,
an optional swish, and a store in x's dtype.

What bounds it on an H100: bytes.  It does a handful of operations per
element, far below the ~295 operations per byte the card needs before
compute is the limit, so the least time is 2 * N*H*W*C * itemsize (read
once, write once) over 3.35 TB/s.

What the design does about it: one program per (sample, group) loops over
the slab twice, once for the two sums and once to normalize and store, so
the tensor crosses device memory as one write and at most two reads (a
slab is at most 64*64*16*4 bytes = 256 KB, so L2 can serve the second).
Group sizes that are not a power of two (3, 6, 12 in the U-Net) are masked.
Channels are strided by C in NHWC, so the loads are as wide as one group's
channels; wider, coalesced tiles are later work.

Beside the kernel: :func:`gn_swish_reference`, the plain PyTorch version
(used for CPU tensors and as the kernel's yardstick), and
:func:`groupnorm_swish`, an autograd function whose backward is the plain
copy of ``_gn_swish_vjp_bwd``.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["groupnorm_swish", "groupnorm_swish_fwd", "gn_swish_reference",
           "gn_swish_backward"]


def _gn_stats(x, num_groups, eps):
    """Per-(sample, channel) mean and rsqrt(var + eps), float32, (N, C)."""
    b, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(b, h * w, num_groups, cg)
    mean = xf.mean(dim=(1, 3))                                  # (b, G)
    var = torch.clamp((xf * xf).mean(dim=(1, 3)) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (mean.repeat_interleave(cg, dim=1),
            inv.repeat_interleave(cg, dim=1))


def gn_swish_reference(x, scale, bias, num_groups: int = 32,
                       eps: float = 1e-6, swish: bool = True):
    """Plain PyTorch GroupNorm [+ swish] with the kernel's arithmetic."""
    mean, inv = _gn_stats(x, num_groups, eps)
    y = (x.float() - mean[:, None, None, :]) * inv[:, None, None, :]
    y = y * scale.float() + bias.float()
    if swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def gn_swish_kernel(x_ptr, scale_ptr, bias_ptr, y_ptr, HW, C, CG, G,
                        eps, inv_n, SWISH: tl.constexpr,
                        BLOCK_HW: tl.constexpr, BLOCK_CG: tl.constexpr):
        pid = tl.program_id(0)
        n = pid // G
        g = pid % G
        base = n.to(tl.int64) * HW * C + g * CG
        rows0 = tl.arange(0, BLOCK_HW)
        cols = tl.arange(0, BLOCK_CG)
        cmask = cols < CG

        s1 = tl.zeros([BLOCK_HW, BLOCK_CG], tl.float32)
        s2 = tl.zeros([BLOCK_HW, BLOCK_CG], tl.float32)
        for start in range(0, HW, BLOCK_HW):
            rows = start + rows0
            mask = (rows < HW)[:, None] & cmask[None, :]
            offs = base + rows[:, None].to(tl.int64) * C + cols[None, :]
            v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            s1 += v
            s2 += v * v
        mean = tl.sum(tl.sum(s1, axis=1), axis=0) * inv_n
        meansq = tl.sum(tl.sum(s2, axis=1), axis=0) * inv_n
        var = tl.maximum(meansq - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)

        ch = g * CG + cols
        sc = tl.load(scale_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
        bi = tl.load(bias_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
        for start in range(0, HW, BLOCK_HW):
            rows = start + rows0
            mask = (rows < HW)[:, None] & cmask[None, :]
            offs = base + rows[:, None].to(tl.int64) * C + cols[None, :]
            v = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = (v - mean) * rstd
            y = y * sc[None, :] + bi[None, :]
            if SWISH:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return gn_swish_kernel


def _check(x, scale, bias, num_groups):
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("scale and bias must have shape (C,)")


def groupnorm_swish_fwd(x, scale, bias, num_groups: int = 32,
                        eps: float = 1e-6, swish: bool = True):
    """Forward only.  CPU tensors take :func:`gn_swish_reference`; CUDA
    tensors launch the Triton kernel (counted in ``.launches``) or raise."""
    _check(x, scale, bias, num_groups)
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
    n, h, w, c = x.shape
    cg = c // num_groups
    hw = h * w
    block_cg = 1 << (cg - 1).bit_length()
    block_hw = min(max(2048 // block_cg, 16), 1 << (hw - 1).bit_length())
    y = torch.empty_like(x)
    _triton_kernel()[(n * num_groups,)](
        x, scale, bias, y, hw, c, cg, num_groups, float(eps),
        1.0 / (hw * cg), SWISH=bool(swish), BLOCK_HW=block_hw,
        BLOCK_CG=block_cg, num_warps=4,
    )
    groupnorm_swish_fwd.launches += 1
    return y


groupnorm_swish_fwd.launches = 0


def gn_swish_backward(x, scale, bias, num_groups, eps, swish, dy):
    """Plain copy of ``_gn_swish_vjp_bwd``: (dx, dscale, dbias)."""
    mean, inv = _gn_stats(x, num_groups, eps)
    mean, inv = mean[:, None, None, :], inv[:, None, None, :]
    xhat = (x.float() - mean) * inv
    dy = dy.float()
    if swish:
        ypre = xhat * scale.float() + bias.float()
        sig = torch.sigmoid(ypre)
        dy = dy * (sig * (1.0 + ypre * (1.0 - sig)))
    dscale = (dy * xhat).sum(dim=(0, 1, 2)).to(scale.dtype)
    dbias = dy.sum(dim=(0, 1, 2)).to(bias.dtype)
    dxhat = dy * scale.float()

    b, h, w, c = x.shape
    cg = c // num_groups

    def gmean(a):  # mean over each group's (H, W, Cg) slab
        m = a.reshape(b, h * w, num_groups, cg).mean(dim=(1, 3))
        return m.repeat_interleave(cg, dim=1)[:, None, None, :]

    dx = inv * (dxhat - gmean(dxhat) - xhat * gmean(dxhat * xhat))
    return dx.to(x.dtype), dscale, dbias


class _GroupNormSwish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, swish):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, swish)
        return groupnorm_swish_fwd(x, scale, bias, num_groups, eps, swish)

    @staticmethod
    def backward(ctx, dy):
        return (*gn_swish_backward(*ctx.saved_tensors, *ctx.cfg, dy),
                None, None, None)


def groupnorm_swish(x, scale, bias, num_groups: int = 32, eps: float = 1e-6,
                    swish: bool = True):
    """GroupNorm(num_groups, eps) [+ swish] on NHWC, differentiable."""
    return _GroupNormSwish.apply(x, scale, bias, num_groups, eps, swish)
