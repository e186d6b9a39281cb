"""FIR resampling (upfirdn2d) on NHWC, with a hand-written CUDA kernel.

Port of ``pnpflow_tpu/ops/upfirdn.py``.  :func:`upfirdn2d` replaces the TPU
kernel ``pnpflow_tpu/ops/pallas_kernels.py:_fir2d_kernel`` (launched by
``_fir2d_padded``, entry ``upfirdn2d_pallas``):

  out = decimate_down( conv(pad(zero_insert_up(x)), flip(k)) )

zero insertion appends ``up - 1`` zeros after every sample (the last one
included), both spatial axes are padded by ``(pad0, pad1)``, the K x K taps
are applied as a true convolution with float32 accumulation, and every
``down``-th output is kept, stored in x's dtype.

What bounds it on an H100: bytes.  It does at most K*K multiply-adds per
output (16 for the NCSN++ taps, of which 4 meet real samples at an up site),
far below compute, so the least time is one read of x and one write of y
over 3.35 TB/s.  What the design does about it (``csrc/upfirdn2d.cu``): the
TPU kernel needs the zero-inserted, padded image in VMEM; here that image
exists nowhere.  :func:`fir_plan` picks one of three paths from the shape:

* "tiled", the NCSN++ sites (K = 4, up 1 / down 2 or up 2 / down 1, pixels
  of whole 16-byte vectors, x 16-byte aligned): a block stages the input
  footprint of a TH x TW output tile and a chunk of channels once into
  shared memory (16-byte ``cp.async``, zero-filled padding), and each thread
  computes a 2 x 2 output quad (up) or two neighbours (down) from a window
  of that footprint, with the taps of each phase (:func:`fir_phase_table`,
  derived from ``pad0 mod up``) resolved at compile time;
* "narrow", the same kinds on scalar channels: pixels that are not whole
  16-byte vectors (the C = 3 image pyramids) or an unaligned x;
* "general", any other K <= 8, up or down: one thread per output pixel and
  four channels, which finds its inputs by index arithmetic.

Beside the kernel: :func:`upfirdn2d_reference`, the plain PyTorch version
(used for CPU tensors and as the kernel's yardstick), and the resampling
helpers the NCSN++ uses.  The JAX module's FIR-backend switch and its VMEM
fallback choose between XLA and Pallas on a TPU and have no counterpart:
every CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pnpflow_tpu_torch.ops import _build
from pnpflow_tpu_torch.ops.gn_swish import needs_autograd

__all__ = [
    "setup_kernel", "upfirdn2d", "upfirdn2d_reference", "adjoint_geometry",
    "fir_plan",
    "FirPlan", "fir_geometry", "fir_phase_table", "upsample_2d",
    "downsample_2d", "upsample_conv_2d", "conv_downsample_2d",
    "naive_upsample_2d", "naive_downsample_2d",
]

MAX_TAPS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PATHS = ("tiled", "narrow", "general")
_ERR_PLAN = -3
TILE_K = 4                  # taps of the tiled and narrow paths
TILE_KINDS = ((1, 2), (2, 1))   # their (up, down): the NCSN++ down and up
SMEM_MAX = 48 * 1024        # a block's shared memory without opting in
MAX_THREADS = 512           # the tile kernel's __launch_bounds__
GRID_MAX = 65535            # blocks along the grid's y and z
# (task rows, threads of a task row) of a tile: a down thread owns two
# outputs of a row, an up thread a 2 x 2 quad
TILE_TASKS = {(1, 2): (8, 32), (2, 1): (4, 128)}
THREADS = 256               # threads a block aims at


def setup_kernel(k) -> np.ndarray:
    """1-D separable or 2-D FIR kernel -> normalized 2-D float32 kernel."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"FIR kernel must be square, got {k.shape}")
    return k


def _check_args(x, k, up, down, pad):
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"FIR kernel must be square, got {k.shape}")
    pad0, pad1 = int(pad[0]), int(pad[1])
    if pad0 < 0 or pad1 < 0:
        raise NotImplementedError("negative upfirdn2d padding")
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    hp = x.shape[1] * up + pad0 + pad1
    wp = x.shape[2] * up + pad0 + pad1
    if hp < k.shape[0] or wp < k.shape[1]:
        raise ValueError("padded image is smaller than the FIR kernel")
    return pad0, pad1


class FirGeometry(NamedTuple):
    """Per-thread geometry of a tiled kind (``csrc/upfirdn2d.cu:Kind``): a
    thread owns ``ry`` x ``rx`` outputs; the next task's window starts
    ``sy`` rows / ``sx`` columns further into the footprint; a window is
    ``wh`` x ``ww`` footprint cells."""
    ry: int
    rx: int
    sy: int
    sx: int
    wh: int
    ww: int


def _window(r_count, up, down, pm):
    return max((r * down + p - pm) // up + 1 for r in range(r_count)
               for p in range(TILE_K)
               if r * down + p - pm >= 0 and (r * down + p - pm) % up == 0)


@functools.lru_cache(maxsize=None)
def fir_geometry(up: int, down: int, pm: int) -> FirGeometry:
    ry = up
    rx = 2 if (up, down) == (1, 2) else up
    return FirGeometry(ry, rx, ry * down // up, rx * down // up,
                       _window(ry, up, down, pm), _window(rx, up, down, pm))


@functools.lru_cache(maxsize=None)
def fir_phase_table(up: int, down: int, pm: int) -> tuple:
    """Which window cell meets which tap of which output, for phase
    ``pm = pad0 % up``: (rows, columns), each a tuple of ``(w, r, t)`` =
    window row (column) ``w`` feeds a thread's output row (column) ``r``
    through tap row (column) ``t`` of the flipped taps, with
    ``t = w * up + pm - r * down``.  The kernel unrolls the same entries at
    compile time, in this order (w, then r)."""
    g = fir_geometry(up, down, pm)

    def axis(wins, outs):
        return tuple((w, r, w * up + pm - r * down) for w in range(wins)
                     for r in range(outs)
                     if 0 <= w * up + pm - r * down < TILE_K)

    return axis(g.wh, g.ry), axis(g.ww, g.rx)


class FirPlan(NamedTuple):
    """How ``csrc/upfirdn2d.cu`` runs one shape.  ``path``: "tiled",
    "narrow" or "general" (the rest is 0 there).  A block is (``cv``, ``it``,
    ``jz``) threads: ``cv`` cells of a channel chunk (16-byte vectors of
    ``v`` channels on "tiled", single channels on "narrow"), ``it`` task
    columns, ``jz`` thread rows that stride over ``jt`` task rows.  It owns
    a ``tile`` (th, tw) of outputs, stages a ``foot`` (fh, fw) of input
    pixels in ``smem`` bytes, and the grid is (chunks, tiles_y * tiles_x,
    n); ``phase`` is (pad0 % up, pad0 // up)."""
    path: str
    oh: int
    ow: int
    cv: int = 0
    v: int = 0
    it: int = 0
    jt: int = 0
    jz: int = 0
    tile: tuple = (0, 0)
    foot: tuple = (0, 0)
    tiles: tuple = (0, 0)
    phase: tuple = (0, 0)
    chunks: int = 0
    smem: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _largest_divisor(n: int, cap: int) -> int:
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


@functools.lru_cache(maxsize=None)
def fir_plan(n: int, h: int, w: int, c: int, up: int, down: int, pad0: int,
             pad1: int, kk: int, itemsize: int,
             aligned: bool = True) -> FirPlan:
    """The launch plan for upfirdn2d of an (n, h, w, c) input.

    K = 4 with (up, down) of :data:`TILE_KINDS` takes "tiled" where a pixel
    is whole 16-byte vectors and x is 16-byte ``aligned``, else "narrow";
    every other shape takes "general".  A chunk is the largest divisor of
    the pixel's cells up to 8 vectors (one 128-byte line) or 32 channels.
    A tile is :data:`TILE_TASKS` task rows by as many task columns as fill a
    row's threads, both cut to the output, so a large site has thousands of
    blocks and a small one a block per sample and chunk.  A chunk's pixel
    is at most 128 bytes, so a footprint takes at most 41,472 bytes, under
    :data:`SMEM_MAX`."""
    oh = (h * up + pad0 + pad1 - kk) // down + 1
    ow = (w * up + pad0 + pad1 - kk) // down + 1
    if max(n * h * w * c, n * oh * ow * c) >= 2**31:
        raise ValueError("upfirdn2d kernel takes fewer than 2^31 elements")
    if kk != TILE_K or (up, down) not in TILE_KINDS:
        return FirPlan("general", oh, ow)
    if aligned and (c * itemsize) % 16 == 0:
        path, v = "tiled", 16 // itemsize
        cv, cell = _largest_divisor(c // v, 8), 16
    else:
        path, v = "narrow", 1
        cv, cell = _largest_divisor(c, 32), 4
    pm, q = pad0 % up, pad0 // up
    g = fir_geometry(up, down, pm)
    jt, row_threads = TILE_TASKS[(up, down)]
    it = min(max(1, row_threads // cv), _cdiv(ow, g.rx))
    jt = min(jt, _cdiv(oh, g.ry))
    jz = min(jt, max(1, THREADS // (cv * it)))
    fh, fw = (jt - 1) * g.sy + g.wh, (it - 1) * g.sx + g.ww
    th, tw = g.ry * jt, g.rx * it
    plan = FirPlan(path, oh, ow, cv, v, it, jt, jz, (th, tw), (fh, fw),
                   (_cdiv(oh, th), _cdiv(ow, tw)), (pm, q), c // (cv * v),
                   fh * fw * cv * cell)
    if plan.tiles[0] * plan.tiles[1] > GRID_MAX or n > GRID_MAX:
        raise ValueError(f"upfirdn2d grid too large for {n} samples: {plan}")
    return plan


def upfirdn2d_reference(x, k, up: int = 1, down: int = 1, pad=(0, 0)):
    """Plain PyTorch upfirdn2d: zero-insert, pad, depthwise conv with the
    flipped taps in float32, decimate; the result in x's dtype."""
    k = np.asarray(k, dtype=np.float32)
    pad0, pad1 = _check_args(x, k, up, down, pad)
    n, h, w, c = x.shape
    xf = x.float()
    if up > 1:
        z = xf.new_zeros((n, h * up, w * up, c))
        z[:, ::up, ::up, :] = xf
        xf = z
    xf = F.pad(xf.permute(0, 3, 1, 2), (pad0, pad1, pad0, pad1))
    taps = torch.from_numpy(k[::-1, ::-1].copy()).to(x.device)
    weight = taps[None, None].expand(c, 1, *k.shape).contiguous()
    y = F.conv2d(xf, weight, groups=c)[:, :, ::down, ::down]
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


_TAPS = {}


def _flipped_taps(k, up, down, pad0, pad1):
    """The flipped taps as a ctypes array, built once per distinct (taps,
    up, down, pad)."""
    key = (k.shape[0], k.tobytes(), up, down, pad0, pad1)
    taps = _TAPS.get(key)
    if taps is None:
        flipped = k[::-1, ::-1].ravel()
        taps = _TAPS[key] = (ctypes.c_float * flipped.size)(
            *flipped.tolist())
    return taps


ROLES = ("forward", "adjoint", "tangent")


def _upfirdn2d_fwd(x, k, up, down, pad, role):
    """The bare forward: the arguments are checked as the kernel takes them
    on every device, so a CPU run finds what the card would refuse; then
    CPU tensors take :func:`upfirdn2d_reference` and CUDA tensors launch
    the kernel on the path :func:`fir_plan` picks (counted in
    ``upfirdn2d.launches``, ``.paths`` and, by ``role``, ``.roles``) or
    raise."""
    k = np.asarray(k, dtype=np.float32)
    pad0, pad1 = _check_args(x, k, up, down, pad)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    kk = k.shape[0]
    if kk > MAX_TAPS:
        raise ValueError(f"FIR kernel of size {kk} exceeds {MAX_TAPS}")
    n, h, w, c = x.shape
    plan = fir_plan(n, h, w, c, up, down, pad0, pad1, kk, x.element_size(),
                    x.data_ptr() % 16 == 0)
    if x.device.type == "cpu":
        return upfirdn2d_reference(x, k, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    launch = _build.load("upfirdn2d")
    y = torch.empty((n, plan.oh, plan.ow, c), dtype=x.dtype, device=x.device)
    args = (_DTYPE_CODE[x.dtype], PATHS.index(plan.path), x.data_ptr(),
            y.data_ptr(), _flipped_taps(k, up, down, pad0, pad1), kk, n, h, w,
            c, plan.oh, plan.ow, up, down, pad0, plan.cv, plan.it, plan.jt,
            plan.jz, *plan.foot, plan.tiles[1], plan.tiles[0], plan.smem)
    # the raw stream handle, and no device switch where none is needed,
    # cut the host's cost per call, which every small site pays
    idx = x.device.index
    if idx == torch.cuda.current_device():
        err = launch(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(x.device):
            err = launch(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err == _ERR_PLAN:
        raise RuntimeError(f"upfirdn2d plan disagrees with the kernel's "
                           f"geometry: {plan}")
    if err != 0:
        raise RuntimeError(f"upfirdn2d launch failed (error {err}) for "
                           f"{tuple(x.shape)} {x.dtype}: {plan}")
    _build.count_launch(upfirdn2d, paths=plan.path, roles=role)
    return y


def adjoint_geometry(h: int, w: int, k, up: int, down: int, pad):
    """The upfirdn2d whose output is the gradient of an (h, w) input:
    ``(taps, up, down, (pad0, pad1), crop)``, as StyleGAN2's
    ``UpFirDn2dBackward`` (the RectifiedFlow op the reference vendors) takes
    it: the taps flipped, up and down swapped, pad0' = K - pad0 - 1 and
    pad1' = H*up - OH*down + pad0 - up + 1 per axis, which makes its output
    h x w.  The kernel takes one pad for both axes, and no negative one:
    where the two axes' pad1' differ (a non-square input) or one is
    negative (the forward never reads its last inputs' zero tail), it runs
    with the largest pad1', at least 0, and ``crop`` = (h, w) keeps the
    first outputs, which a larger pad1' leaves as they are; ``crop`` is
    None where nothing is cut.  The NCSN++'s sites are square and take
    pad1' >= 0."""
    k = np.asarray(k, dtype=np.float32)
    kk = k.shape[0]
    pad0, pad1 = int(pad[0]), int(pad[1])
    g0 = kk - pad0 - 1
    if g0 < 0:
        raise NotImplementedError(
            f"pad0 {pad0} >= K {kk}: the adjoint would need a negative pad")
    g1s = [n_in * up - ((n_in * up + pad0 + pad1 - kk) // down + 1) * down
           + pad0 - up + 1 for n_in in (h, w)]
    g1 = max(*g1s, 0)
    crop = None if g1s == [g1, g1] else (h, w)
    return k[::-1, ::-1].copy(), down, up, (g0, g1), crop


class _UpFirDn2d(torch.autograd.Function):
    """upfirdn2d as an autograd function in the ``forward`` +
    ``setup_context`` form that ``torch.func`` transforms take.  Its
    backward is upfirdn2d on the cotangent with :func:`adjoint_geometry`,
    so a CUDA cotangent launches the same kernel; the op is linear, so its
    forward-mode rule is the forward on the tangent.  Both go through the
    entry's dispatch, so they are differentiable in turn; ``role`` says
    under which name the launch is counted."""

    @staticmethod
    def forward(x, k, up, down, pad, role):
        return _upfirdn2d_fwd(x, k, up, down, pad, role)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, k, up, down, pad, _ = inputs
        ctx.geometry = (k, up, down, pad)
        ctx.adjoint = adjoint_geometry(x.shape[1], x.shape[2], k, up, down,
                                       pad)

    @staticmethod
    def backward(ctx, dy):
        taps, up, down, pad, crop = ctx.adjoint
        dx = _upfirdn2d(dy.contiguous(), taps, up, down, pad, "adjoint")
        if crop is not None:
            dx = dx[:, :crop[0], :crop[1]].contiguous()
        return dx, None, None, None, None, None

    @staticmethod
    def jvp(ctx, dx, *_):
        return _upfirdn2d(dx.contiguous(), *ctx.geometry, "tangent")


def _upfirdn2d(x, k, up, down, pad, role):
    if needs_autograd(x):
        return _UpFirDn2d.apply(x, k, up, down, pad, role)
    return _upfirdn2d_fwd(x, k, up, down, pad, role)


def upfirdn2d(x, k, up: int = 1, down: int = 1, pad=(0, 0)):
    """upfirdn2d on NHWC, differentiable in reverse and forward mode.  The
    arguments are checked as the kernel takes them on every device; then
    CPU tensors take :func:`upfirdn2d_reference` and CUDA tensors launch
    the kernel or raise, in the forward, in the backward (the adjoint
    geometry) and under a forward-mode transform (the tangent).  Launches
    are counted in ``upfirdn2d.launches``, by path in ``.paths`` and by
    role ("forward", "adjoint", "tangent") in ``.roles``.  Where
    :func:`~pnpflow_tpu_torch.ops.gn_swish.needs_autograd` finds nothing to
    differentiate, the bare forward runs without the autograd function."""
    return _upfirdn2d(x, k, int(up), int(down), (int(pad[0]), int(pad[1])),
                      "forward")


upfirdn2d.launches = 0
upfirdn2d.paths = dict.fromkeys(PATHS, 0)
upfirdn2d.roles = dict.fromkeys(ROLES, 0)


def upsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
    """FIR upsample by ``factor``."""
    k = setup_kernel([1.0] * factor if k is None else k) * (gain * factor**2)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
    """FIR downsample by ``factor``."""
    k = setup_kernel([1.0] * factor if k is None else k) * gain
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(x, w_oihw, k=None, factor: int = 2, gain: float = 1.0):
    """Transposed-conv upsample fused with the FIR filter.  ``w_oihw`` is a
    torch conv weight (O, I, kh, kw); the stride-``factor`` transposed conv
    with its flipped taps equals the JAX dilated cross-correlation."""
    kh = w_oihw.shape[-1]
    k = setup_kernel([1.0] * factor if k is None else k) * (gain * factor**2)
    p = (k.shape[0] - factor) - (kh - 1)
    wt = w_oihw.to(x.dtype).flip(2, 3).transpose(0, 1)       # (I, O, kh, kw)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=factor)
    y = y.permute(0, 2, 3, 1).contiguous()
    return upfirdn2d(y, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x, w_oihw, k=None, factor: int = 2, gain: float = 1.0):
    """FIR filter fused with a stride-``factor`` valid conv."""
    kh = w_oihw.shape[-1]
    k = setup_kernel([1.0] * factor if k is None else k) * gain
    p = (k.shape[0] - factor) + (kh - 1)
    y = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
    y = F.conv2d(y.permute(0, 3, 1, 2), w_oihw.to(x.dtype), stride=factor)
    return y.permute(0, 2, 3, 1).contiguous()


def naive_upsample_2d(x, factor: int = 2):
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def naive_downsample_2d(x, factor: int = 2):
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    return x.mean(dim=(2, 4))
