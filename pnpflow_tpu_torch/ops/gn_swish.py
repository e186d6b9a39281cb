"""Fused GroupNorm(32, eps 1e-6) [+ swish] on NHWC, as a CUDA kernel.

Replaces the TPU kernel ``pnpflow_tpu/ops/pallas_kernels.py:_gn_swish_kernel``
(launched by ``_gn_swish_fwd_pallas``, entry ``groupnorm_swish``).  The same
kernel, ``csrc/gn_swish.cu``, serves ``groupnorm_swish_bm``
(``ops/gn_swish_bm.py``), since the two entries compute one function.

What it computes: per sample and per group, one-pass float32 statistics
E[x] and max(E[x^2] - E[x]^2, 0) over the group's (H, W, C/G) slab; then
(x - mean) * rsqrt(var + eps) * scale + bias, an optional swish, and a store
in x's dtype.  The clamp at 0 is an intended divergence: JAX's
``groupnorm_swish`` and ``groupnorm_swish_bm`` do not clamp, neither in
their plain path (``pnpflow_tpu/ops/pallas_kernels.py:_gn_stats``, :215) nor
in the kernel (:148), and give NaN where float32 rounding makes the variance
negative (a group of near-constant large values); JAX's conv prologue
(``pnpflow_tpu/ops/fused_conv_gn.py:gn_prologue``, :323) and flax's
``nn.GroupNorm`` clamp, and the port follows them.

What bounds it on an H100: bytes.  It does a handful of operations per
element, far below the ~295 operations per byte the card needs before
compute is the limit, so the least time is 2 * N*H*W*C * itemsize (read
once, write once) over 3.35 TB/s.

What the design does about it (``csrc/gn_swish.cu``): the TPU kernel reads
whole images into VMEM once; here a thread-block cluster of K blocks holds a
sample in its distributed shared memory.  Each block stages a contiguous
range of whole pixel rows with bulk async copies, sums x and x^2 per channel,
and the blocks exchange their group partials through distributed shared
memory in rank order, so each element crosses device memory once each way
and results repeat bit for bit.  :func:`gn_plan` picks K per shape: the
smallest cluster whose blocks fit two to an SM, raised until the grid fills
the card's 132 SMs.  Samples no cluster holds, and rows that are not whole
16-byte vectors, take a two-launch path (per-tile channel moments, then
pooled statistics and the normalize).  No fallback: a launch that fails, or
a cluster the card cannot hold, raises.

Beside the kernel: :func:`gn_swish_reference`, the plain PyTorch version
(used for CPU tensors and as the kernel's yardstick), and
:func:`groupnorm_swish`, an autograd function whose backward is the plain
copy of ``_gn_swish_vjp_bwd`` and whose forward-mode rule (``torch.func.jvp``,
forward AD) is the plain linearisation :func:`gn_swish_jvp`.  JAX's
``custom_vjp`` refuses ``jax.jvp``; the port needs it for ``flow_priors``,
whose Hutchinson term is a JVP inside a gradient.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from pnpflow_tpu_torch.ops import _build

__all__ = ["groupnorm_swish", "groupnorm_swish_fwd", "gn_swish_reference",
           "gn_swish_backward", "gn_swish_jvp", "needs_autograd", "gn_plan",
           "GNPlan", "check_args", "launch"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"cluster": 0, "two_phase": 1}
_ERR_CLUSTER = -2
SMS = 132                   # streaming multiprocessors of an H100 SXM
SMEM_PAIR = 112 * 1024      # a block's shared memory when two share an SM
SMEM_MAX = 227 * 1024       # a block's opt-in maximum (232,448 bytes)
CLUSTER_MAX = 16            # blocks of a cluster (non-portable above 8)
FILL_MAX = 8                # the cluster is raised to fill the card up to 8
TILES_MAX = 64              # row tiles of a sample on the two-phase path
THREADS = 256               # threads a block aims at
MAX_THREADS = 1024
HEAD = 32                   # bytes of mbarriers before a block's partials


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


class GNPlan(NamedTuple):
    """How ``csrc/gn_swish.cu`` runs one shape.  ``path`` "cluster": each
    sample is one cluster of ``k`` blocks; "two_phase": ``k`` row tiles a
    sample in each of two launches.  Block ``i`` of a sample owns pixel rows
    ``rows[i]`` (first, end); ``v`` channels make a vector (1 where a pixel
    row is not whole 16-byte vectors); ``threads`` and ``smem`` (bytes of
    dynamic shared memory) are per block."""
    path: str
    k: int
    v: int
    threads: int
    smem: int
    rows: tuple


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _threads(cv: int, rows: int) -> int:
    """Threads of a block whose rows are ``cv`` vectors wide: whole rows of
    vectors, about :data:`THREADS`, no more row groups than rows."""
    if cv > MAX_THREADS:
        raise ValueError(f"a pixel row of {cv} vectors is wider than a "
                         f"block of {MAX_THREADS} threads")
    return cv * max(1, min(THREADS // cv, rows))


def _red_rows(threads: int, cv: int) -> int:
    """Rows of a block's partial-sum buffer (the kernel's ``red_rows``)."""
    if 32 % cv == 0 and threads % 32 == 0:
        return threads // 32
    return threads // cv


def _split(hw: int, k: int) -> tuple:
    return tuple((hw * i // k, hw * (i + 1) // k) for i in range(k))


@functools.lru_cache(maxsize=None)
def gn_plan(n: int, hw: int, c: int, num_groups: int, itemsize: int) -> GNPlan:
    """The launch plan for n samples of hw pixels x c channels.

    Path "cluster" wherever a pixel row is whole 16-byte vectors and a
    sample fits in 16 blocks of at most 227 KB: the smallest K (a power of
    two, at most the sample's rows) whose blocks fit two to an SM
    (:data:`SMEM_PAIR`), else one to an SM, then K doubled, up to
    :data:`FILL_MAX` and the rows, until n*K >= :data:`SMS`.  Otherwise
    "two_phase", with the fewest row tiles (a power of two, at most
    :data:`TILES_MAX` and the rows) that give 2 * :data:`SMS` blocks.
    """
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} "
                         f"groups")
    v = 16 // itemsize if (c * itemsize) % 16 == 0 else 1
    cv = c // v
    if v > 1:
        def cluster(k):
            rows = _cdiv(hw, k)
            t = _threads(cv, rows)
            off = _cdiv(HEAD + 16 * num_groups + 8 * _red_rows(t, cv) * c,
                        128) * 128
            return GNPlan("cluster", k, v, t, off + rows * c * itemsize,
                          _split(hw, k))

        ks = [k for k in (1, 2, 4, 8, CLUSTER_MAX) if k <= hw]
        k = next((k for k in ks if cluster(k).smem <= SMEM_PAIR),
                 next((k for k in ks if cluster(k).smem <= SMEM_MAX), None))
        if k is not None:
            while n * k < SMS and k < FILL_MAX and 2 * k <= hw:
                k *= 2
            return cluster(k)
    k = 1
    while n * k < 2 * SMS and k < TILES_MAX and 2 * k <= hw:
        k *= 2
    t = _threads(cv, _cdiv(hw, k))
    smem = max(8 * _red_rows(t, cv) * c, 8 * c + 16 * num_groups)
    return GNPlan("two_phase", k, v, t, smem, _split(hw, k))


def check_args(x, scale, bias, num_groups):
    """Check the arguments as the kernel takes them, on every device, and
    return the shape's :func:`gn_plan`."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    dev = x.device
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,):
            raise ValueError(f"{name} must have shape ({c},), got "
                             f"{tuple(p.shape)}")
        if (p.dtype != torch.float32 or p.device != dev
                or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {dev}")
    return gn_plan(n, h * w, c, num_groups, x.element_size())


def launch(x, scale, bias, num_groups, eps, swish, plan):
    """Run ``csrc/gn_swish.cu`` on CUDA tensors checked by
    :func:`check_args`; returns y.  Raises where the card cannot run the
    plan; never computes the result another way."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if plan.v > 1 and x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary for the "
                         "kernel's vector loads")
    n, h, w, c = x.shape
    fn = _build.load("gn_swish")
    y = torch.empty_like(x)
    ws = None
    if plan.path == "two_phase":
        ws = torch.empty((n, plan.k, 2, c), dtype=torch.float32,
                         device=x.device)
    args = (_DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), n, h * w, c, num_groups,
            float(eps), int(bool(swish)), _PATH_CODE[plan.path], plan.k,
            plan.v, plan.threads, plan.smem)
    # The launch goes to the current device and stream.  The raw stream
    # handle, and no device switch where none is needed, keep the host's
    # cost per call below a small site's kernel time, which
    # torch.cuda.current_stream() and torch.cuda.device() each approach.
    idx = x.device.index
    if idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err == _ERR_CLUSTER:
        raise RuntimeError(f"the card cannot hold one cluster of {plan.k} "
                           f"blocks of {plan.smem} bytes: {plan}")
    if err != 0:
        raise RuntimeError(f"gn_swish launch failed (error {err}) for "
                           f"{tuple(x.shape)} {x.dtype}: {plan}")
    return y


def groupnorm_swish_fwd(x, scale, bias, num_groups: int = 32,
                        eps: float = 1e-6, swish: bool = True):
    """Forward only.  The arguments are checked as the kernel takes them on
    every device; then CPU tensors take :func:`gn_swish_reference` and CUDA
    tensors launch ``csrc/gn_swish.cu`` (counted in ``.launches``, and by
    card index in ``.cards``) or raise."""
    plan = check_args(x, scale, bias, num_groups)
    if x.device.type == "cpu":
        return gn_swish_reference(x, scale, bias, num_groups, eps, swish)
    y = launch(x, scale, bias, num_groups, eps, swish, plan)
    _build.count_launch(groupnorm_swish_fwd, cards=x.device.index)
    return y


groupnorm_swish_fwd.launches = 0
groupnorm_swish_fwd.cards = collections.Counter()


def needs_autograd(*tensors) -> bool:
    """Whether a call must go through its autograd function: a gradient is
    recorded for one of ``tensors``, a ``torch.func`` transform (``grad``,
    ``jvp``, ``vjp``, ...) is active, or a forward-AD level is open (a dual
    tensor carries a tangent without ``requires_grad``).  Only where none
    of these holds may a wrapper call its bare forward, whose ctypes launch
    neither records a gradient nor sees a tangent."""
    return (torch._C._functorch.peek_interpreter_stack() is not None
            or torch.autograd.forward_ad._current_level >= 0
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)))


def _normalized(x, num_groups, eps):
    """(xhat, rsqrt(var + eps), gmean) in float32, for the plain rules:
    ``gmean(a)`` is a's mean over each group's (H, W, Cg) slab, broadcast
    back to x's shape."""
    mean, inv = _gn_stats(x, num_groups, eps)
    mean, inv = mean[:, None, None, :], inv[:, None, None, :]
    b, h, w, c = x.shape
    cg = c // num_groups

    def gmean(a):
        m = a.reshape(b, h * w, num_groups, cg).mean(dim=(1, 3))
        return m.repeat_interleave(cg, dim=1)[:, None, None, :]

    return (x.float() - mean) * inv, inv, gmean


def _swish_slope(xhat, scale, bias):
    """d swish(ypre) / d ypre at ypre = xhat * scale + bias."""
    ypre = xhat * scale.float() + bias.float()
    sig = torch.sigmoid(ypre)
    return sig * (1.0 + ypre * (1.0 - sig))


def gn_swish_backward(x, scale, bias, num_groups, eps, swish, dy,
                      params: bool = True):
    """Plain copy of ``_gn_swish_vjp_bwd``: (dx, dscale, dbias), with
    dscale and dbias None unless ``params``."""
    xhat, inv, gmean = _normalized(x, num_groups, eps)
    dy = dy.float()
    if swish:
        dy = dy * _swish_slope(xhat, scale, bias)
    dscale = dbias = None
    if params:
        dscale = (dy * xhat).sum(dim=(0, 1, 2)).to(scale.dtype)
        dbias = dy.sum(dim=(0, 1, 2)).to(bias.dtype)
    dxhat = dy * scale.float()
    dx = inv * (dxhat - gmean(dxhat) - xhat * gmean(dxhat * xhat))
    return dx.to(x.dtype), dscale, dbias


def gn_swish_jvp(x, scale, bias, num_groups, eps, swish, dx, dscale,
                 dbias):
    """The linearisation of GroupNorm [+ swish] at (x, scale, bias) applied
    to the tangents (dx, dscale, dbias), any of them None, in plain PyTorch
    with the arithmetic of :func:`gn_swish_backward`:
    dxhat = inv * (dx - E[dx] - xhat * E[xhat * dx]) over each group,
    dypre = dxhat * scale + xhat * dscale + dbias, times swish's slope."""
    xhat, inv, gmean = _normalized(x, num_groups, eps)
    dy = torch.zeros_like(xhat)
    if dx is not None:
        dxf = dx.float()
        dy = dy + inv * (dxf - gmean(dxf) - xhat * gmean(dxf * xhat)) \
            * scale.float()
    if dscale is not None:
        dy = dy + xhat * dscale.float()
    if dbias is not None:
        dy = dy + dbias.float()
    if swish:
        dy = dy * _swish_slope(xhat, scale, bias)
    return dy.to(x.dtype)


class _GroupNormSwish(torch.autograd.Function):
    """The kernel's forward with a plain backward and a plain forward-mode
    rule, in the ``forward`` + ``setup_context`` form that ``torch.func``
    transforms take.  ``backward_calls`` and ``jvp_calls`` count the rules'
    calls, so a test can see that a transform went through them."""
    fwd = staticmethod(groupnorm_swish_fwd)
    backward_calls = 0
    jvp_calls = 0

    @classmethod
    def forward(cls, x, scale, bias, num_groups, eps, swish):
        return cls.fwd(x, scale, bias, num_groups, eps, swish)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, num_groups, eps, swish = inputs
        ctx.save_for_backward(x, scale, bias)
        ctx.save_for_forward(x, scale, bias)
        ctx.cfg = (num_groups, eps, swish)

    @classmethod
    def backward(cls, ctx, dy):
        cls.backward_calls += 1
        want = ctx.needs_input_grad
        return (*gn_swish_backward(*ctx.saved_tensors, *ctx.cfg, dy,
                                   params=want[1] or want[2]),
                None, None, None)

    @classmethod
    def jvp(cls, ctx, dx, dscale, dbias, *_):
        cls.jvp_calls += 1
        return gn_swish_jvp(*ctx.saved_tensors, *ctx.cfg, dx, dscale, dbias)


def groupnorm_swish(x, scale, bias, num_groups: int = 32, eps: float = 1e-6,
                    swish: bool = True):
    """GroupNorm(num_groups, eps) [+ swish] on NHWC, differentiable in
    reverse and forward mode.  Where :func:`needs_autograd` finds nothing
    to differentiate it calls the forward directly, sparing the host the
    autograd function's cost, which a small site would feel."""
    if needs_autograd(x, scale, bias):
        return _GroupNormSwish.apply(x, scale, bias, num_groups, eps, swish)
    return groupnorm_swish_fwd(x, scale, bias, num_groups, eps, swish)
