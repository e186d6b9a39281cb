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
output (16 for the NCSN++ taps), far below compute, so the least time is one
read of x and one write of y over 3.35 TB/s.  What the design does about it
(``csrc/upfirdn2d.cu``): the TPU kernel needs the zero-inserted, padded image
in VMEM; here each output element finds its inputs by index arithmetic, so
nothing padded or zero-filled is ever written to device memory, and taps that
fall on inserted zeros are skipped.  Threads run over the output with C
innermost, so neighbouring threads load neighbouring addresses.

Beside the kernel: :func:`upfirdn2d_reference`, the plain PyTorch version
(used for CPU tensors and as the kernel's yardstick), and the resampling
helpers the NCSN++ uses.  The JAX module's FIR-backend switch and its VMEM
fallback choose between XLA and Pallas on a TPU and have no counterpart:
every CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from pnpflow_tpu_torch.ops import _build

__all__ = [
    "setup_kernel", "upfirdn2d", "upfirdn2d_reference", "upsample_2d",
    "downsample_2d", "upsample_conv_2d", "conv_downsample_2d",
    "naive_upsample_2d", "naive_downsample_2d",
]

MAX_TAPS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def upfirdn2d(x, k, up: int = 1, down: int = 1, pad=(0, 0)):
    """upfirdn2d on NHWC.  The arguments are checked as the kernel takes
    them on every device, so a CPU run finds what the card would refuse;
    then CPU tensors take :func:`upfirdn2d_reference` and CUDA tensors
    launch the kernel (counted in ``upfirdn2d.launches``) or raise."""
    k = np.asarray(k, dtype=np.float32)
    pad0, pad1 = _check_args(x, k, up, down, pad)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    kk = k.shape[0]
    if kk > MAX_TAPS:
        raise ValueError(f"FIR kernel of size {kk} exceeds {MAX_TAPS}")
    if x.device.type == "cpu":
        return upfirdn2d_reference(x, k, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w, c = x.shape
    oh = (h * up + pad0 + pad1 - kk) // down + 1
    ow = (w * up + pad0 + pad1 - kk) // down + 1
    if max(x.numel(), n * oh * ow * c) >= 2**31:
        raise ValueError("upfirdn2d kernel takes fewer than 2^31 elements")
    flipped = k[::-1, ::-1].ravel()
    taps = (ctypes.c_float * flipped.size)(*flipped.tolist())

    launch = _build.load("upfirdn2d")
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(), taps,
                     kk, n, h, w, c, oh, ow, up, down, pad0, stream)
    if err != 0:
        raise RuntimeError(f"upfirdn2d launch failed (error {err})")
    upfirdn2d.launches += 1
    return y


upfirdn2d.launches = 0


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
