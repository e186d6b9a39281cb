"""Degradation (physics) operators: H / H_adj pairs on NHWC tensors.

Port of ``pnpflow_tpu/ops/degradations.py``: denoising (identity), box,
random and paintbrush inpainting (H = H_adj = mask * x), gaussian
deblurring (circular blur through ``torch.fft`` with the exact conjugate
adjoint, or a depthwise 'same' convolution) and super-resolution (strided
decimation with a zero-fill adjoint, optionally behind a bicubic
anti-aliasing filter).  Filters and masks are built in numpy exactly as the
JAX package builds them (masks from numpy / ``random`` seeded 42, so they
are byte-identical) and stored on the device.
"""

from __future__ import annotations

import copy
import random as _pyrandom

import numpy as np
import torch
import torch.nn.functional as F

from pnpflow_tpu_torch.device import resolve_device


def gaussian_2d_kernel(sigma: float, size: int) -> np.ndarray:
    """Normalized 2-D gaussian kernel on the grid arange(-size//2+1,
    size//2+1)."""
    x = np.arange((-size) // 2 + 1.0, size // 2 + 1.0)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    kernel = np.exp(-(xx**2 + yy**2) / (2.0 * sigma**2))
    return (kernel / kernel.sum()).astype(np.float32)


def bicubic_filter(factor: int = 2) -> np.ndarray:
    """(4*factor, 4*factor) bicubic anti-aliasing filter (a = -0.5)."""
    x = np.arange(start=-2 * factor + 0.5, stop=2 * factor, step=1) / factor
    a = -0.5
    x = np.abs(x)
    w = ((a + 2) * x**3 - (a + 3) * x**2 + 1) * (x <= 1)
    w += (a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a) * ((x > 1) & (x < 2))
    w = np.outer(w, w)
    return (w / w.sum()).astype(np.float32)


def _embed_and_roll(kernel: np.ndarray, dim: int) -> np.ndarray:
    """Place ``kernel`` top-left in a (dim, dim) zero canvas and roll by
    -(ks-1)//2 so its center sits at the origin (circular convolution)."""
    ks = kernel.shape[0]
    if ks > dim:
        raise ValueError(
            f"blur kernel of size {ks} does not fit a {dim}x{dim} image")
    canvas = np.zeros((dim, dim), dtype=np.float32)
    canvas[:ks, :ks] = kernel
    shift = -(ks - 1) // 2
    return np.roll(canvas, (shift, shift), axis=(0, 1))


def _fft_filter(kernel: np.ndarray, dim: int, device) -> torch.Tensor:
    """(1, H, W, 1) complex64 transfer function, broadcast over batch and
    channels."""
    filt = _embed_and_roll(kernel, dim)
    return torch.from_numpy(
        np.fft.fft2(filt).astype(np.complex64)[None, :, :, None]
    ).to(resolve_device(device))


def _fft_apply(x, filt):
    return torch.fft.ifft2(torch.fft.fft2(x, dim=(1, 2)) * filt,
                           dim=(1, 2)).real


class Degradation:
    """A linear measurement operator: H and H_adj on NHWC tensors."""

    def H(self, x):
        raise NotImplementedError

    def H_adj(self, x):
        raise NotImplementedError


class Denoising(Degradation):
    """Identity operator."""

    def H(self, x):
        return x

    def H_adj(self, x):
        return x


class MaskedInpainting(Degradation):
    """All mask-based inpainting: H = H_adj = mask * x, the mask
    broadcastable against NHWC."""

    def __init__(self, mask: np.ndarray, device=None):
        self.mask = torch.from_numpy(
            np.asarray(mask, dtype=np.float32)).to(resolve_device(device))

    def H(self, x):
        return self.mask * x

    def H_adj(self, x):
        return self.mask * x


class BoxInpainting(MaskedInpainting):
    """Centered square of half-size ``half_size_mask`` zeroed."""

    def __init__(self, half_size_mask: int, dim_image: int, device=None):
        d, h = dim_image // 2, half_size_mask
        mask = np.ones((1, dim_image, dim_image, 1), dtype=np.float32)
        mask[:, d - h:d + h, d - h:d + h, :] = 0.0
        self.half_size_mask = half_size_mask
        super().__init__(mask, device)


class RandomInpainting(MaskedInpainting):
    """Bernoulli(1-p) pixel keep-mask from numpy's seed 42, identical across
    calls and batches.  ``RandomState(42)`` draws what the JAX package's
    ``np.random.seed(42)`` draws, without touching the global state."""

    def __init__(self, p: float, dim_image: int, batch_size: int,
                 device=None):
        mask = np.random.RandomState(42).binomial(
            n=1, p=1 - p, size=(batch_size, dim_image, dim_image)
        ).astype(np.float32)[..., None]
        self.p = p
        super().__init__(mask, device)


def _paintbrush_masks(height: int, width: int, batch_size: int,
                      rand_seed: int = 42) -> np.ndarray:
    """Ten thick random lines per image near the center, from python
    ``random`` seeded once: endpoints uniform in [c-30, c+30], thickness
    uniform in [8, 0.08*(h+w)].  Drawn with OpenCV where it is installed,
    else by :func:`_draw_thick_line`, as the JAX package does."""
    rng = _pyrandom.Random(rand_seed)
    size = int((width + height) * 0.08)
    if width < 64 or height < 64:
        raise ValueError("Width and Height of mask must be at least 64!")
    try:
        import cv2
    except ImportError:
        cv2 = None

    masks = np.empty((batch_size, height, width, 1), dtype=np.float32)
    for b in range(batch_size):
        img = np.zeros((height, width, 1), np.uint8)
        for _ in range(10):
            x1 = rng.randint(width // 2 - 30, width // 2 + 30)
            x2 = rng.randint(width // 2 - 30, width // 2 + 30)
            y1 = rng.randint(height // 2 - 30, height // 2 + 30)
            y2 = rng.randint(height // 2 - 30, height // 2 + 30)
            thickness = rng.randint(8, size)
            if cv2 is not None:
                cv2.line(img, (x1, y1), (x2, y2), (255, 255, 255), thickness)
            else:
                _draw_thick_line(img, x1, y1, x2, y2, thickness)
        masks[b] = (img == 0).astype(np.float32)   # keep unpainted pixels
    return masks


def _draw_thick_line(img, x1, y1, x2, y2, thickness):
    """Distance-to-segment rasterization used when cv2 is unavailable."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    px, py = x2 - x1, y2 - y1
    norm2 = max(px * px + py * py, 1)
    t = np.clip(((xx - x1) * px + (yy - y1) * py) / norm2, 0.0, 1.0)
    dist2 = (xx - (x1 + t * px)) ** 2 + (yy - (y1 + t * py)) ** 2
    img[dist2 <= (thickness / 2.0) ** 2] = 255


class PaintbrushInpainting(MaskedInpainting):
    """Paintbrush mask inpainting."""

    def __init__(self, dim_image: int, batch_size: int, device=None):
        super().__init__(_paintbrush_masks(dim_image, dim_image, batch_size),
                         device)


class GaussianDeblurring(Degradation):
    """Gaussian blur: circular through the FFT with the exact conjugate
    adjoint (``mode="fft"``), or a depthwise 'same' convolution, which is
    self-adjoint for the symmetric kernel (any other mode)."""

    def __init__(self, sigma_blur: float, kernel_size: int,
                 num_channels: int = 3, dim_image: int = 128, device=None,
                 mode: str = "fft"):
        self.mode = mode
        self.sigma = sigma_blur
        self.kernel_size = kernel_size
        self.kernel = gaussian_2d_kernel(sigma_blur, kernel_size)
        if mode == "fft":
            self.fft_filter = _fft_filter(self.kernel, dim_image, device)
        else:
            self.conv_weight = torch.from_numpy(self.kernel).to(
                resolve_device(device))

    def _conv_same(self, x):
        """Depthwise correlation with the kernel, 'SAME' padding."""
        c = x.shape[-1]
        ks = self.kernel_size
        lo = (ks - 1) // 2
        w = self.conv_weight.to(x.dtype)[None, None].expand(c, 1, ks, ks)
        xp = F.pad(x.permute(0, 3, 1, 2), (lo, ks - 1 - lo, lo, ks - 1 - lo))
        y = F.conv2d(xp, w.contiguous(), groups=c)
        return y.permute(0, 2, 3, 1).contiguous()

    def H(self, x):
        if self.mode != "fft":
            return self._conv_same(x)
        return _fft_apply(x, self.fft_filter)

    def H_adj(self, x):
        if self.mode != "fft":
            return self._conv_same(x)
        return _fft_apply(x, self.fft_filter.conj())


class Superresolution(Degradation):
    """``sf``-fold decimation with a zero-fill adjoint; ``mode="bicubic"``
    puts a circular bicubic anti-aliasing filter before the decimation."""

    def __init__(self, sf: int, dim_image: int, mode: str | None = None,
                 device=None):
        self.sf = sf
        self.mode = mode
        self.dim_image = dim_image
        dev = resolve_device(device)
        if mode == "bicubic":
            self.fft_filter = _fft_filter(bicubic_filter(sf), dim_image, dev)

    def downsample(self, x):
        return x[:, ::self.sf, ::self.sf, :]

    def upsample(self, x):
        b, h, w, c = x.shape
        z = x.new_zeros((b, h * self.sf, w * self.sf, c))
        z[:, ::self.sf, ::self.sf, :] = x
        return z

    def H(self, x):
        if self.mode is None:
            return self.downsample(x)
        return self.downsample(_fft_apply(x, self.fft_filter))

    def H_adj(self, x):
        if self.mode is None:
            return self.upsample(x)
        return _fft_apply(self.upsample(x), self.fft_filter.conj())

    # closed forms for plain decimation D: diag(D D^T) = 1 and diag(D^T D)
    # is the keep-pixel mask
    def diag_HHt(self) -> float:
        return 1.0

    def keep_mask(self) -> np.ndarray:
        m = np.zeros((1, self.dim_image, self.dim_image, 1), dtype=np.float32)
        m[:, ::self.sf, ::self.sf, :] = 1.0
        return m


def degradation_on(deg: Degradation, device, rows=None) -> Degradation:
    """A copy of ``deg`` with its tensors on ``device``; a per-image mask
    (one row an image) keeps only ``rows`` (start, stop): the operator of
    a shard of the batch on another device."""
    out = copy.copy(deg)
    for k, v in vars(deg).items():
        if isinstance(v, torch.Tensor):
            setattr(out, k, v.to(device))
    if rows is not None and isinstance(deg, MaskedInpainting) \
            and deg.mask.shape[0] > 1:
        out.mask = out.mask[rows[0]:rows[1]]
    return out


def make_degradation(args, batch_size: int | None = None, device=None):
    """Build (degradation, sigma_noise) for ``args.problem`` with the
    reference CLI's per-problem noise defaults."""
    problem = args.problem
    dim = args.dim_image
    if problem in ("paintbrush_inpainting", "random_inpainting"):
        bs = batch_size if batch_size is not None else args.batch_size_ip

    def sigma(gauss):
        return 0.3 if args.noise_type == "laplace" else gauss

    if problem == "denoising":
        resolve_device(device)
        return Denoising(), sigma(0.2)
    if problem == "inpainting":
        half = 20 if dim == 128 else 40
        return BoxInpainting(half, dim, device), sigma(0.05)
    if problem == "paintbrush_inpainting":
        return PaintbrushInpainting(dim, bs, device), sigma(0.05)
    if problem == "random_inpainting":
        return RandomInpainting(0.7, dim, bs, device), sigma(0.01)
    if problem in ("superresolution", "superresolution_bicubic"):
        sf = 2 if dim == 128 else 4
        mode = "bicubic" if problem == "superresolution_bicubic" else None
        return Superresolution(sf, dim, mode=mode, device=device), sigma(0.05)
    if problem == "gaussian_deblurring_FFT":
        sigma_blur = 1.0 if dim == 128 else 3.0
        return (
            GaussianDeblurring(sigma_blur, 61, args.num_channels, dim,
                               device=device),
            sigma(0.05),
        )
    raise ValueError("Unknown problem: {}".format(problem))
