"""The port's degradation operators against the JAX ones.

Bound: atol 1e-5 (complex64 FFTs of the same numpy filter, or the same
float32 convolution or mask product); the adjoint identity
<Hx, y> = <x, H_adj y> to 1e-4 relative; masks byte-identical.
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.ops import degradations as jdeg
from pnpflow_tpu_torch.ops import degradations as tdeg
from pnpflow_tpu_torch.utils.config import CfgNode


@pytest.mark.parametrize("sigma,ks,dim", [(1.0, 9, 32), (3.0, 61, 64)])
def test_fft_deblur_matches_jax(sigma, ks, dim):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, dim, dim, 3)).astype(np.float32)
    jop = jdeg.GaussianDeblurring(sigma, ks, "fft", 3, dim)
    top = tdeg.GaussianDeblurring(sigma, ks, 3, dim, device="cpu")
    np.testing.assert_array_equal(top.kernel, jop.kernel)
    for name in ("H", "H_adj"):
        got = getattr(top, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jop, name)(jnp.asarray(x)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fft_deblur_adjoint_identity():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    op = tdeg.GaussianDeblurring(3.0, 61, 3, 64, device="cpu")
    lhs = float((op.H(x).double() * y.double()).sum())
    rhs = float((x.double() * op.H_adj(y).double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_make_degradation_defaults():
    args = CfgNode(dict(problem="gaussian_deblurring_FFT", dim_image=64,
                        num_channels=3, noise_type="gaussian",
                        batch_size_ip=4))
    op, sigma = tdeg.make_degradation(args, device="cpu")
    jop, jsigma = jdeg.make_degradation(args)
    assert sigma == jsigma == 0.05
    assert op.sigma == jop.sigma and op.kernel_size == jop.kernel_size
    args.problem = "denoising"
    op, sigma = tdeg.make_degradation(args, device="cpu")
    assert isinstance(op, tdeg.Denoising) and sigma == 0.2
    args.problem = "superresolution"
    op, sigma = tdeg.make_degradation(args, device="cpu")
    assert isinstance(op, tdeg.Superresolution) and op.sf == 4
    assert sigma == 0.05
    args.problem = "colorization"
    with pytest.raises(ValueError, match="Unknown problem"):
        tdeg.make_degradation(args, device="cpu")


PROBLEMS = ["denoising", "inpainting", "paintbrush_inpainting",
            "random_inpainting", "superresolution", "superresolution_bicubic",
            "gaussian_deblurring_FFT"]


def _pair(problem, dim, noise_type="gaussian", bs=2):
    args = CfgNode(dict(problem=problem, dim_image=dim, num_channels=3,
                        noise_type=noise_type, batch_size_ip=bs))
    return (tdeg.make_degradation(args, device="cpu"),
            jdeg.make_degradation(args))


@pytest.mark.parametrize("noise_type", ["gaussian", "laplace"])
@pytest.mark.parametrize("dim", [64, 128])
def test_make_degradation_sigma_defaults_match_jax(noise_type, dim):
    for problem in PROBLEMS:
        (top, sigma), (jop, jsigma) = _pair(problem, dim, noise_type)
        assert sigma == jsigma, problem
        assert type(top).__name__ == type(jop).__name__, problem


@pytest.mark.parametrize("problem", PROBLEMS)
def test_every_degradation_matches_jax(problem):
    (top, _), (jop, _) = _pair(problem, 64)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    hx = top.H(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(hx, np.asarray(jop.H(jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    y = rng.normal(size=hx.shape).astype(np.float32)
    got = top.H_adj(torch.from_numpy(y)).numpy()
    want = np.asarray(jop.H_adj(jnp.asarray(y)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    lhs = float((hx.astype(np.float64) * y).sum())
    rhs = float((x.astype(np.float64) * got).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("problem", ["inpainting", "random_inpainting",
                                     "paintbrush_inpainting"])
def test_masks_are_byte_identical_to_jax(problem):
    (top, _), (jop, _) = _pair(problem, 128, bs=3)
    assert top.mask.numpy().tobytes() == np.asarray(jop.mask).tobytes()


def test_random_mask_leaves_global_numpy_state_alone():
    np.random.seed(7)
    want = np.random.random()
    np.random.seed(7)
    tdeg.RandomInpainting(0.7, 64, 2, device="cpu")
    assert np.random.random() == want


def test_paintbrush_fallback_without_opencv(monkeypatch):
    """Where OpenCV is missing, both packages rasterize the lines
    themselves, and still agree byte for byte."""
    with_cv2 = tdeg._paintbrush_masks(64, 64, 2)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tdeg._paintbrush_masks(64, 64, 2)
    want = jdeg._paintbrush_masks(64, 64, 2)
    assert got.tobytes() == want.tobytes()
    assert 0.0 < got.mean() < 1.0
    assert np.abs(got - with_cv2).mean() < 0.05


def test_bicubic_filter_and_closed_forms_match_jax():
    np.testing.assert_array_equal(tdeg.bicubic_filter(4),
                                  jdeg.bicubic_filter(4))
    top = tdeg.Superresolution(4, 64, device="cpu")
    jop = jdeg.Superresolution(4, 64)
    assert top.diag_HHt() == jop.diag_HHt() == 1.0
    np.testing.assert_array_equal(top.keep_mask(), jop.keep_mask())


@pytest.mark.parametrize("ks", [9, 8])
def test_conv_mode_deblur_matches_jax(ks):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    top = tdeg.GaussianDeblurring(1.5, ks, 3, 32, device="cpu", mode="conv")
    jop = jdeg.GaussianDeblurring(1.5, ks, "conv", 3, 32)
    for name in ("H", "H_adj"):
        got = getattr(top, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jop, name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
