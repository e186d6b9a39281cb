"""The port's FFT deblur and denoising operators against the JAX ones.

Bound: atol 1e-5 (both run complex64 FFTs of the same numpy filter); the
adjoint identity <Hx, y> = <x, H_adj y> to 1e-4 relative.
"""

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdeg.make_degradation(args, device="cpu")
