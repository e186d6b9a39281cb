"""The port's plain upfirdn2d and FIR resampling helpers against the JAX
ones: ``upfirdn2d_xla`` and the Pallas ``upfirdn2d_pallas`` run in interpret
mode, on the same numpy inputs.

Bounds: atol 1e-5 (at most 16 float32 products of O(1) values per output,
summed in another order), 1e-4 at 192 channels as the JAX package's own
wide-channel test holds its kernel; the conv-fused helpers atol 1e-4 (a
3x3 conv over up to 16 channels before the FIR).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.ops import upfirdn as jup
from pnpflow_tpu.ops.pallas_kernels import upfirdn2d_pallas
from pnpflow_tpu_torch.ops import upfirdn as tup

TAPS = [1, 3, 3, 1]


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("up,down,pad", [
    (1, 1, (1, 1)), (2, 1, (3, 1)), (1, 2, (1, 1)), (2, 2, (2, 2)),
    (1, 1, (0, 0))])
def test_upfirdn2d_matches_xla_and_pallas(up, down, pad):
    x = _x((2, 8, 8, 4), 0)
    k = tup.setup_kernel(TAPS)
    np.testing.assert_array_equal(k, jup.setup_kernel(TAPS))
    got = tup.upfirdn2d(torch.from_numpy(x), k, up=up, down=down,
                        pad=pad).numpy()
    xla = np.asarray(jup.upfirdn2d_xla(jnp.asarray(x), k, up=up, down=down,
                                       pad=pad))
    pallas = np.asarray(upfirdn2d_pallas(jnp.asarray(x), k, up=up, down=down,
                                         pad=pad, interpret=True))
    assert got.shape == xla.shape == pallas.shape
    assert np.abs(got - xla).max() < 1e-5
    assert np.abs(got - pallas).max() < 1e-5


def test_upfirdn2d_wide_channels():
    x = _x((1, 16, 16, 192), 1)
    k = tup.setup_kernel(TAPS)
    got = tup.upfirdn2d(torch.from_numpy(x), k, down=2, pad=(1, 1)).numpy()
    want = np.asarray(upfirdn2d_pallas(jnp.asarray(x), k, down=2, pad=(1, 1),
                                       interpret=True))
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("up,down,pad,taps", [
    (2, 2, (3, 2), [1, 2, 1]), (1, 1, (2, 2), [1, 4, 6, 4, 1]),
    (2, 1, (0, 5), [1, 1, 2, 2, 1, 1])])
def test_upfirdn2d_other_taps_and_odd_pads(up, down, pad, taps):
    x = _x((2, 7, 7, 3), 2)
    k = tup.setup_kernel(taps)
    got = tup.upfirdn2d(torch.from_numpy(x), k, up=up, down=down,
                        pad=pad).numpy()
    want = np.asarray(jup.upfirdn2d_xla(jnp.asarray(x), k, up=up, down=down,
                                        pad=pad))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


def test_upfirdn2d_true_convolution_not_correlation():
    """An asymmetric 2-D kernel: a flip error would show."""
    x = _x((1, 6, 6, 2), 3)
    k = np.arange(1, 17, dtype=np.float32).reshape(4, 4)
    k /= k.sum()
    got = tup.upfirdn2d(torch.from_numpy(x), k, pad=(2, 1)).numpy()
    want = np.asarray(jup.upfirdn2d_xla(jnp.asarray(x), k, pad=(2, 1)))
    assert np.abs(got - want).max() < 1e-5
    wrong = tup.upfirdn2d(torch.from_numpy(x), k[::-1, ::-1].copy(),
                          pad=(2, 1)).numpy()
    assert np.abs(wrong - want).max() > 1e-2


@pytest.mark.parametrize("fn", ["upsample_2d", "downsample_2d"])
@pytest.mark.parametrize("factor", [2, 4])
def test_resample_helpers_match_jax(fn, factor):
    x = _x((2, 16, 16, 5), 4)
    got = getattr(tup, fn)(torch.from_numpy(x), TAPS, factor=factor).numpy()
    want = np.asarray(getattr(jup, fn)(jnp.asarray(x), TAPS, factor=factor))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("fn", ["upsample_conv_2d", "conv_downsample_2d"])
def test_conv_fused_resample_matches_jax(fn):
    x = _x((2, 8, 8, 16), 5)
    w_hwio = _x((3, 3, 16, 6), 6) / 12.0
    w_oihw = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0,
                                                                     1)))
    got = getattr(tup, fn)(torch.from_numpy(x), w_oihw, k=TAPS).numpy()
    want = np.asarray(getattr(jup, fn)(jnp.asarray(x), w_hwio, k=TAPS))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("fn", ["naive_upsample_2d", "naive_downsample_2d"])
def test_naive_resample_matches_jax(fn):
    x = _x((2, 8, 8, 3), 7)
    got = getattr(tup, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jup, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cpu_takes_the_plain_version_without_a_launch():
    x = torch.from_numpy(_x((1, 8, 8, 4), 8))
    k = tup.setup_kernel(TAPS)
    before = tup.upfirdn2d.launches
    got = tup.upfirdn2d(x, k, down=2, pad=(1, 1))
    assert tup.upfirdn2d.launches == before
    assert torch.equal(got, tup.upfirdn2d_reference(x, k, down=2,
                                                    pad=(1, 1)))


def test_upfirdn2d_refuses_what_the_kernel_cannot_take():
    x = torch.from_numpy(_x((1, 8, 8, 4), 9))
    k = tup.setup_kernel(TAPS)
    with pytest.raises(NotImplementedError, match="negative"):
        tup.upfirdn2d(x, k, pad=(-1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        tup.upfirdn2d(x.permute(0, 2, 1, 3), k, pad=(2, 1))
    with pytest.raises(ValueError, match="exceeds"):
        tup.upfirdn2d(x, tup.setup_kernel([1] * 9), pad=(4, 4))
    with pytest.raises(TypeError):
        tup.upfirdn2d(x.double(), k, pad=(2, 1))
