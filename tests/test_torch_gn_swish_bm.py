"""The port's two-phase GroupNorm+swish (``fused_norm "bm"``) against the
JAX batch-minor Pallas kernel, run in interpret mode as the JAX package's
own tests run it, and its backward against JAX's.

Bounds: forward rtol/atol 2e-5, the bound the JAX package holds its bm
kernel to against flax (float32 moments over at most 8*8*3 values per
group); gradients 2e-4, the JAX package's bound for the shared backward.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.ops.pallas_kernels import (
    _gn_swish_bm_pallas, groupnorm_swish_bm as jax_gn_bm)
from pnpflow_tpu_torch.ops.gn_swish import gn_swish_reference
from pnpflow_tpu_torch.ops.gn_swish_bm import (
    groupnorm_swish_bm, groupnorm_swish_bm_fwd)


def _jax_bm(x, scale, bias, groups, swish):
    """The JAX bm kernel in interpret mode on the (HW, C, N) view, back in
    NHWC."""
    b, h, w, c = x.shape
    xt = jnp.transpose(jnp.asarray(x), (1, 2, 3, 0)).reshape(h * w, c, b)
    yt = _gn_swish_bm_pallas(xt, jnp.asarray(scale), jnp.asarray(bias),
                             groups, 1e-6, swish, True)
    return np.asarray(jnp.transpose(yt.reshape(h, w, c, b), (3, 0, 1, 2)))


def _inputs(n, hw, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, hw, hw, c)).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("c,groups,swish", [
    (32, 32, True), (64, 32, False), (48, 16, True), (96, 32, True)])
def test_reference_matches_jax_bm_kernel(c, groups, swish):
    x, scale, bias = _inputs(6, 8, c, 3)
    got = groupnorm_swish_bm_fwd(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        groups, 1e-6, swish).numpy()
    np.testing.assert_allclose(got, _jax_bm(x, scale, bias, groups, swish),
                               rtol=2e-5, atol=2e-5)


def test_cpu_path_matches_jax_bm_kernel_off_centre():
    """Inputs with mean 1 and std 3, where E[x^2] - E[x]^2 cancels most."""
    x, scale, bias = _inputs(3, 16, 96, 4)
    x = x * 3 + 1
    got = groupnorm_swish_bm_fwd(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, _jax_bm(x, scale, bias, 32, True),
                               rtol=2e-5, atol=2e-5)


def test_cpu_takes_the_plain_version_without_a_launch():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(2, 8, 64, 5))
    before = groupnorm_swish_bm_fwd.launches
    got = groupnorm_swish_bm_fwd(x, scale, bias)
    assert groupnorm_swish_bm_fwd.launches == before
    assert torch.equal(got, gn_swish_reference(x, scale, bias))
    with pytest.raises(ValueError, match="groups"):
        groupnorm_swish_bm_fwd(x[..., :40], scale[:40], bias[:40])


def test_backward_matches_jax_vjp():
    x, scale, bias = _inputs(2, 8, 64, 6)

    def jloss(args):
        return jnp.sum(jnp.sin(jax_gn_bm(*args, 32, 1e-6, True)))

    want = jax.grad(jloss)(tuple(jnp.asarray(a) for a in (x, scale, bias)))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_() for a in
                  (x, scale, bias))
    torch.sin(groupnorm_swish_bm(tx, ts, tb, 32, 1e-6, True)).sum().backward()
    for got, w in zip((tx.grad, ts.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
