"""The port's GroupNorm+swish (plain version, as CPU tensors take it)
against the JAX Pallas kernel in interpret mode and against flax GroupNorm,
and its autograd backward against ``jax.grad`` of ``groupnorm_swish``.

Bounds: forward rtol/atol 2e-5 and VJP 2e-4, as the JAX package's own
kernel tests hold them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.ops.pallas_kernels import (
    _gn_swish_fwd_pallas, groupnorm_swish as jax_groupnorm_swish)
from pnpflow_tpu_torch.ops.gn_swish import (
    gn_swish_reference, groupnorm_swish, groupnorm_swish_fwd)


def _flax_gn_swish(x, scale, bias, groups=32, eps=1e-6, swish=True):
    import flax.linen as nn

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.GroupNorm(num_groups=groups, epsilon=eps, name="g")(x)

    y = M().apply({"params": {"g": {"scale": scale, "bias": bias}}}, x)
    return y * jax.nn.sigmoid(y) if swish else y


def _inputs(seed, n, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8, 8, c)).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("c,groups,swish", [
    (32, 32, True), (64, 32, True), (128, 32, False), (256, 32, True),
    (48, 16, True), (96, 32, True),
])
def test_forward_matches_pallas_interpret_and_flax(c, groups, swish):
    x, scale, bias = _inputs(0, 4, c)
    got = groupnorm_swish_fwd(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), groups, 1e-6,
                              swish).numpy()
    pallas = _gn_swish_fwd_pallas(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), groups, 1e-6, swish,
                                  True)
    flax_ref = _flax_gn_swish(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), groups, 1e-6, swish)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(flax_ref), rtol=2e-5,
                               atol=2e-5)


def test_bf16_input_keeps_dtype():
    x, scale, bias = _inputs(2, 2, 64)
    xb = torch.from_numpy(x).bfloat16()
    y = gn_swish_reference(xb, torch.from_numpy(scale),
                           torch.from_numpy(bias))
    assert y.dtype == torch.bfloat16
    want = gn_swish_reference(xb.float(), torch.from_numpy(scale),
                              torch.from_numpy(bias))
    assert float((y.float() - want).abs().max()) < 5e-2


@pytest.mark.parametrize("swish", [True, False])
def test_vjp_matches_jax_grad(swish):
    x, scale, bias = _inputs(1, 2, 64)

    def loss_jax(args):
        return jnp.sum(jnp.sin(jax_groupnorm_swish(*args, 32, 1e-6, swish)))

    want = jax.grad(loss_jax)(tuple(map(jnp.asarray, (x, scale, bias))))

    tx, ts, tb = (torch.from_numpy(a).requires_grad_() for a in
                  (x, scale, bias))
    torch.sin(groupnorm_swish(tx, ts, tb, 32, 1e-6, swish)).sum().backward()
    for got, ref in zip((tx.grad, ts.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-4)


def test_cpu_path_does_not_count_launches():
    x, scale, bias = _inputs(3, 1, 32)
    before = groupnorm_swish_fwd.launches
    groupnorm_swish_fwd(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    assert groupnorm_swish_fwd.launches == before


def test_rejects_channels_not_divisible_by_groups():
    x = torch.zeros(1, 4, 4, 40)
    with pytest.raises(ValueError):
        groupnorm_swish_fwd(x, torch.ones(40), torch.zeros(40))
