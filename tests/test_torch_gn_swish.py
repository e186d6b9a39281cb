"""The port's GroupNorm+swish (plain version, as CPU tensors take it)
against the JAX Pallas kernel in interpret mode and against flax GroupNorm,
its autograd backward against ``jax.grad`` of ``groupnorm_swish``, the
kernel's launch plan over every site of the flagship U-Net, the argument
checks both entries make on every device, and the variance clamp in which
the port departs from JAX's ``groupnorm_swish`` on purpose.

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
    CLUSTER_MAX, FILL_MAX, SMEM_MAX, SMS, TILES_MAX, gn_plan,
    gn_swish_reference, groupnorm_swish, groupnorm_swish_fwd)
from pnpflow_tpu_torch.ops.gn_swish_bm import groupnorm_swish_bm_fwd

ENTRIES = {"groupnorm_swish": groupnorm_swish_fwd,
           "groupnorm_swish_bm": groupnorm_swish_bm_fwd}


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


# (H = W, C) of every GroupNorm site of the flagship U-Net (64x64, ch 32,
# mult 1,2,4,8, 6 blocks, attention at 16 and 8), of the U-Net at 128x128,
# and ragged shapes: 7x7 and 5x96 split unevenly, 1x1 has one row
FLAGSHIP_SITES = [(8, 128), (8, 256), (8, 384), (8, 512), (16, 64),
                  (16, 128), (16, 192), (16, 256), (16, 384), (32, 32),
                  (32, 64), (32, 96), (32, 128), (32, 192), (64, 32),
                  (64, 64), (64, 96)]
PLAN_CASES = ([(n, h * h, c) for n in (20, 320) for h, c in FLAGSHIP_SITES]
              + [(n, 128 * 128, c) for n in (4, 20) for c in (32, 64, 96)]
              + [(n, hw, c) for n in (1, 20) for hw, c in
                 ((49, 32), (5 * 96, 64), (1, 64), (49, 96))])


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,hw,c", PLAN_CASES)
def test_plan_covers_every_row_once_and_fills_the_card(n, hw, c, itemsize):
    plan = gn_plan(n, hw, c, 32, itemsize)
    # every pixel row of a sample in exactly one block, in order
    assert len(plan.rows) == plan.k
    assert plan.rows[0][0] == 0 and plan.rows[-1][1] == hw
    assert all(a[1] == b[0] for a, b in zip(plan.rows, plan.rows[1:]))
    assert all(0 < e - f for f, e in plan.rows)
    assert plan.k & (plan.k - 1) == 0 and plan.k <= hw
    assert plan.threads % (c // plan.v) == 0 and plan.threads <= 1024
    assert 0 < plan.smem <= SMEM_MAX
    whole_vectors = (c * itemsize) % 16 == 0
    assert plan.v == (16 // itemsize if whole_vectors else 1)
    rows = max(e - f for f, e in plan.rows)
    if plan.path == "cluster":
        assert plan.k <= CLUSTER_MAX
        # the block's share of the sample fits its shared memory
        assert rows * c * itemsize < plan.smem
        if n * plan.k < SMS:
            assert plan.k >= FILL_MAX or 2 * plan.k > hw
    else:
        assert plan.path == "two_phase" and plan.k <= TILES_MAX
        if n * plan.k < 2 * SMS:
            assert plan.k == TILES_MAX or 2 * plan.k > hw
    # the path: a cluster wherever 16 blocks of 227 KB hold the sample
    fits = whole_vectors and hw * c * itemsize <= CLUSTER_MAX * (
        SMEM_MAX - 40 * 1024)
    too_big = hw * c * itemsize > CLUSTER_MAX * SMEM_MAX
    if fits:
        assert plan.path == "cluster"
    if too_big or not whole_vectors:
        assert plan.path == "two_phase"


def test_plan_takes_the_two_phase_path_where_no_cluster_holds_a_sample():
    assert gn_plan(4, 128 * 128, 96, 32, 4).path == "two_phase"
    assert gn_plan(4, 128 * 128, 96, 32, 2).path == "cluster"
    assert gn_plan(4, 64, 36, 4, 2).path == "two_phase"     # 72-byte rows
    assert gn_plan(4, 64, 36, 4, 2).v == 1
    with pytest.raises(ValueError, match="wider than a block"):
        gn_plan(1, 4, 8192, 32, 4)                         # 2048 vectors


def _bad_args():
    x = torch.zeros(2, 4, 4, 64)
    s, b = torch.ones(64), torch.zeros(64)
    return [
        ((x[0], s, b), ValueError),                                # ndim
        ((x[..., :40], s[:40], b[:40]), ValueError),               # C % G
        ((x, s[:32], b), ValueError),                              # shape
        ((x.half(), s, b), TypeError),                             # fp16
        ((x.double(), s, b), TypeError),                           # fp64
        ((x.permute(0, 2, 1, 3), s, b), ValueError),               # strides
        ((x, s.double(), b), ValueError),                          # scale
        ((x, s, b), None),                                         # fine
        ((x, s, torch.zeros(128)[::2]), ValueError),               # strided
    ]


@pytest.mark.parametrize("case", range(len(_bad_args())))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_argument_checks_run_on_the_cpu_too(entry, case):
    args, err = _bad_args()[case]
    if err is None:
        assert ENTRIES[entry](*args).shape == args[0].shape
    else:
        with pytest.raises(err):
            ENTRIES[entry](*args)


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_variance_clamp_departs_from_jax_on_purpose(entry, swish):
    """Groups of a near-constant 1e4: float32 makes E[x^2] - E[x]^2
    negative.  JAX's ``groupnorm_swish`` (and ``_bm``) do not clamp and give
    NaN everywhere; both port entries clamp at 0, as JAX's conv prologue and
    flax's GroupNorm do, and equal flax exactly."""
    from pnpflow_tpu.ops.pallas_kernels import groupnorm_swish_bm as jax_bm

    rng = np.random.default_rng(0)
    x = (1e4 + 1e-4 * rng.normal(size=(2, 8, 8, 64))).astype(np.float32)
    scale = (rng.normal(size=64) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    jx = tuple(map(jnp.asarray, (x, scale, bias)))
    for jax_fn in (jax_groupnorm_swish, jax_bm):
        assert np.isnan(np.asarray(jax_fn(*jx, 32, 1e-6, swish))).all()
    got = ENTRIES[entry](*map(torch.from_numpy, (x, scale, bias)), 32, 1e-6,
                         swish).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        got, np.asarray(_flax_gn_swish(*jx, 32, 1e-6, swish)))
