"""The port's fused conv3x3+GN (plain version, as CPU tensors take it)
against the JAX Pallas kernel in interpret mode, and its helpers against
the JAX helpers.

Bounds: y max-abs < 1e-4 and moments < 5e-2 at float32 (the JAX package's
kernel-vs-XLA bounds); at bf16, y < 5e-2 and moments < 1.0 (the JAX bf16
test's bounds: moments sum 64 bf16-rounded values); helpers 1e-5.

Also the wrapper's host logic, which runs here as it runs on the card: its
argument checks, and the launch plan over every flagship site.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.ops import fused_conv_gn as jfc
from pnpflow_tpu_torch.models import unet as unet_mod
from pnpflow_tpu_torch.ops import fused_conv_gn as pfc
from pnpflow_tpu_torch.ops.fused_conv_gn import (
    SMS, channel_moments, concat_moments, conv3x3_gn, gn_prologue,
    launch_plan)

N, H, W = 2, 8, 8


def _case(seed, c, co, prologue, sample_bias, residual):
    rng = np.random.default_rng(seed)
    arrs = {
        "x": rng.normal(size=(N, H, W, c)),
        "w": rng.normal(size=(3, 3, c, co)) / np.sqrt(9 * c),
        "b": rng.normal(size=(co,)) * 0.1,
    }
    if prologue:
        arrs["a"] = rng.normal(size=(N, c)) * 0.3 + 1.0
        arrs["pb"] = rng.normal(size=(N, c)) * 0.5
    if sample_bias:
        arrs["sb"] = rng.normal(size=(N, co))
    if residual:
        arrs["res"] = rng.normal(size=(N, H, W, co))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _run(mod, arrs, to, dtype):
    kw = {}
    if "a" in arrs:
        kw["prologue"] = (to(arrs["a"]), to(arrs["pb"]))
    if "sb" in arrs:
        kw["sample_bias"] = to(arrs["sb"])
    if "res" in arrs:
        kw["residual"] = to(arrs["res"]).astype(dtype) if to is jnp.asarray \
            else to(arrs["res"]).to(dtype)
    x, w = to(arrs["x"]), to(arrs["w"])
    if to is jnp.asarray:
        return mod.conv3x3_gn(x.astype(dtype), w.astype(dtype), to(arrs["b"]),
                              interpret=True, **kw)
    return mod(x.to(dtype), w.to(dtype), to(arrs["b"]), **kw)


FLAG_SETS = list(itertools.product([False, True], repeat=3))


@pytest.mark.parametrize("c,co", [(3, 32), (32, 32), (32, 64), (96, 64)])
@pytest.mark.parametrize("prologue,sample_bias,residual", FLAG_SETS)
def test_matches_pallas_interpret_f32(c, co, prologue, sample_bias,
                                      residual):
    arrs = _case(0, c, co, prologue, sample_bias, residual)
    y1, m1 = _run(conv3x3_gn, arrs, torch.from_numpy, torch.float32)
    y2, m2 = _run(jfc, arrs, jnp.asarray, jnp.float32)
    assert y1.shape == (N, H, W, co) and m1.shape == (N, 2, co)
    assert np.abs(y1.numpy() - np.asarray(y2)).max() < 1e-4
    assert np.abs(m1.numpy() - np.asarray(m2)).max() < 5e-2


@pytest.mark.parametrize("prologue", [False, True])
def test_matches_pallas_interpret_bf16(prologue):
    arrs = _case(1, 32, 32, prologue, True, True)
    y1, m1 = _run(conv3x3_gn, arrs, torch.from_numpy, torch.bfloat16)
    y2, m2 = _run(jfc, arrs, jnp.asarray, jnp.bfloat16)
    assert y1.dtype == torch.bfloat16
    d = np.abs(y1.float().numpy() - np.asarray(y2.astype(jnp.float32)))
    assert d.max() < 5e-2
    assert np.abs(m1.numpy() - np.asarray(m2)).max() < 1.0


def test_halo_is_zero_after_the_prologue():
    """A constant input with b' != 0: border outputs see fewer taps, so a
    halo padded *before* the prologue (swish(b') at the border) differs."""
    x = torch.zeros(1, 4, 4, 32)
    w = torch.ones(3, 3, 32, 32)
    a = torch.ones(1, 32)
    pb = torch.full((1, 32), 2.0)
    y, _ = conv3x3_gn(x, w, torch.zeros(32), prologue=(a, pb))
    s = 2.0 * torch.sigmoid(torch.tensor(2.0)) * 32
    assert torch.allclose(y[0, 0, 0], 4 * s)     # corner: 4 taps in image
    assert torch.allclose(y[0, 1, 1], 9 * s)     # interior: all 9 taps


def test_no_moments_when_not_asked():
    arrs = _case(2, 32, 32, False, False, False)
    y, m = conv3x3_gn(torch.from_numpy(arrs["x"]), torch.from_numpy(arrs["w"]),
                      torch.from_numpy(arrs["b"]), emit_moments=False)
    assert m is None and y.shape == (N, H, W, 32)


def test_helpers_match_jax():
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    v = rng.normal(size=(2, 8, 8, 96)).astype(np.float32)
    scale = rng.normal(size=(128,)).astype(np.float32)
    bias = rng.normal(size=(128,)).astype(np.float32)

    mu = channel_moments(torch.from_numpy(u))
    mv = channel_moments(torch.from_numpy(v))
    np.testing.assert_allclose(
        mu.numpy(), np.asarray(jfc.channel_moments(jnp.asarray(u))),
        rtol=1e-5, atol=1e-5)
    m = concat_moments(mu, mv)
    mj = jfc.concat_moments(jfc.channel_moments(jnp.asarray(u)),
                            jfc.channel_moments(jnp.asarray(v)))
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-5)
    a, b = gn_prologue(m, 64, torch.from_numpy(scale), torch.from_numpy(bias))
    aj, bj = jfc.gn_prologue(mj, 64, jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-5,
                               atol=1e-5)


def test_cpu_path_does_not_count_launches():
    arrs = _case(4, 32, 32, True, False, False)
    before = conv3x3_gn.launches
    _run(conv3x3_gn, arrs, torch.from_numpy, torch.float32)
    assert conv3x3_gn.launches == before


def _args(n=2, h=8, c=32, co=32, dtype=torch.float32):
    x = torch.randn(n, h, h, c).to(dtype)
    w = torch.randn(3, 3, c, co).to(dtype)
    return x, w, torch.zeros(co)


BAD_ARGS = {
    "x not contiguous": (lambda x, w, b: ((x.permute(0, 2, 1, 3), w, b), {}),
                         ValueError),
    "w dtype": (lambda x, w, b: ((x, w.double(), b), {}), ValueError),
    "w shape": (lambda x, w, b: ((x, w[:, :, :16], b), {}), ValueError),
    "b dtype": (lambda x, w, b: ((x, w, b.double()), {}), ValueError),
    "fp16": (lambda x, w, b: ((x.half(), w.half(), b), {}), TypeError),
    "x not NHWC": (lambda x, w, b: ((x[0], w, b), {}), ValueError),
    "prologue shape": (lambda x, w, b: (
        (x, w, b), {"prologue": (torch.ones(2, 16), torch.ones(2, 16))}),
        ValueError),
    "sample_bias dtype": (lambda x, w, b: (
        (x, w, b), {"sample_bias": torch.ones(2, 32).double()}), ValueError),
    "residual not contiguous": (lambda x, w, b: (
        (x, w, b), {"residual": torch.ones(2, 8, 8, 32).transpose(1, 2)}),
        ValueError),
    "CO not a multiple of 32": (lambda x, w, b: (
        (x, w[..., :16].contiguous(), b[:16]), {}), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_checks_arguments_on_the_cpu_as_the_card_would(case):
    """A CPU run refuses what the kernel would refuse, before it takes the
    plain version."""
    make, err = BAD_ARGS[case]
    args, kw = make(*_args())
    with pytest.raises(err):
        conv3x3_gn(*args, **kw)


@pytest.fixture(scope="module")
def flagship_sites():
    """(h, w, cin, cout) of the 109 conv3x3_gn calls of one flagship U-Net
    forward (64x64, ch 32, mult 1,2,4,8, 6 blocks, attention at 16 and 8),
    recorded from a batch-1 CPU forward."""
    sites = []
    real = unet_mod.conv3x3_gn

    def record(x, w, b, **kw):
        sites.append((x.shape[1], x.shape[2], x.shape[3], w.shape[3]))
        return real(x, w, b, **kw)

    m = unet_mod.VelocityUNet(input_height=64, fused_norm="conv").eval()
    unet_mod.conv3x3_gn = record
    try:
        with torch.inference_mode():
            m(torch.zeros(1, 64, 64, 3), torch.zeros(1))
    finally:
        unet_mod.conv3x3_gn = real
    assert len(sites) == 109
    return sites


@pytest.mark.parametrize("n", [20, 320])
def test_launch_plan_covers_each_output_once_within_one_sample(
        flagship_sites, n):
    for h, w, _, co in sorted(set(flagship_sites)):
        plan = launch_plan(n, h, w, co)
        bid = np.arange(plan.blocks(n, co))
        s, y0, x0, co0 = plan.tile(bid, co)
        m = np.arange(plan.bm)
        yy = y0[:, None] + m // plan.tw
        xx = x0[:, None] + m % plan.tw
        inside = (yy < h) & (xx < w)
        # a tile starts inside its sample, and its pixels are the sample's
        assert (s < n).all() and (y0 < h).all() and (x0 < w).all()
        flat = (s[:, None] * h + yy) * w + xx
        assert (flat[inside] // (h * w) == np.broadcast_to(
            s[:, None], yy.shape)[inside]).all()
        counts = np.zeros((n, h, w, co // plan.bn), np.int32)
        np.add.at(counts, (np.broadcast_to(s[:, None], yy.shape)[inside],
                           yy[inside], xx[inside],
                           np.broadcast_to((co0 // plan.bn)[:, None],
                                           yy.shape)[inside]), 1)
        assert (counts == 1).all(), (h, w, co, plan)


@pytest.mark.parametrize("n", [20, 320])
def test_launch_plan_fills_the_card(flagship_sites, n):
    """Every site gets at least one block per SM wherever it has that many
    64-pixel x 32-channel tiles."""
    for h, w, _, co in set(flagship_sites):
        plan = launch_plan(n, h, w, co)
        small_tiles = n * -(-h * w // 64) * (co // 32)
        assert plan.blocks(n, co) >= min(SMS, small_tiles), (h, w, co, plan)
        assert (plan.bm, plan.bn) in pfc.TILES and co % plan.bn == 0
        assert plan.bm % plan.tw == 0 and plan.tw <= w


@pytest.mark.parametrize("h,w", [(7, 7), (5, 96), (64, 200), (1, 1)])
def test_launch_plan_covers_ragged_images(h, w):
    n, co = 3, 64
    plan = launch_plan(n, h, w, co)
    s, y0, x0, _ = plan.tile(np.arange(plan.blocks(n, co)), co)
    m = np.arange(plan.bm)
    yy, xx = y0[:, None] + m // plan.tw, x0[:, None] + m % plan.tw
    inside = (yy < h) & (xx < w)
    flat = ((s[:, None] * h + yy) * w + xx)[inside]
    assert np.bincount(flat, minlength=n * h * w).tolist() == \
        [co // plan.bn] * (n * h * w)
