"""The port's fused conv3x3+GN (plain version, as CPU tensors take it)
against the JAX Pallas kernel in interpret mode, and its helpers against
the JAX helpers.

Bounds: y max-abs < 1e-4 and moments < 5e-2 at float32 (the JAX package's
kernel-vs-XLA bounds); at bf16, y < 5e-2 and moments < 1.0 (the JAX bf16
test's bounds: moments sum 64 bf16-rounded values); helpers 1e-5.

Also the wrapper's host logic, which runs here as it runs on the card: its
argument checks, the launch plan over every flagship site, and the weight
packing the kernel's tensor maps read.
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
    launch_plan, pack_weight)

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
    before, tiles = conv3x3_gn.launches, dict(conv3x3_gn.tiles)
    _run(conv3x3_gn, arrs, torch.from_numpy, torch.float32)
    assert conv3x3_gn.launches == before and conv3x3_gn.tiles == tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_plan_has_a_counted_kernel_function(flagship_sites, dtype):
    """Each tile a plan picks names a kernel function that
    ``conv3x3_gn.tiles`` counts, and a warpgroup split the kernel has; and
    every tile the kernel is built for is picked at some flagship site and
    batch (no kernel function is compiled that no plan launches)."""
    picked = set()
    for n in (4, 20, 128, 320):
        for h, w, _, co in set(flagship_sites):
            plan = launch_plan(n, h, w, co)
            assert pfc.tile_key(dtype, plan.bm, plan.bn) in conv3x3_gn.tiles
            nwg, mw = pfc.WARPGROUPS[plan.bm]
            assert 64 * nwg * mw == plan.bm
            picked.add((plan.bm, plan.bn))
    assert picked == set(pfc.TILES)
    assert len(conv3x3_gn.tiles) == 2 * len(pfc.TILES)


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


def _check_covers_each_output_once(plan, n, h, w, co):
    """Every (sample, row, column, channel tile) inside the data is computed
    by exactly one block; pixels past the data are the kernel's to mask."""
    bid = np.arange(plan.blocks(n, co))
    s, yy, xx = plan.pixels(bid, co)
    co0 = plan.tile(bid, co)[3]
    inside = (s < n) & (yy < h) & (xx < w)
    counts = np.zeros((n, h, w, co // plan.bn), np.int32)
    np.add.at(counts, (s[inside], yy[inside], xx[inside],
                       np.broadcast_to((co0 // plan.bn)[:, None],
                                       s.shape)[inside]), 1)
    assert (counts == 1).all(), (n, h, w, co, plan)
    return s, yy, xx


@pytest.mark.parametrize("n", [20, 320, 133])
def test_launch_plan_covers_each_output_once_within_one_sample(
        flagship_sites, n):
    """Each output exactly once, and a tile's halo never crosses a sample:
    a tile is whole-sample slabs of rows x tw pixels, each slab's pixels
    (and so the 1-pixel halo around them) come from one sample, and each
    64-row wgmma block is 8 rows x 8 columns of one slab.  133 is a batch that tiles of two
    8x8 samples do not divide."""
    for h, w, _, co in sorted(set(flagship_sites)):
        plan = launch_plan(n, h, w, co)
        s, yy, xx = _check_covers_each_output_once(plan, n, h, w, co)
        slab = plan.rows * plan.tw
        assert slab % 64 == 0 and plan.samples * slab == plan.bm
        n0, y0, x0, _ = plan.tile(np.arange(plan.blocks(n, co)), co)
        assert (n0 % plan.samples == 0).all() and (y0 < h).all()
        assert (x0 < w).all()
        for k in range(plan.samples):
            part = slice(k * slab, (k + 1) * slab)
            assert (s[:, part] == (n0 + k)[:, None]).all()
            assert ((yy[:, part] >= y0[:, None])
                    & (yy[:, part] < (y0 + plan.rows)[:, None])).all()
        for part in (s, xx // 8):
            blocks64 = part.reshape(len(part), -1, 64)
            assert (blocks64 == blocks64[:, :, :1]).all()
        rows64 = yy.reshape(len(yy), -1, 8, 8)
        assert (np.diff(rows64[..., 0], axis=-1) == 1).all()


@pytest.mark.parametrize("n", [20, 320])
def test_launch_plan_fills_the_card(flagship_sites, n):
    """Every site gets at least one block per SM wherever it has that many
    64-pixel x 32-channel tiles, and every plan is one of the kernel's
    tiles: 64, 128 or 256 pixels as whole-sample slabs."""
    for h, w, _, co in set(flagship_sites):
        plan = launch_plan(n, h, w, co)
        small_tiles = n * -(-h * w // 64) * (co // 32)
        assert plan.blocks(n, co) >= min(SMS, small_tiles), (h, w, co, plan)
        assert (plan.bm, plan.bn) in pfc.TILES and co % plan.bn == 0
        assert plan.bm in pfc.WARPGROUPS
        assert plan.bm == plan.samples * plan.rows * plan.tw
        assert plan.tw % 8 == 0 and plan.rows % 8 == 0
        assert plan.tw <= max(w, 8) and plan.samples <= 4


def test_launch_plan_spans_samples_where_they_are_small():
    """At the bench batch the 8x8 sites take 128-pixel tiles of two samples
    by 128 channels (the weights stream once per two samples); at 16x16 and
    above a tile is one sample's rows."""
    plan = launch_plan(320, 8, 8, 256)
    assert (plan.bm, plan.bn, plan.samples, plan.rows) == (128, 128, 2, 8)
    for h, co in ((16, 128), (32, 64), (64, 32)):
        assert launch_plan(320, h, h, co).samples == 1


@pytest.mark.parametrize("h,w", [(7, 7), (5, 96), (64, 200), (1, 1)])
def test_launch_plan_covers_ragged_images(h, w):
    n, co = 3, 64
    plan = launch_plan(n, h, w, co)
    _check_covers_each_output_once(plan, n, h, w, co)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 32, 40])
def test_pack_weight_orders_k_as_the_kernel_reads_it(dtype, c):
    """Row o of the packed weights holds w[ky, kx, c, o] at K index
    (chunk * 9 + 3 * ky + kx) * kch + c % kch, zero past C; float32 packs
    TF32 big halves, then the small ones, and big + small is w."""
    co = 64
    w = torch.from_numpy(np.random.default_rng(c).normal(
        size=(3, 3, c, co)).astype(np.float32)).to(dtype)
    packed = pack_weight(w)
    kch = pfc.KBYTES // w.element_size()
    nch = -(-c // kch)
    rows = 2 * co if dtype == torch.float32 else co
    assert packed.shape == (rows, nch * 9 * kch) and packed.dtype == dtype
    got = packed[:co].float()
    if dtype == torch.float32:
        halves = packed.view(torch.int32)
        assert (halves & 0x1FFF).eq(0).all()      # both halves are TF32
        got = got + packed[co:]
    want = torch.zeros(co, nch, 9, kch)
    wf = w.float().permute(3, 0, 1, 2).reshape(co, 9, c)
    for ci in range(nch):
        part = wf[:, :, ci * kch:(ci + 1) * kch]
        want[:, ci, :, :part.shape[-1]] = part
    np.testing.assert_allclose(got.numpy(), want.reshape(co, -1).numpy(),
                               rtol=2 ** -21, atol=0)


def test_packed_weight_is_kept_until_the_weight_changes():
    w = torch.randn(3, 3, 32, 32)
    first = pfc._packed(w)
    assert pfc._packed(w) is first
    w.mul_(2.0)                       # in place: a new version
    again = pfc._packed(w)
    assert again is not first
    torch.testing.assert_close(again, pack_weight(w))
