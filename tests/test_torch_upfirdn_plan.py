"""The upfirdn2d kernel's launch plan and phase tables, on the CPU.

``fir_plan`` and ``fir_phase_table`` carry the geometry that
``csrc/upfirdn2d.cu`` runs: tiles, footprints, the thread grid and which
window cell meets which tap.  These tests check that geometry at every
NCSN++ 256^2 site: every output pixel and channel is computed exactly once,
shared memory fits, and every tap of every output reads the footprint cell
that holds its input (brute force over outputs and taps).  A numpy
evaluation driven by the plan and the tables, as the kernel runs them, is
held to JAX's ``upfirdn2d_pallas`` (interpret mode) and ``upfirdn2d_xla``
within 1e-6: it sums in float64, so the bound is JAX's own float32
rounding of at most 16 products of O(1) values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.ops import upfirdn as jup
from pnpflow_tpu.ops.pallas_kernels import upfirdn2d_pallas
from pnpflow_tpu_torch.ops import upfirdn as tup
from pnpflow_tpu_torch.ops.upfirdn import (
    MAX_THREADS, SMEM_MAX, TILE_TASKS, fir_geometry, fir_phase_table, fir_plan)

TAPS = [1, 3, 3, 1]
BATCH = 20                       # images per NCSN++ forward on the main path
DOWN = (1, 2, 1, 1)              # (up, down, pad0, pad1)
UP = (2, 1, 2, 1)
# every upfirdn2d call of one NCSN++ 256^2 forward: (h, c, kind) -> calls
NCSNPP_SITES = {
    **{(h, c, DOWN): n for h in (256, 128, 64, 32, 16, 8)
       for c, n in (((128 if h >= 128 else 256), 2), (3, 1))},
    **{(h, c, UP): n for h in (4, 8, 16, 32, 64, 128)
       for c, n in (((128 if h >= 128 else 256), 2), (3, 1))},
}
SITES = sorted(NCSNPP_SITES)
ITEMSIZES = {"float32": 4, "bfloat16": 2}


def _plan(h, c, kind, itemsize, w=None, n=BATCH, aligned=True):
    up, down, p0, p1 = kind
    return fir_plan(n, h, h if w is None else w, c, up, down, p0, p1, 4,
                    itemsize, aligned)


def test_site_list_is_the_ncsnpp_forward():
    """The table above is what one NCSN++ 256^2 forward calls."""
    from pnpflow_tpu_torch.models.ncsnpp import NCSNpp

    real, seen = tup.upfirdn2d, {}

    def record(x, k, up=1, down=1, pad=(0, 0)):
        key = (x.shape[1], x.shape[3], (up, down, int(pad[0]), int(pad[1])))
        seen[key] = seen.get(key, 0) + 1
        np.testing.assert_allclose(np.asarray(k) / np.sum(k),
                                   tup.setup_kernel(TAPS), rtol=1e-6)
        return real(x, k, up, down, pad)

    record.launches, record.paths = 0, dict.fromkeys(tup.PATHS, 0)
    tup.upfirdn2d = record
    try:
        with torch.inference_mode():
            NCSNpp(image_size=256).eval()(torch.zeros(1, 256, 256, 3),
                                         torch.full((1,), 500.0))
    finally:
        tup.upfirdn2d = real
    assert seen == NCSNPP_SITES
    assert sum(seen.values()) == 36


def _axis_cover(tiles, tile, tasks, r_count, size):
    """How often each output index along one axis is computed."""
    hits = np.zeros(tiles * tile, int)
    for t in range(tiles):
        for j in range(tasks):
            for r in range(r_count):
                hits[t * tile + j * r_count + r] += 1
    return hits[:size]


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("site", SITES)
def test_plan_covers_every_output_once_and_fits(site, dtype):
    h, c, kind = site
    plan = _plan(h, c, kind, ITEMSIZES[dtype])
    g = fir_geometry(kind[0], kind[1], plan.phase[0])
    assert plan.path == ("narrow" if c == 3 else "tiled")
    assert (plan.oh, plan.ow) == ((h // 2, h // 2) if kind == DOWN
                                  else (2 * h, 2 * h))
    assert plan.tile == (g.ry * plan.jt, g.rx * plan.it)
    # every output row and column once, every channel once
    rows = _axis_cover(plan.tiles[0], plan.tile[0], plan.jt, g.ry, plan.oh)
    cols = _axis_cover(plan.tiles[1], plan.tile[1], plan.it, g.rx, plan.ow)
    assert (rows == 1).all() and (cols == 1).all()
    assert plan.tiles[0] * plan.tile[0] - plan.oh < plan.tile[0]
    assert plan.tiles[1] * plan.tile[1] - plan.ow < plan.tile[1]
    assert plan.chunks * plan.cv * plan.v == c
    assert 1 <= plan.jz <= plan.jt          # each task row by one thread row
    # what the kernel can launch
    assert plan.cv * plan.it * plan.jz <= MAX_THREADS
    cell = 16 if plan.path == "tiled" else 4
    assert plan.smem == plan.foot[0] * plan.foot[1] * plan.cv * cell
    assert plan.smem <= SMEM_MAX
    if plan.path == "tiled":
        assert plan.cv * plan.v * ITEMSIZES[dtype] == min(
            128, c * ITEMSIZES[dtype])    # a 128-byte line of a pixel
    # the large sites fill the card's 132 SMs; no site cuts its tiles
    # below the full task rows the output allows, so a small site launches
    # few blocks
    if h * h * c * ITEMSIZES[dtype] * (4 if kind == UP else 1) >= 2**20:
        assert BATCH * plan.chunks * plan.tiles[0] * plan.tiles[1] >= 132
    rows_full = TILE_TASKS[kind[:2]][0]
    assert plan.jt == min(rows_full, -(-plan.oh // g.ry))


def _axis_taps(plan, up, down, pad0, size, tile_len, r_count, step, wins,
               table, foot_len):
    """Brute force along one axis: for every output index and tap, the
    input index it needs (when the tap meets a real sample) must be the
    footprint cell that the phase table assigns to it, and no other tap."""
    pm, q = plan.phase
    for o in range(size):
        t, local = divmod(o, tile_len)
        j, r = divmod(local, r_count)
        origin = t * tile_len * down // up - q
        want = {}
        for p in range(4):
            m = o * down + p - pad0
            if m % up == 0:
                want[p] = m // up - origin
        got = {tap: j * step + w for w, rr, tap in table if rr == r}
        assert got == want, (o, got, want)
        assert all(0 <= cell < foot_len for cell in got.values())
        assert all(w < wins for w, _, _ in table)


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("site", SITES)
def test_every_tap_lies_in_its_tiles_footprint(site, dtype):
    h, c, kind = site
    up, down, p0, _ = kind
    plan = _plan(h, c, kind, ITEMSIZES[dtype])
    g = fir_geometry(up, down, plan.phase[0])
    rows, cols = fir_phase_table(up, down, plan.phase[0])
    _axis_taps(plan, up, down, p0, plan.oh, plan.tile[0], g.ry, g.sy, g.wh,
               rows, plan.foot[0])
    _axis_taps(plan, up, down, p0, plan.ow, plan.tile[1], g.rx, g.sx, g.ww,
               cols, plan.foot[1])


def plan_eval(x, k, up, down, pad, plan):
    """upfirdn2d as the tiled kernel computes it: per chunk and tile, stage
    the zero-filled footprint, then for every window cell and output of the
    phase tables add tap * cell; float64."""
    n, h, w, c = x.shape
    f = np.asarray(k, np.float64)[::-1, ::-1]
    pm, q = plan.phase
    g = fir_geometry(up, down, pm)
    rows, cols = fir_phase_table(up, down, pm)
    (th, tw), (fh, fw) = plan.tile, plan.foot
    width = plan.cv * plan.v
    y = np.full((n, plan.oh, plan.ow, c), np.nan)
    for ch in range(plan.chunks):
        cs = slice(ch * width, (ch + 1) * width)
        for ty in range(plan.tiles[0]):
            for tx in range(plan.tiles[1]):
                oy0, ox0 = ty * th, tx * tw
                iy0, ix0 = oy0 * down // up - q, ox0 * down // up - q
                foot = np.zeros((n, fh, fw, width))
                ya, yb = max(iy0, 0), min(iy0 + fh, h)
                xa, xb = max(ix0, 0), min(ix0 + fw, w)
                if ya < yb and xa < xb:
                    foot[:, ya - iy0:yb - iy0, xa - ix0:xb - ix0] = \
                        x[:, ya:yb, xa:xb, cs]
                acc = np.zeros((n, plan.jt, g.ry, plan.it, g.rx, width))
                for wy, ry, p in rows:
                    for wx, rx, t in cols:
                        acc[:, :, ry, :, rx] += f[p, t] * foot[
                            :, wy:wy + g.sy * (plan.jt - 1) + 1:g.sy,
                            wx:wx + g.sx * (plan.it - 1) + 1:g.sx]
                tile = acc.reshape(n, th, tw, width)
                hy, hx = min(th, plan.oh - oy0), min(tw, plan.ow - ox0)
                y[:, oy0:oy0 + hy, ox0:ox0 + hx, cs] = tile[:, :hy, :hx]
    assert not np.isnan(y).any()
    return y


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("shape,kind", [
    ((2, 16, 16, 3), DOWN), ((2, 16, 16, 3), UP), ((2, 16, 16, 8), DOWN),
    ((2, 16, 16, 8), UP), ((2, 17, 23, 4), DOWN), ((2, 17, 23, 4), UP),
    ((1, 17, 23, 16), (2, 1, 3, 2)), ((1, 9, 11, 8), (1, 2, 2, 1)),
    ((1, 4, 4, 64), UP), ((1, 8, 8, 32), DOWN)])
def test_plan_evaluation_matches_jax(shape, kind, dtype):
    """The plan's geometry at either dtype's chunking, on float32 data."""
    up, down, p0, p1 = kind
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    k = tup.setup_kernel(TAPS) * (4.0 if up > 1 else 1.0)
    n, h, w, c = shape
    plan = fir_plan(n, h, w, c, up, down, p0, p1, 4, ITEMSIZES[dtype])
    assert plan.path == ("tiled" if c * ITEMSIZES[dtype] % 16 == 0
                         else "narrow")
    got = plan_eval(x, k, up, down, (p0, p1), plan)
    xla = np.asarray(jup.upfirdn2d_xla(jnp.asarray(x), k, up=up, down=down,
                                       pad=(p0, p1)))
    pallas = np.asarray(upfirdn2d_pallas(jnp.asarray(x), k, up=up,
                                         down=down, pad=(p0, p1),
                                         interpret=True))
    assert got.shape == xla.shape == pallas.shape
    assert np.abs(got - xla).max() <= 1e-6
    assert np.abs(got - pallas).max() <= 1e-6


@pytest.mark.parametrize("shape,kind,kk,itemsize,aligned,path", [
    ((2, 16, 16, 128), DOWN, 4, 4, True, "tiled"),
    ((2, 16, 16, 128), UP, 4, 2, True, "tiled"),
    ((2, 16, 16, 12), UP, 4, 4, True, "tiled"),       # 48-byte pixels
    ((2, 16, 16, 12), UP, 4, 2, True, "narrow"),      # 24-byte pixels
    ((2, 16, 16, 3), DOWN, 4, 4, True, "narrow"),
    ((2, 16, 16, 128), DOWN, 4, 4, False, "narrow"),  # unaligned view
    ((2, 16, 16, 8), (2, 2, 2, 2), 4, 4, True, "general"),
    ((2, 16, 16, 8), (1, 1, 1, 1), 4, 4, True, "general"),
    ((2, 16, 16, 8), (2, 1, 2, 2), 5, 4, True, "general"),
])
def test_plan_picks_the_path_from_the_shape(shape, kind, kk, itemsize,
                                            aligned, path):
    n, h, w, c = shape
    up, down, p0, p1 = kind
    plan = fir_plan(n, h, w, c, up, down, p0, p1, kk, itemsize, aligned)
    assert plan.path == path
    assert plan.oh == (h * up + p0 + p1 - kk) // down + 1


@pytest.mark.parametrize("kind", [DOWN, UP, (2, 1, 3, 2)])
def test_every_plan_fits_the_default_shared_memory(kind):
    """A chunk's pixel is at most 128 bytes, so no shape needs more than
    41,472 bytes of shared memory or 512 threads."""
    up, down, p0, p1 = kind
    for c in range(1, 300):
        for itemsize in (2, 4):
            for aligned in (True, False):
                for h, w in ((4, 4), (17, 23), (256, 256), (2, 300)):
                    plan = fir_plan(2, h, w, c, up, down, p0, p1, 4, itemsize,
                                    aligned)
                    assert plan.smem <= 41472 <= SMEM_MAX
                    assert plan.cv * plan.it * plan.jz <= MAX_THREADS
                    assert plan.chunks * plan.cv * plan.v == c


def test_up_phase_follows_pad0():
    """pad0 fixes which taps meet real samples: the tables of the two
    phases differ, and each output row meets two taps either way."""
    even, odd = fir_phase_table(2, 1, 0), fir_phase_table(2, 1, 1)
    assert even != odd
    for pm, (rows, cols) in ((0, even), (1, odd)):
        assert rows == cols
        for r in range(2):
            taps = [t for _, rr, t in rows if rr == r]
            assert len(taps) == 2 and all(t % 2 == (r + pm) % 2 for t in taps)
    assert _plan(8, 128, (2, 1, 3, 2), 4).phase == (1, 1)
    assert _plan(8, 128, UP, 4).phase == (0, 1)


def test_cpu_view_offset_by_one_element_plans_the_narrow_path():
    base = torch.randn(1 * 8 * 8 * 128 + 1)
    x = base[1:].view(1, 8, 8, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    k = tup.setup_kernel(TAPS)
    before = dict(tup.upfirdn2d.paths)
    got = tup.upfirdn2d(x, k, down=2, pad=(1, 1))
    assert tup.upfirdn2d.paths == before           # the CPU launches nothing
    assert torch.equal(got, tup.upfirdn2d_reference(x, k, down=2,
                                                    pad=(1, 1)))
    assert fir_plan(1, 8, 8, 128, 1, 2, 1, 1, 4, 4, False).path == "narrow"


def test_flipped_taps_are_built_once_per_taps_and_site():
    k = np.arange(1, 17, dtype=np.float32).reshape(4, 4)
    a = tup._flipped_taps(k, 1, 2, 1, 1)
    assert tup._flipped_taps(k.copy(), 1, 2, 1, 1) is a
    assert list(a) == list(k[::-1, ::-1].ravel())
    assert tup._flipped_taps(k, 2, 1, 2, 1) is not a
    assert tup._flipped_taps(k * 2, 1, 2, 1, 1) is not a


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="2\\^31"):
        fir_plan(64, 1024, 1024, 512, 1, 2, 1, 1, 4, 4)
    with pytest.raises(ValueError, match="grid"):
        fir_plan(70000, 8, 8, 16, 1, 2, 1, 1, 4, 4)
