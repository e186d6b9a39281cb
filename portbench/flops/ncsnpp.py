"""Operations and FIR sites of the RectifiedFlow NCSN++, counted from its
architecture (``configs/*.json`` with ``"arch": "ncsnpp"``).

Model FLOPs count 2 per multiply-add of every convolution, dense layer,
NIN and attention product; the FIR resampling is counted apart, by the
taps that meet real samples (:func:`fir_bound_s`), and normalisations and
activations not at all.  ``tests/test_portbench_flops.py`` holds the count
against ``FlopCounterMode`` on the plain reference.
"""

from __future__ import annotations

from portbench.peaks import FLOP_PER_S, HBM_BYTES_PER_S


def _walk(cfg):
    """Yield (kind, resolution, cin, cout); a block's resolution is its
    output's, "rblock" a resampling block, a "fir" its input's with the
    factor (2 up, -2 down) in place of cout."""
    nf, mult, size = cfg["nf"], cfg["ch_mult"], cfg["image_size"]
    nres, attn, cimg = cfg["num_res_blocks"], set(cfg["attn_resolutions"]), \
        cfg["num_channels"]
    yield ("dense", 0, 2 * nf, 4 * nf)
    yield ("dense", 0, 4 * nf, 4 * nf)
    yield ("conv3", size, cimg, nf)
    hs, cur = [nf], nf
    for lev, m in enumerate(mult):
        r = size // 2 ** lev
        for _ in range(nres):
            yield ("block", r, cur, nf * m)
            cur = nf * m
            if r in attn:
                yield ("attn", r, cur, cur)
            hs.append(cur)
        if lev != len(mult) - 1:
            yield ("rblock", r // 2, cur, cur)
            yield ("fir", r, cur, -2)
            yield ("fir", r, cur, -2)
            yield ("fir", r, cimg, -2)
            yield ("conv1", r // 2, cimg, cur)
            hs.append(cur)
    r = size // 2 ** (len(mult) - 1)
    yield ("block", r, cur, cur)
    yield ("attn", r, cur, cur)
    yield ("block", r, cur, cur)
    for lev in reversed(range(len(mult))):
        r = size // 2 ** lev
        for _ in range(nres + 1):
            yield ("block", r, cur + hs.pop(), nf * mult[lev])
            cur = nf * mult[lev]
        if r in attn:
            yield ("attn", r, cur, cur)
        if lev != len(mult) - 1:
            yield ("fir", r // 2, cimg, 2)
        yield ("conv3", r, cur, cimg)
        if lev != 0:
            yield ("rblock", 2 * r, cur, cur)
            yield ("fir", r, cur, 2)
            yield ("fir", r, cur, 2)


def forward_flops(cfg: dict, n: int) -> float:
    """Model FLOPs of one forward of ``n`` images, the FIR left out."""
    temb, total = 4 * cfg["nf"], 0
    for kind, r, cin, cout in _walk(cfg):
        px = n * r * r
        if kind == "dense":
            total += 2 * n * cin * cout
        elif kind == "conv3":
            total += 2 * px * 9 * cin * cout
        elif kind == "conv1":
            total += 2 * px * cin * cout
        elif kind in ("block", "rblock"):
            total += 2 * px * 9 * (cin * cout + cout * cout)
            total += 2 * n * temb * cout
            # a 1x1 shortcut where the channels change or the block
            # resamples
            if cin != cout or kind == "rblock":
                total += 2 * px * cin * cout
        elif kind == "attn":
            total += 2 * px * 4 * cin * cin + 2 * 2 * n * (r * r) ** 2 * cin
    return float(total)


def fir_sites(cfg: dict) -> list:
    """The ``upfirdn2d`` launches of one forward: (h, w, c, up, down,
    pad0, pad1, taps)."""
    k = len(cfg["fir_kernel"])
    p = k - 2
    sites = []
    for kind, r, c, factor in _walk(cfg):
        if kind == "fir" and factor == 2:
            sites.append((r, r, c, 2, 1, (p + 1) // 2 + 1, p // 2, k))
        elif kind == "fir":
            sites.append((r, r, c, 1, 2, (p + 1) // 2, p // 2, k))
    return sites


def fir_bound_s(site, n: int, item: int = 4) -> float:
    """Least time of one ``upfirdn2d`` launch: the larger of one read of x
    and one write of y over HBM bandwidth, and 2 flops for each tap on a
    real (not zero-inserted) input over the CUDA cores' float32 rate."""
    h, w, c, up, down, p0, p1, kk = site
    oh = (h * up + p0 + p1 - kk) // down + 1
    ow = (w * up + p0 + p1 - kk) // down + 1
    out = n * oh * ow * c
    return max((n * h * w * c + out) * item / HBM_BYTES_PER_S,
               2 * (kk // up) ** 2 * out / FLOP_PER_S["float32"])
