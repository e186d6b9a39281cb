"""Operations and kernel sites of the PnP-Flow velocity U-Net, counted from
its architecture (``configs/*.json`` with ``"arch": "unet"``).

Model FLOPs count 2 per multiply-add of every convolution, linear layer and
attention product (q k^T and the weighted sum of v); normalisations,
activations and additions are not counted, as no MFU convention counts
them.  ``tests/test_portbench_flops.py`` holds the count against
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference.
"""

from __future__ import annotations

from portbench.peaks import HBM_BYTES_PER_S, matmul_peak


def _walk(cfg):
    """Yield each layer as (kind, resolution, cin, cout)."""
    ch, mult = cfg["ch"], cfg["ch_mult"]
    attn, res = set(cfg["attn_resolutions"]), cfg["image_size"]
    yield ("temb", 0, ch, 4 * ch)
    yield ("temb", 0, 4 * ch, 4 * ch)
    yield ("conv3", res, cfg["num_channels"], ch)
    hs, cur = [ch], ch
    for lev, m in enumerate(mult):
        for _ in range(cfg["num_res_blocks"]):
            yield ("block", res, cur, ch * m)
            cur = ch * m
            if res in attn:
                yield ("attn", res, cur, cur)
            hs.append(cur)
        if lev != len(mult) - 1:
            res //= 2
            yield ("conv3", res, cur, cur)      # stride 2: output resolution
            hs.append(cur)
    yield ("block", res, cur, cur)
    yield ("attn", res, cur, cur)
    yield ("block", res, cur, cur)
    for lev in reversed(range(len(mult))):
        for _ in range(cfg["num_res_blocks"] + 1):
            yield ("block", res, cur + hs.pop(), ch * mult[lev])
            cur = ch * mult[lev]
            if res in attn:
                yield ("attn", res, cur, cur)
        if lev != 0:
            res *= 2
            yield ("conv3", res, cur, cur)
    yield ("norm", res, cur, cur)
    yield ("conv3", res, cur, cfg["num_channels"])


def forward_flops(cfg: dict, n: int) -> float:
    """Model FLOPs of one forward of ``n`` images."""
    temb, total = 4 * cfg["ch"], 0
    for kind, r, cin, cout in _walk(cfg):
        px = n * r * r
        if kind == "temb":
            total += 2 * n * cin * cout
        elif kind == "conv3":
            total += 2 * px * 9 * cin * cout
        elif kind == "block":
            total += 2 * px * 9 * (cin * cout + cout * cout)
            total += 2 * n * temb * cout
            if cin != cout:
                total += 2 * px * cin * cout
        elif kind == "attn":
            total += 2 * px * 4 * cin * cin + 2 * 2 * n * (r * r) ** 2 * cin
    return float(total)


def conv_sites(cfg: dict) -> list:
    """The ``conv3x3_gn`` launches of one forward with ``fused_norm
    "conv"``: (resolution, cin, cout, prologue, sample_bias, residual) for
    the first conv and both convs of each residual block."""
    sites = []
    for kind, r, cin, cout in _walk(cfg):
        if kind == "conv3" and not sites:
            sites.append((r, cin, cout, False, False, False))
        elif kind == "block":
            sites += [(r, cin, cout, True, True, False),
                      (r, cout, cout, True, False, True)]
    return sites


def gn_sites(cfg: dict) -> list:
    """The GroupNorm launches of one forward with ``fused_norm True``:
    (resolution, channels, swish)."""
    sites = []
    for kind, r, cin, cout in _walk(cfg):
        if kind == "block":
            sites += [(r, cin, True), (r, cout, True)]
        elif kind == "attn":
            sites.append((r, cin, False))
        elif kind == "norm":
            sites.append((r, cin, True))
    return sites


def conv_bound_s(site, n: int, dtype: str) -> float:
    """Least time of one ``conv3x3_gn`` launch at ``n`` images: the larger
    of its bytes (x, w, the residual and y once each, and the float32
    prologue, sample-bias, bias and moment vectors) over HBM bandwidth and
    its operations (2 a multiply-add of the 9 C CO a pixel) over the
    matmul peak of the dtype."""
    h, cin, cout, pro, sb, res = site
    item = 2 if dtype == "bfloat16" else 4
    px = n * h * h
    nbytes = (px * cin + 9 * cin * cout + px * cout * (2 if res else 1)) \
        * item + 4 * (n * 2 * cout + (2 * n * cin if pro else 0)
                      + (n * cout if sb else 0) + cout)
    flop = 2 * px * 9 * cin * cout
    return max(nbytes / HBM_BYTES_PER_S, flop / matmul_peak(dtype))


def gn_bound_s(site, n: int, dtype: str) -> float:
    """Least time of one GroupNorm launch: one read of x, one write of y."""
    h, c, _ = site
    item = 2 if dtype == "bfloat16" else 4
    return 2 * n * h * h * c * item / HBM_BYTES_PER_S
