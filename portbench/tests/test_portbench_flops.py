"""The architecture counts against ``FlopCounterMode`` on the plain
reference, the kernel sites against the port's own counters, and each
roofline bound against one site worked by hand.

Where the counts differ: ``FlopCounterMode`` also counts the FIR
resampling, which the reference computes as a depthwise convolution over
a zero-inserted image (16 taps an output, 12 of them on inserted zeros at
an up site); the architecture count leaves the FIR out of the model FLOPs
and ``fir_bound_s`` counts only the taps on real samples.  With the FIR
taken out of the reference the two agree exactly."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench import peaks
from portbench.harness import ROOT, load_json, plugin
from portbench.reference import ncsnpp as ref_ncsnpp
from portbench.reference.ncsnpp import NCSNpp
from portbench.reference.unet import UNet

UNET = load_json(ROOT / "portbench/configs/pnpflow-unet-celeba128.json")
NCSN = load_json(ROOT / "portbench/configs/rf-ncsnpp-celebahq256.json")


def counted(model, size, n=2):
    x = torch.zeros(n, size, size, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, torch.full((n,), 0.5))
    return fc.get_total_flops()


@pytest.mark.parametrize("size", [16, 32])
def test_unet_flops_match_flop_counter(size):
    cfg = {**UNET, "image_size": size}
    assert plugin("flops", "unet").forward_flops(cfg, 2) == counted(
        UNet(cfg), size)


def test_ncsnpp_flops_match_flop_counter_without_the_fir(monkeypatch):
    cfg = {**NCSN, "image_size": 64}
    # the FIR by a resampling FlopCounterMode does not count
    monkeypatch.setattr(ref_ncsnpp, "fir_up", lambda x, k: F.interpolate(
        x, scale_factor=2.0, mode="nearest"))
    monkeypatch.setattr(ref_ncsnpp, "fir_down",
                        lambda x, k: F.avg_pool2d(x, 2))
    assert plugin("flops", "ncsnpp").forward_flops(cfg, 2) == counted(
        NCSNpp(cfg), 64)


def test_ncsnpp_fir_counts_only_real_taps():
    cfg = {**NCSN, "image_size": 64}
    flops = plugin("flops", "ncsnpp")
    with_fir = counted(NCSNpp(cfg), 64)
    dense = flops.forward_flops(cfg, 2)
    # the counter's FIR: 2 flops for each of the 16 taps of every output
    # of the convolution, before a down site keeps every second one
    fir_all = sum(2 * kk * kk * 2 * c * (h * up + p0 + p1 - kk + 1) ** 2
                  for h, _, c, up, _, p0, p1, kk in flops.fir_sites(cfg))
    assert with_fir == dense + fir_all


def test_site_lists():
    u, n = plugin("flops", "unet"), plugin("flops", "ncsnpp")
    assert len(u.conv_sites(UNET)) == 109
    assert len(u.gn_sites(UNET)) == 123
    sites = n.fir_sites(NCSN)
    assert len(sites) == 36
    assert sum(s[2] == 3 for s in sites) == 12
    assert sum(s[3] == 2 for s in sites) == 18


def test_conv_bound_by_hand():
    # 16x16, 256 -> 256, prologue and residual, 80 images, float32:
    # 2 * 80*256 px * 9*256*256 = 2.4159e12 flop over 165e12 = 14.64 ms;
    # bytes (20480*256 + 9*65536 + 2*20480*256)*4 + 4*(80*512 + 2*80*256
    # + 256) = 65.45 MB over 3.35 TB/s = 19.5 us: bound by operations
    s = plugin("flops", "unet").conv_bound_s((16, 256, 256, True, False,
                                              True), 80, "float32")
    assert s == pytest.approx(2 * 80 * 256 * 9 * 256 * 256 / 165e12)
    # bfloat16 at 3x3 -> 32 on 128x128 is bound by bytes
    s = plugin("flops", "unet").conv_bound_s((128, 3, 32, False, False,
                                              False), 80, "bfloat16")
    px = 80 * 128 * 128
    nbytes = (px * 3 + 9 * 3 * 32 + px * 32) * 2 + 4 * (80 * 64 + 32)
    assert s == pytest.approx(nbytes / 3.35e12)


def test_fir_and_gn_bounds_by_hand():
    # 256x256x128 down by 2 at 20 images: read 20*256*256*128 and write a
    # quarter of it, float32, over 3.35 TB/s
    s = plugin("flops", "ncsnpp").fir_bound_s(
        (256, 256, 128, 1, 2, 1, 1, 4), 20)
    assert s == pytest.approx(20 * 128 * (65536 + 16384) * 4 / 3.35e12)
    s = plugin("flops", "unet").gn_bound_s((128, 32, True), 128, "float32")
    assert s == pytest.approx(2 * 128 * 128 * 128 * 32 * 4 / 3.35e12)


def test_peaks():
    assert peaks.matmul_peak("float32") == pytest.approx(165e12)
    assert peaks.matmul_peak("bfloat16") == 989e12
