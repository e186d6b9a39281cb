"""Card-only tests of the port's kernels: each against its plain version on
CUDA tensors.  They skip, from inside a fixture, where no GPU is visible.

Run on a GPU machine with ``python -m pytest --noconftest -p
no:cacheprovider -m gpu tests/test_torch_gpu.py``; ``--noconftest`` because
``tests/conftest.py`` imports JAX, which a GPU machine need not have.
"""

import pytest
import torch

from pnpflow_tpu_torch.ops.fused_conv_gn import (
    KBYTES, WARPGROUPS, channel_moments, conv3x3_gn, conv3x3_gn_reference,
    gn_prologue, launch_plan)
from pnpflow_tpu_torch.ops.gn_swish import (
    gn_plan, gn_swish_reference, groupnorm_swish, groupnorm_swish_fwd)
from pnpflow_tpu_torch.ops.gn_swish import launch as gn_launch
from pnpflow_tpu_torch.ops.gn_swish_bm import (
    groupnorm_swish_bm, groupnorm_swish_bm_fwd)
from pnpflow_tpu_torch.ops.upfirdn import (
    fir_plan, setup_kernel, upfirdn2d, upfirdn2d_reference)
from pnpflow_tpu_torch.models.ncsnpp import NCSNpp, init_ncsnpp
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.training import flow_matching as fm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (n, h, w, c, groups, swish, path): flagship sites with group sizes 3, 6,
# 12 and 16 and clusters of 16 and 8 blocks; ragged shapes whose rows split
# unevenly over the cluster (49 over 8, 485 over 8) and one-pixel images;
# the 128^2 U-Net, where fp32 96 and 64 channels fit no cluster; and rows
# that are not whole 16-byte vectors, which take the scalar two-phase path
# (None: the path differs between the dtypes)
GN_CASES = [
    (3, 64, 64, 96, 32, True, "cluster"), (20, 32, 32, 192, 32, True,
                                          "cluster"),
    (20, 16, 16, 384, 32, False, "cluster"), (20, 8, 8, 512, 32, True,
                                              "cluster"),
    (20, 64, 64, 32, 32, True, "cluster"), (5, 7, 7, 32, 32, True, "cluster"),
    (4, 5, 97, 64, 32, False, "cluster"), (3, 1, 1, 64, 32, True, "cluster"),
    (2, 128, 128, 96, 32, True, None), (2, 128, 128, 64, 32, False, None),
    (3, 9, 9, 36, 4, True, None), (2, 5, 7, 6, 2, True, "two_phase"),
]


def _check_gn_kernel(cuda, fn, case, dtype):
    n, h, w, c, groups, swish, path = case
    g = torch.Generator(device=cuda).manual_seed(c + h)
    x = (torch.randn(n, h, w, c, generator=g, device=cuda) * 2 + 0.5).to(
        dtype)
    s = torch.randn(c, generator=g, device=cuda) * 0.2 + 1
    b = torch.randn(c, generator=g, device=cuda) * 0.1
    plan = gn_plan(n, h * w, c, groups, x.element_size())
    assert path is None or plan.path == path
    before = fn.launches
    y = fn(x, s, b, groups, 1e-6, swish)
    torch.cuda.synchronize()
    assert fn.launches == before + 1     # one per call, on either path
    want = gn_swish_reference(x, s, b, groups, 1e-6, swish)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert y.dtype == dtype
    assert float((y.float() - want.float()).abs().max()) <= tol
    # partials are reduced in a fixed order, without atomics
    assert torch.equal(y, fn(x, s, b, groups, 1e-6, swish))


@pytest.mark.parametrize("case", GN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_swish_kernel(cuda, case, dtype):
    _check_gn_kernel(cuda, groupnorm_swish_fwd, case, dtype)


@pytest.mark.parametrize("case", GN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_swish_bm_kernel(cuda, case, dtype):
    _check_gn_kernel(cuda, groupnorm_swish_bm_fwd, case, dtype)


def _check_gn_backward(cuda, fn):
    """Gradients through the kernel's forward on the card equal the CPU's
    (the backward is plain torch on both)."""
    x0 = torch.randn(2, 8, 8, 64) * 2 + 0.5
    s0, b0 = torch.rand(64) + 0.5, torch.randn(64) * 0.1
    grads = []
    for dev in (cuda, torch.device("cpu")):
        x, s, b = (t.to(dev).requires_grad_() for t in (x0, s0, b0))
        torch.sin(fn(x, s, b)).sum().backward()
        grads.append([t.grad.cpu() for t in (x, s, b)])
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def test_groupnorm_swish_backward_on_card(cuda):
    _check_gn_backward(cuda, groupnorm_swish)


def test_groupnorm_swish_bm_backward_on_card(cuda):
    _check_gn_backward(cuda, groupnorm_swish_bm)


@pytest.mark.parametrize("fn", [groupnorm_swish_fwd, groupnorm_swish_bm_fwd])
def test_groupnorm_swish_refuses_what_it_cannot_take(cuda, fn):
    s, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    x = torch.randn(2 * 8 * 8 * 64 + 1, device=cuda)[1:].view(2, 8, 8, 64)
    before = fn.launches
    with pytest.raises(ValueError, match="16-byte"):
        fn(x, s, b)                                   # 4 bytes off
    with pytest.raises(ValueError, match="wider than a block"):
        fn(torch.zeros(1, 2, 2, 8192, device=cuda),
           torch.ones(8192, device=cuda), torch.zeros(8192, device=cuda))
    with pytest.raises(TypeError):
        fn(x.half().contiguous(), s, b)
    assert fn.launches == before
    # a plan the kernel cannot run is refused by the launch, not run
    # another way
    x = x.clone()
    plan = gn_plan(2, 64, 64, 32, 4)
    for bad in (plan._replace(smem=256), plan._replace(k=32),
                plan._replace(threads=24)):
        with pytest.raises(RuntimeError, match="launch failed"):
            gn_launch(x, s, b, 32, 1e-6, True, bad)


# (batch, size, C, CO, flags): every epilogue combination at one shape,
# then flagship sites that exercise the tiling -- the 3-channel begin conv,
# the 8x8 (C -> 256) sites at the main-path batch, and 64x64 at batch 20;
# flag 8 asks for no moments
CONV_CASES = [(3, 16, 64, 128, f) for f in range(8)] + [
    (20, 64, 3, 32, 0), (20, 8, 96, 256, 5), (20, 8, 384, 256, 5),
    (20, 8, 512, 256, 5), (20, 64, 32, 32, 3), (20, 64, 96, 32, 5)] + [
    (3, 16, 64, 128, f | 8) for f in range(8)]

# tiles that span samples: two 8x8 samples per 128 pixels at the bench
# batch (CO 256), four 4x4 samples per 256 pixels, batches the tile's
# samples do not divide (133, 601), the begin conv's C = 3 and CO 32 to 256
SPAN_CASES = [(320, 8, 256, 256, 5), (133, 8, 128, 256, 1),
              (600, 4, 32, 32, 7), (601, 4, 64, 32, 3), (320, 8, 3, 32, 0),
              (133, 8, 64, 64, 6), (320, 8, 64, 128, 15)]


@pytest.mark.parametrize("n,h,c,co,flags", CONV_CASES + SPAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_gn_kernel(cuda, n, h, c, co, flags, dtype):
    g = torch.Generator(device=cuda).manual_seed(flags + c)
    x = torch.randn(n, h, h, c, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 3, c, co, generator=g, device=cuda)
         / (9 * c) ** 0.5).to(dtype)
    b = torch.randn(co, generator=g, device=cuda) * 0.1
    kw = {}
    if flags & 1:
        kw["prologue"] = gn_prologue(channel_moments(x), h * h,
                                     torch.ones(c, device=cuda),
                                     torch.full((c,), 0.5, device=cuda))
    if flags & 2:
        kw["sample_bias"] = torch.randn(n, co, generator=g, device=cuda)
    if flags & 4:
        kw["residual"] = torch.randn(n, h, h, co, generator=g,
                                     device=cuda).to(dtype)
    emit = not flags & 8
    before = conv3x3_gn.launches
    y, m = conv3x3_gn(x, w, b, emit_moments=emit, **kw)
    torch.cuda.synchronize()
    assert conv3x3_gn.launches == before + 1
    y2, m2 = conv3x3_gn_reference(x, w, b, emit_moments=emit, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(y2.float().abs().max())
    assert float((y.float() - y2.float()).abs().max()) <= tol * scale
    if not emit:
        assert m is None
    for k in range(2 if emit else 0):
        assert (float((m[:, k] - m2[:, k]).abs().max())
                <= tol * float(m2[:, k].abs().max()))
    # the partials are summed in a fixed order, whichever block is elected
    # last: output and moments repeat bit for bit
    y3, m3 = conv3x3_gn(x, w, b, emit_moments=emit, **kw)
    assert torch.equal(y, y3) and (m is None or torch.equal(m, m3))


@pytest.mark.parametrize("n,h,w,c,co", [
    (3, 7, 12, 40, 64),      # ragged tiles, a partial last channel chunk
    (2, 5, 96, 72, 32),      # rows wider than a tile: 64-column tiles
    (2, 9, 9, 37, 64),       # C the 16-byte copies cannot take: scalar loads
    (1, 1, 1, 8, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_gn_kernel_ragged_shapes(cuda, n, h, w, c, co, dtype):
    g = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype)
    wt = (torch.randn(3, 3, c, co, generator=g, device=cuda)
          / (9 * c) ** 0.5).to(dtype)
    b = torch.randn(co, generator=g, device=cuda) * 0.1
    kw = dict(prologue=(torch.rand(n, c, generator=g, device=cuda) + 0.5,
                        torch.randn(n, c, generator=g, device=cuda)),
              sample_bias=torch.randn(n, co, generator=g, device=cuda),
              residual=torch.randn(n, h, w, co, generator=g,
                                   device=cuda).to(dtype))
    y, m = conv3x3_gn(x, wt, b, **kw)
    torch.cuda.synchronize()
    y2, m2 = conv3x3_gn_reference(x, wt, b, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(y2.float().abs().max())
    assert float((y.float() - y2.float()).abs().max()) <= tol * scale
    for k in range(2):
        assert (float((m[:, k] - m2[:, k]).abs().max())
                <= tol * float(m2[:, k].abs().max()))


# (n, h, c, co): every two-warpgroup tile (128 x 32, 128 x 64, 128 x 128,
# 256 x 32, 256 x 64) with three channel chunks or more, where both
# warpgroups read each halo buffer and restage it while the other may lag
RACE_CASES = [(5, 64, 96, 32), (20, 32, 96, 64), (320, 8, 256, 256),
              (320, 64, 96, 32), (320, 32, 128, 64)]


@pytest.mark.parametrize("n,h,c,co", RACE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_gn_repeats_beside_a_concurrent_kernel(cuda, n, h, c, co,
                                                       dtype):
    """Twenty calls, each launched while a matmul on another stream holds
    part of the card (so the warpgroups of a block fall out of step), give
    the first call's y and moments bit for bit, and that one matches the
    plain version."""
    plan = launch_plan(n, h, h, co)
    assert WARPGROUPS[plan.bm][0] == 2
    assert -(-c * dtype.itemsize // KBYTES) >= 3
    g = torch.Generator(device=cuda).manual_seed(c + co)
    x = torch.randn(n, h, h, c, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 3, c, co, generator=g, device=cuda)
         / (9 * c) ** 0.5).to(dtype)
    b = torch.randn(co, generator=g, device=cuda) * 0.1
    kw = dict(prologue=(torch.rand(n, c, generator=g, device=cuda) + 0.5,
                        torch.randn(n, c, generator=g, device=cuda)),
              residual=torch.randn(n, h, h, co, generator=g,
                                   device=cuda).to(dtype))
    y0, m0 = conv3x3_gn(x, w, b, **kw)
    y2, m2 = conv3x3_gn_reference(x, w, b, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(y2.float().abs().max())
    assert float((y0.float() - y2.float()).abs().max()) <= tol * scale
    for k in range(2):
        assert (float((m0[:, k] - m2[:, k]).abs().max())
                <= tol * float(m2[:, k].abs().max()))
    a = torch.randn(2048, 2048, generator=g, device=cuda)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(20):
        with torch.cuda.stream(side):
            for _ in range(4):
                a @ a
        y, m = conv3x3_gn(x, w, b, **kw)
        assert torch.equal(y, y0) and torch.equal(m, m0)
    torch.cuda.synchronize()


def test_conv3x3_gn_on_each_card_in_turn(cuda):
    """The kernel runs on a second card after the first (its shared-memory
    attribute belongs to each card's context).  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    for dtype in (torch.float32, torch.bfloat16):
        for idx in range(torch.cuda.device_count()):
            dev = torch.device("cuda", idx)
            g = torch.Generator(device=dev).manual_seed(idx)
            x = torch.randn(4, 16, 16, 64, generator=g, device=dev).to(dtype)
            w = (torch.randn(3, 3, 64, 64, generator=g, device=dev)
                 / 24).to(dtype)
            b = torch.randn(64, generator=g, device=dev) * 0.1
            y, m = conv3x3_gn(x, w, b)
            y2, m2 = conv3x3_gn_reference(x, w, b)
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            assert y.device == dev
            assert (float((y.float() - y2.float()).abs().max())
                    <= tol * float(y2.float().abs().max()))


def test_conv3x3_gn_rejects_what_it_cannot_take(cuda):
    x = torch.randn(1, 8, 8, 32, device=cuda)
    w = torch.randn(3, 3, 32, 32, device=cuda)
    b = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):
        conv3x3_gn(x.permute(0, 2, 1, 3), w, b)            # not contiguous
    with pytest.raises(ValueError):
        conv3x3_gn(x, w.double(), b)                          # weight dtype
    with pytest.raises(TypeError):
        conv3x3_gn(x.half(), w.half(), b)                     # fp16


@pytest.mark.parametrize("h,c,up,down,pad", [
    (8, 4, 1, 1, (1, 1)), (8, 4, 2, 1, (3, 1)), (8, 4, 1, 2, (1, 1)),
    (8, 4, 2, 2, (2, 2)), (8, 4, 1, 1, (0, 0)), (16, 192, 1, 2, (1, 1)),
    (256, 3, 1, 2, (1, 1)), (128, 128, 2, 1, (2, 1)), (4, 256, 1, 2, (1, 1)),
    (9, 5, 2, 1, (0, 3))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upfirdn2d_kernel(cuda, h, c, up, down, pad, dtype):
    g = torch.Generator(device=cuda).manual_seed(h + c)
    x = torch.randn(3, h, h, c, generator=g, device=cuda).to(dtype)
    k = setup_kernel([1, 3, 3, 1]) * (4.0 if up > 1 else 1.0)
    before = upfirdn2d.launches
    y = upfirdn2d(x, k, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert upfirdn2d.launches == before + 1
    want = upfirdn2d_reference(x, k, up=up, down=down, pad=pad)
    assert y.shape == want.shape and y.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((y.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("ksize", [1, 2, 5, 8])
def test_upfirdn2d_kernel_other_tap_counts(cuda, ksize):
    x = torch.randn(2, 12, 12, 7, device=cuda)
    k = setup_kernel(list(range(1, ksize + 1)))
    y = upfirdn2d(x, k, up=2, down=2, pad=(ksize, ksize - 1))
    want = upfirdn2d_reference(x, k, up=2, down=2, pad=(ksize, ksize - 1))
    assert float((y - want).abs().max()) <= 1e-5


def test_upfirdn2d_rejects_what_it_cannot_take(cuda):
    x = torch.randn(1, 8, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        upfirdn2d(x, setup_kernel([1] * 9), pad=(4, 4))      # K > 8
    with pytest.raises(NotImplementedError):
        upfirdn2d(x, setup_kernel([1, 3, 3, 1]), pad=(-1, 2))
    with pytest.raises(TypeError):
        upfirdn2d(x.half(), setup_kernel([1, 3, 3, 1]), pad=(2, 1))


FIR_DOWN, FIR_UP = (1, 2, (1, 1)), (2, 1, (2, 1))
# every distinct upfirdn2d site of one NCSN++ 256^2 forward: (h, c, kind)
NCSNPP_FIR_SITES = [
    (h, c, kind)
    for kind, sizes in ((FIR_DOWN, (256, 128, 64, 32, 16, 8)),
                        (FIR_UP, (4, 8, 16, 32, 64, 128)))
    for h in sizes for c in ((128 if h >= 128 else 256), 3)]


def _check_fir(x, k, up, down, pad, path):
    """One launch on ``path`` (counted once), within the plain version's
    tolerance, and bit for bit on a second call."""
    tol = 1e-5 if x.dtype == torch.float32 else 2e-2
    before = upfirdn2d.launches, dict(upfirdn2d.paths)
    y = upfirdn2d(x, k, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert upfirdn2d.launches == before[0] + 1
    assert upfirdn2d.paths == {p: v + (p == path)
                               for p, v in before[1].items()}
    want = upfirdn2d_reference(x, k, up=up, down=down, pad=pad)
    assert y.shape == want.shape and y.dtype == x.dtype
    assert float((y.float() - want.float()).abs().max()) <= tol
    # fixed-order fp32 sums, no atomics
    assert torch.equal(y, upfirdn2d(x, k, up=up, down=down, pad=pad))


def _fir_taps(up):
    return setup_kernel([1, 3, 3, 1]) * (4.0 if up > 1 else 1.0)


@pytest.mark.parametrize("site", NCSNPP_FIR_SITES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upfirdn2d_ncsnpp_sites(cuda, site, dtype):
    h, c, (up, down, pad) = site
    n = 2 if h >= 128 else 4
    g = torch.Generator(device=cuda).manual_seed(h * c + up)
    x = torch.randn(n, h, h, c, generator=g, device=cuda).to(dtype)
    _check_fir(x, _fir_taps(up), up, down, pad,
               "narrow" if c == 3 else "tiled")


# (n, h, w, c, kind): tiles that cross the right and bottom edges, outputs
# smaller than one tile (4^2 down to 2^2, 1 x 3 up to 2 x 6), channel
# chunks of fewer than 8 vectors, C = 3, bf16 C = 12 (24-byte pixels take
# the narrow path, 48-byte fp32 pixels the tiled one), and an up phase of
# pad0 = 3
FIR_EDGE_CASES = [
    (3, 17, 23, 128, FIR_DOWN), (2, 33, 47, 128, FIR_UP),
    (3, 4, 4, 256, FIR_DOWN), (2, 1, 3, 256, FIR_UP),
    (2, 9, 11, 16, FIR_DOWN), (2, 13, 5, 8, FIR_UP),
    (3, 31, 29, 3, FIR_DOWN), (3, 15, 21, 3, FIR_UP),
    (2, 16, 16, 12, FIR_DOWN), (2, 16, 16, 12, FIR_UP),
    (2, 11, 13, 64, (2, 1, (3, 2))),
]


@pytest.mark.parametrize("case", FIR_EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upfirdn2d_tiles_at_edges_and_narrow_pixels(cuda, case, dtype):
    n, h, w, c, (up, down, pad) = case
    g = torch.Generator(device=cuda).manual_seed(h * w + c)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype)
    plan = fir_plan(n, h, w, c, up, down, pad[0], pad[1], 4,
                    x.element_size())
    assert plan.path == ("tiled" if (c * x.element_size()) % 16 == 0
                         else "narrow")
    _check_fir(x, _fir_taps(up), up, down, pad, plan.path)


@pytest.mark.parametrize("kind", [FIR_DOWN, FIR_UP])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upfirdn2d_view_offset_by_one_element(cuda, kind, dtype):
    """An x that starts one element past a 16-byte boundary cannot take the
    tiled path's 16-byte copies: it takes the narrow path."""
    up, down, pad = kind
    base = torch.randn(2 * 16 * 16 * 128 + 1, device=cuda).to(dtype)
    x = base[1:].view(2, 16, 16, 128)
    assert x.is_contiguous() and x.data_ptr() % 16
    _check_fir(x, _fir_taps(up), up, down, pad, "narrow")
    _check_fir(x.clone(), _fir_taps(up), up, down, pad, "tiled")


def test_upfirdn2d_other_kinds_take_the_general_path(cuda):
    x = torch.randn(2, 12, 12, 8, device=cuda)
    _check_fir(x, setup_kernel([1, 3, 3, 1]), 2, 2, (2, 2), "general")
    _check_fir(x, setup_kernel([1, 3, 3, 1]), 1, 1, (2, 1), "general")
    _check_fir(x, setup_kernel([1, 2, 1]), 1, 2, (1, 1), "general")


@pytest.mark.parametrize("resblock_type", ["biggan", "ddpm"])
def test_ncsnpp_on_card_matches_cpu(cuda, resblock_type):
    m = init_ncsnpp(NCSNpp(image_size=32, nf=32, ch_mult=(1, 2),
                           num_res_blocks=1, attn_resolutions=(16,),
                           resblock_type=resblock_type, init_scale=1.0), 0)
    x = torch.randn(2, 32, 32, 3)
    t = torch.tensor([5.0, 700.0])
    with torch.inference_mode():
        want = m.eval()(x, t)
        before = upfirdn2d.launches
        got = m.to(cuda)(x.to(cuda), t.to(cuda)).cpu()
    assert upfirdn2d.launches > before
    rel = float((got - want).abs().max()) / float(want.abs().max())
    assert rel <= 1e-4


@pytest.mark.parametrize("fused", [True, "bm", "conv"])
def test_unet_kernel_paths_match_plain(cuda, fused):
    kw = dict(input_channels=3, input_height=32, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(16,))
    base = init_weights(VelocityUNet(**kw), 0)
    with torch.no_grad():
        for p in base.parameters():
            p.add_(torch.randn(p.shape) * 0.05)
    m = VelocityUNet(**kw, fused_norm=fused)
    m.load_state_dict(base.state_dict())
    base, m = base.to(cuda), m.to(cuda)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    t = torch.rand(2, device=cuda)
    with torch.inference_mode():
        want, got = base(x, t), m(x, t)
    rel = float((got - want).abs().max()) / float(want.abs().max())
    assert rel <= 1e-4


# ------------------------------------------------------------- training
FLAGSHIP_64 = dict(input_channels=3, input_height=64, ch=32,
                   ch_mult=(1, 2, 4, 8), num_res_blocks=6,
                   attn_resolutions=(16, 8))
SMALL_32 = dict(input_channels=3, input_height=32, ch=32, ch_mult=(1, 2),
                num_res_blocks=1, attn_resolutions=(16,))
NOISE_FLOOR = 1e-6   # of the largest gradient: float32 rounding noise


def _randomized(m, seed):
    """Every parameter drawn at a real scale, so each carries a gradient:
    GroupNorm scales near 1, biases small, weights ~ 1/sqrt(fan_in)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() == 1 and ("norm" in name or name.startswith(
                    "end_conv.0")) and name.endswith("weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g)
                        / p[0].numel() ** 0.5)
    return m


def _pairs(n, dim, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, dim, dim, 3, generator=g),
            0.5 * torch.randn(n, dim, dim, 3, generator=g),
            torch.rand(n, generator=g))


def test_flagship_training_gradients_through_the_gn_kernel(cuda):
    """The flagship U-Net's loss and every gradient with ``fused_norm``
    True (the ``groupnorm_swish`` kernel, 136 launches, plain backward)
    against False on the card, same weights and pairs: loss within rel
    1e-5, each gradient tensor within 1e-4 of its max|g|.  Tensors whose
    gradient is zero in exact arithmetic (rounding noise, below 1e-6 of the
    largest gradient, under False) are held to being noise under True."""
    sd = _randomized(VelocityUNet(**FLAGSHIP_64), 0).state_dict()
    x0, x1, t = (a.to(cuda) for a in _pairs(4, 64, 1))
    out = {}
    for fused in (False, True):
        m = VelocityUNet(**FLAGSHIP_64, fused_norm=fused)
        m.load_state_dict(sd)
        m.to(cuda)
        before = groupnorm_swish_fwd.launches
        loss = fm.make_fm_loss(m)(x0, x1, t)
        loss.backward()
        torch.cuda.synchronize()
        out[fused] = (float(loss.detach()),
                      groupnorm_swish_fwd.launches - before,
                      {n: p.grad for n, p in m.named_parameters()})
    (want, n_plain, gw), (got, n_kernel, gg) = out[False], out[True]
    assert (n_plain, n_kernel) == (0, 136)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    floor = NOISE_FLOOR * max(float(g.abs().max()) for g in gw.values())
    for n, w in gw.items():
        scale = float(w.abs().max())
        if scale < floor:
            assert float(gg[n].abs().max()) < floor, n
            continue
        assert float((gg[n] - w).abs().max()) <= 1e-4 * scale, n


def test_train_step_on_card_matches_cpu(cuda):
    """One precoupled Adam (lr 1e-4) + EMA step with ``fused_norm`` True on
    the card against the same step on the CPU (plain GroupNorm): params and
    EMA within 1e-5, except elements whose two gradients are rounding noise
    (Adam's first step is about lr times the gradient's sign, and noise has
    no sign); Adam's moments within rel 1e-4 of each tensor's max."""
    sd = _randomized(VelocityUNet(**SMALL_32), 2).state_dict()
    x0, x1, t = _pairs(4, 32, 3)
    states = {}
    for dev in ("cpu", cuda):
        m = VelocityUNet(**SMALL_32, fused_norm=True)
        m.load_state_dict(sd)
        st = fm.new_state(m.to(dev), 1e-4)
        fm.make_fm_train_step_precoupled(ema_decay=0.999)(
            st, x0.to(dev), x1.to(dev), t=t.to(dev))
        states[str(dev)] = st
    cpu, card = states["cpu"], states[str(cuda)]
    assert cpu.step == card.step == 1
    pc = dict(cpu.model.named_parameters())
    pg = dict(card.model.named_parameters())
    mus = {n: cpu.optimizer.state[p]["exp_avg"] for n, p in pc.items()}
    floor = NOISE_FLOOR * 10.0 * max(float(v.abs().max())
                                     for v in mus.values())
    for n, p in pc.items():
        sc, sg = cpu.optimizer.state[p], card.optimizer.state[pg[n]]
        g_cpu, g_card = sc["exp_avg"] / 0.1, sg["exp_avg"].cpu() / 0.1
        d = (pg[n].detach().cpu() - p.detach()).abs()
        for i in torch.nonzero(d > 1e-5):
            i = tuple(i.tolist())
            assert max(abs(float(g_cpu[i])), abs(float(g_card[i]))) < floor, (
                n, i, float(d[i]), float(g_cpu[i]), float(g_card[i]))
        ema_err = float((card.ema[n].cpu() - cpu.ema[n]).abs().max())
        assert ema_err <= 1e-5, n
        if float(sc["exp_avg"].abs().max()) >= 0.1 * floor:
            for k in ("exp_avg", "exp_avg_sq"):
                scale = float(sc[k].abs().max())
                assert float((sg[k].cpu() - sc[k]).abs().max()) <= (
                    1e-4 * scale), (n, k)


# ------------------------------------------------- autodiff through kernels
def _differentiated_unets(cuda, fused):
    """The flagship at 64^2 with every parameter random, ``fused`` and
    False on the same weights, frozen as the solvers freeze them."""
    base = _randomized(VelocityUNet(**FLAGSHIP_64), 3)
    m = VelocityUNet(**FLAGSHIP_64, fused_norm=fused)
    m.load_state_dict(base.state_dict())
    return (base.to(cuda).eval().requires_grad_(False),
            m.to(cuda).eval().requires_grad_(False))


@pytest.mark.parametrize("fused", [True, "bm"])
def test_unet_vjp_and_jvp_through_the_gn_kernel(cuda, fused):
    """A VJP and a JVP of the flagship through the GroupNorm kernel against
    the plain GroupNorm, on the card; the kernel launches once per site in
    each forward, its autograd function's rules carry both."""
    base, m = _differentiated_unets(cuda, fused)
    fwd = groupnorm_swish_fwd if fused is True else groupnorm_swish_bm_fwd
    g = torch.Generator(device=cuda).manual_seed(5)
    x, w = (torch.randn(4, 64, 64, 3, generator=g, device=cuda)
            for _ in range(2))
    t = torch.rand(4, generator=g, device=cuda)
    sites = sum(isinstance(mod, torch.nn.GroupNorm) for mod in m.modules())
    out = {}
    for name, model in (("plain", base), ("kernel", m)):
        before = fwd.launches
        xr = x.clone().requires_grad_()
        (vjp,) = torch.autograd.grad(model(xr, t), xr, w)
        _, jvp = torch.func.jvp(lambda z: model(z, t), (x,), (w,))
        torch.cuda.synchronize()
        out[name] = (vjp, jvp, fwd.launches - before)
    for i in range(2):
        want, got = out["plain"][i], out["kernel"][i]
        rel = float((got - want).abs().max()) / float(want.abs().max())
        assert rel <= 1e-4
    assert out["plain"][2] == 0 and out["kernel"][2] == 2 * sites


@pytest.mark.parametrize("kind", [FIR_DOWN, FIR_UP])
@pytest.mark.parametrize("c", [128, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upfirdn2d_gradient_and_jvp_launch_the_kernel(cuda, kind, c, dtype):
    """The FIR's backward is the kernel in the adjoint geometry, its JVP the
    kernel on the tangent: each one launch, counted by role, against
    autograd through the plain version on the card."""
    up, down, pad = kind
    k = _fir_taps(up)
    g = torch.Generator(device=cuda).manual_seed(c + up)
    x = torch.randn(4, 32, 32, c, generator=g, device=cuda).to(dtype)
    y = upfirdn2d_reference(x, k, up=up, down=down, pad=pad)
    dy, dx = (torch.randn(s, generator=g, device=cuda).to(dtype)
              for s in (y.shape, x.shape))
    grads = []
    for fn in (upfirdn2d, upfirdn2d_reference):
        xr = x.clone().requires_grad_()
        before = dict(upfirdn2d.roles)
        (gx,) = torch.autograd.grad(fn(xr, k, up, down, pad), xr, dy)
        grads.append((gx, {r: v - before[r]
                           for r, v in upfirdn2d.roles.items()}))
    (got, roles), (want, plain_roles) = grads
    assert roles == {"forward": 1, "adjoint": 1, "tangent": 0}
    assert plain_roles == dict.fromkeys(roles, 0)
    scale = max(1.0, float(want.float().abs().max()))
    tol = (1e-5 if dtype == torch.float32 else 2e-2) * scale
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= tol
    before = dict(upfirdn2d.roles)
    _, jvp = torch.func.jvp(lambda z: upfirdn2d(z, k, up, down, pad), (x,),
                            (dx,))
    assert {r: v - before[r] for r, v in upfirdn2d.roles.items()} == {
        "forward": 1, "adjoint": 0, "tangent": 1}
    assert torch.equal(jvp, upfirdn2d(dx, k, up, down, pad))


def test_gn_kernel_jvp_rule_at_a_flagship_site(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    x, dx = (torch.randn(4, 16, 16, 256, generator=g, device=cuda)
             for _ in range(2))
    s = torch.randn(256, generator=g, device=cuda) * 0.2 + 1
    b = torch.randn(256, generator=g, device=cuda) * 0.1
    before = groupnorm_swish_fwd.launches
    y, got = torch.func.jvp(lambda z: groupnorm_swish(z, s, b), (x,), (dx,))
    assert groupnorm_swish_fwd.launches == before + 1
    want_y, want = torch.func.jvp(lambda z: gn_swish_reference(z, s, b),
                                  (x,), (dx,))
    assert float((y - want_y).abs().max()) <= 1e-4
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


# ------------------------------------- gradient-step denoiser and DiffPIR
def test_gs_denoiser_and_loss_gradients_through_the_gn_kernel(cuda):
    """The gradient-step denoiser on the flagship at 64^2, 4 images:
    ``calculate_grad``'s Dg with ``fused_norm`` True (the kernel forward,
    the VJP through its plain backward) against False within 1e-4 of
    max|Dg|, and the GS loss's parameter gradient (second order through
    the GroupNorm rules) within 1e-4 of each tensor's max, the noise rule
    as above.  The kernel launches once per site: the loss's backward
    reuses the forward."""
    from pnpflow_tpu_torch.training.denoiser import (
        calculate_grad, denoiser_forward)

    sd = _randomized(VelocityUNet(**FLAGSHIP_64), 4).state_dict()
    g = torch.Generator(device=cuda).manual_seed(7)
    y = 0.5 * torch.randn(4, 64, 64, 3, generator=g, device=cuda)
    x = y + 0.1 * torch.randn(y.shape, generator=g, device=cuda)
    sv = torch.full((4,), 0.1, device=cuda)
    out = {}
    for fused in (False, True):
        m = VelocityUNet(**FLAGSHIP_64, fused_norm=fused)
        m.load_state_dict(sd)
        m.to(cuda)
        before = groupnorm_swish_fwd.launches
        with torch.no_grad():
            dg, _ = calculate_grad(m, x, sv)
        mid = groupnorm_swish_fwd.launches
        x_hat, _ = denoiser_forward(m, x, sv, create_graph=True)
        loss = ((x_hat - y) ** 2).reshape(4, -1).mean(dim=1).mean()
        grads = torch.autograd.grad(loss, list(m.parameters()))
        torch.cuda.synchronize()
        out[fused] = (dg, float(loss.detach()),
                      dict(zip([n for n, _ in m.named_parameters()], grads)),
                      (mid - before, groupnorm_swish_fwd.launches - mid))
    (dgw, lw, gw, nw), (dgg, lg, gg, ng) = out[False], out[True]
    sites = sum(isinstance(mod, torch.nn.GroupNorm)
                for mod in VelocityUNet(**FLAGSHIP_64).modules())
    assert nw == (0, 0) and ng == (sites, sites)
    assert float((dgg - dgw).abs().max()) <= 1e-4 * float(dgw.abs().max())
    assert abs(lg - lw) <= 1e-5 * abs(lw)
    floor = NOISE_FLOOR * max(float(v.abs().max()) for v in gw.values())
    for n, w in gw.items():
        scale = float(w.abs().max())
        if scale < floor:
            assert float(gg[n].abs().max()) < floor, n
            continue
        assert float((gg[n] - w).abs().max()) <= 1e-4 * scale, n


def test_pnp_gs_backtracking_on_card_matches_cpu(cuda):
    """Three hqs deblurring iterations of pnp_gs (the backtracking decided
    on the device) on the card against the CPU, same small U-Net: within
    1e-4, the same alpha."""
    from pnpflow_tpu_torch.ops.degradations import GaussianDeblurring
    from pnpflow_tpu_torch.solvers.pnp_gs import make_pnp_gs_solver

    sd = _randomized(VelocityUNet(**SMALL_32), 5).state_dict()
    y = 0.5 * torch.randn(2, 32, 32, 3, generator=torch.Generator()
                          .manual_seed(8))
    res = {}
    for dev in ("cpu", cuda):
        m = VelocityUNet(**SMALL_32, fused_norm=True)
        m.load_state_dict(sd)
        m.to(dev).requires_grad_(False)
        op = GaussianDeblurring(1.0, 9, 3, 32, device=dev)
        solve = make_pnp_gs_solver(
            m, op, problem="gaussian_deblurring_FFT", algo="hqs",
            noise_type="gaussian", sigma_noise=0.05, lr_pnp=1.0,
            sigma_factor=1.0, max_iter=30)
        with torch.no_grad():
            x, a = solve(y.to(dev), op.H_adj(y.to(dev)),
                         torch.tensor(2.0, device=dev), 0, 3)
        res[str(dev)] = (x.cpu(), float(a))
    (xc, ac), (xg, ag) = res["cpu"], res[str(cuda)]
    assert ac == ag
    assert float((xg - xc).abs().max()) <= 1e-4 * max(
        1.0, float(xc.abs().max()))


DIFF_MID = dict(in_channels=3, out_channels=6, model_channels=64,
                channel_mult=(1, 2, 2), num_res_blocks=1,
                attention_ds=(2, 4), num_head_channels=32)


def _diffunet_state(seed):
    from pnpflow_tpu_torch.models.diffunet import (
        DiffUNet, init_diffunet_real_scale)

    return init_diffunet_real_scale(DiffUNet(**DIFF_MID), seed).state_dict()


def test_diffunet_and_diffpir_on_card_match_cpu(cuda):
    """A DiffUNet with every parameter at a real scale (64 channels, mult
    1,2,2, attention at ds 2 and 4) at 64^2: the forward within 1e-4 of
    max|out|, and 5 DiffPIR inpainting steps from the same noise within
    1e-4, card against CPU."""
    from pnpflow_tpu_torch.models.diffunet import DiffUNet
    from pnpflow_tpu_torch.ops.degradations import BoxInpainting
    from pnpflow_tpu_torch.solvers import pnp_diff

    sd = _diffunet_state(6)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 64, 64, 3, generator=g)
    t = torch.tensor([40.0, 900.0])
    y01 = torch.rand(2, 64, 64, 3, generator=g)
    noise = [torch.randn(2, 64, 64, 3, generator=g) for _ in range(6)]
    res = {}
    for dev in ("cpu", cuda):
        m = DiffUNet(**DIFF_MID)
        m.load_state_dict(sd)
        m.to(dev).eval()
        op = BoxInpainting(10, 64, device=dev)
        solve = pnp_diff.make_diffpir_solver(
            m, pnp_diff.make_prox("inpainting", op, 0.05, "gaussian"),
            op.H_adj, lmbda=7.0, zeta=0.3, max_iter=5, sigma_noise=0.05)
        with torch.inference_mode():
            res[str(dev)] = (m(x.to(dev), t.to(dev)).cpu(),
                             solve(op.H(y01.to(dev)),
                                   noise_seq=noise).cpu())
    for i in range(2):
        want, got = res["cpu"][i], res[str(cuda)][i]
        scale = float(want.abs().max())
        assert scale > 0.1
        assert float((got - want).abs().max()) <= 1e-4 * scale


# ------------------------------------------------ the metric stack, remat
def _metric_weights(root):
    """The synthetic Inception and seeded LPIPS npz files under root."""
    import os

    import numpy as np

    from pnpflow_tpu_torch.utils import inception_convert, lpips_convert

    os.makedirs(root / "model", exist_ok=True)
    inception_convert.main("--synthetic",
                           str(root / "model" / "inception_fid.npz"))
    np.savez(root / "model" / "lpips_alex.npz",
             **lpips_convert.synthetic_weights(0))


def test_inception_and_lpips_on_card_match_cpu(cuda, tmp_path):
    """pool3 within 1e-4 of its max, the probabilities within 1e-5, LPIPS
    within 1e-5 relative: the card against the CPU on the same weights."""
    from pnpflow_tpu_torch.metrics.lpips import get_lpips_fn
    from pnpflow_tpu_torch.models.inception import get_inception_fns
    from pnpflow_tpu_torch.utils.config import CfgNode

    _metric_weights(tmp_path)
    args = CfgNode(dict(output_root=str(tmp_path)))
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 64, 64, 3, generator=g)
    want = get_inception_fns(args, device="cpu")[1](x)
    got = get_inception_fns(args, device=cuda)[1](x.to(cuda))
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-4 * float(
        want[0].abs().max())
    assert float((got[1].cpu() - want[1]).abs().max()) <= 1e-5
    y = (2 * x - 1).clamp(-1, 1)
    z = (y + 0.1 * torch.randn(y.shape, generator=g)).clamp(-1, 1)
    with torch.inference_mode():
        lw = float(get_lpips_fn(args, "cpu")(y, z))
        lg = float(get_lpips_fn(args, cuda)(y.to(cuda), z.to(cuda)))
    assert abs(lg - lw) <= 1e-5 * abs(lw)


def test_metric_networks_default_to_the_card_and_refuse_host_images(
        cuda, tmp_path):
    """Without a device both networks run on the card, and images left on
    the host raise instead of being copied."""
    from pnpflow_tpu_torch.metrics.lpips import get_lpips_fn
    from pnpflow_tpu_torch.models.inception import get_inception_fns
    from pnpflow_tpu_torch.utils.config import CfgNode

    _metric_weights(tmp_path)
    args = CfgNode(dict(output_root=str(tmp_path)))
    feature_fn, outputs_fn = get_inception_fns(args)
    x = torch.rand(1, 64, 64, 3)
    assert feature_fn(x.to(cuda)).device.type == "cuda"
    for fn in (feature_fn, outputs_fn):
        with pytest.raises(ValueError, match="on cpu"):
            fn(x)
    lp = get_lpips_fn(args)
    assert next(lp.parameters()).device.type == "cuda"
    with pytest.raises(RuntimeError), torch.inference_mode():
        lp(2 * x - 1, 2 * x - 1)


def test_flow_priors_remat_through_the_gn_kernel(cuda):
    """The JVP checkpointed whole, recomputed in the gradient through the
    GroupNorm kernel's forward-mode rule: the same result as without,
    within 1e-5 of its max, with the kernel launched again in the
    recomputation."""
    from pnpflow_tpu_torch.ops.degradations import Denoising
    from pnpflow_tpu_torch.solvers.base import ModelBundle
    from pnpflow_tpu_torch.solvers.flow_priors import FlowPriors
    from pnpflow_tpu_torch.utils.config import CfgNode

    model = _randomized(VelocityUNet(**FLAGSHIP_64, fused_norm=True), 4)
    model = model.to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(6)
    clean = torch.rand(4, 64, 64, 3, generator=g, device=cuda) * 2 - 1
    noisy = clean + 0.05 * torch.randn(clean.shape, generator=g, device=cuda)
    x_init = torch.randn(clean.shape, generator=g, device=cuda)
    out = {}
    for remat in (False, True):
        solver = FlowPriors(ModelBundle(model=model, device=cuda,
                                        remat=remat),
                            CfgNode(dict(N=2, K=1, lmbda=1000.0, eta=0.01,
                                         start_time=0.0,
                                         noise_type="gaussian")))
        before = groupnorm_swish_fwd.launches
        with solver.grad_mode():
            x, _ = solver.solve_batch(clean, noisy, Denoising(), 0.05, 0,
                                      x_init=x_init)
        torch.cuda.synchronize()
        out[remat] = (x, groupnorm_swish_fwd.launches - before)
    assert float((out[True][0] - out[False][0]).abs().max()) <= 1e-5 * float(
        out[False][0].abs().max())
    sites = sum(isinstance(m, torch.nn.GroupNorm) for m in model.modules())
    # N * K JVPs, each run once more in the gradient
    assert out[False][1] > 0 and out[True][1] == out[False][1] + 2 * sites


# ------------------------------------------------- the rectified-flow zoo
def _rf_model(dev, sd=None):
    from pnpflow_tpu_torch.config.rf_configs import get_config
    from pnpflow_tpu_torch.models.zoo import create_model
    from pnpflow_tpu_torch.rf_main import RFModel

    cfg = get_config("celeba_hq_pytorch_rf_gaussian")
    cfg.data.image_size, cfg.model.nf = 32, 32
    cfg.model.ch_mult, cfg.model.num_res_blocks = (1, 2), 1
    m = create_model(cfg)
    if sd is None:
        _randomized(m, 31)
    else:
        m.load_state_dict(sd)
    return RFModel(m).to(dev).eval()


def test_rf_train_step_gradients_through_the_fir_kernel(cuda):
    """rf_main's loss and every gradient of the CelebA-HQ NCSN++ (cut to
    32x32) on the card, the FIR kernel and its adjoint, against the CPU's
    plain FIR: loss rel 1e-5, gradients within 1e-4 of each max (the
    NOISE_FLOOR rule)."""
    sd = _rf_model("cpu").model.state_dict()
    x0, x1, t = _pairs(4, 32, 7)
    out = {}
    for dev in ("cpu", cuda):
        rf = _rf_model(dev, sd)
        before = dict(upfirdn2d.roles)
        loss = fm.make_fm_loss(rf)(x0.to(dev), x1.to(dev), t.to(dev))
        loss.backward()
        torch.cuda.synchronize()
        roles = {k: upfirdn2d.roles[k] - before[k] for k in before}
        out[str(dev)] = (float(loss), {n: p.grad.cpu() for n, p in
                                       rf.named_parameters()
                                       if p.grad is not None}, roles)
    (lw, gw, rw), (lg, gg, rg) = out["cpu"], out[str(cuda)]
    assert rw == {"forward": 0, "adjoint": 0, "tangent": 0}
    assert rg["forward"] > 0 and rg["adjoint"] > 0 and rg["tangent"] == 0
    assert abs(lg - lw) <= 1e-5 * abs(lw)
    floor = NOISE_FLOOR * max(float(v.abs().max()) for v in gw.values())
    for n, w in gw.items():
        scale = float(w.abs().max())
        if scale < floor:
            assert float(gg[n].abs().max()) < floor, n
            continue
        assert float((gg[n] - w).abs().max()) <= 1e-4 * scale, n


def test_rf_likelihood_jvp_through_the_fir_kernel(cuda):
    """The Hutchinson divergence (one JVP a probe, the FIR kernel on the
    tangent) and a 2-step bits/dim on the card against the CPU with the
    same probes: within 1e-4 relative."""
    from pnpflow_tpu_torch.ops.likelihood import (
        bits_per_dim, divergence_hutchinson, rademacher)

    sd = _rf_model("cpu").model.state_dict()
    g = torch.Generator().manual_seed(8)
    x = torch.tanh(torch.randn(2, 32, 32, 3, generator=g))
    t = torch.tensor([0.3, 0.9])
    probes = [rademacher(x.shape, g) for _ in range(2)]
    steps = [torch.stack([rademacher(x.shape, g)]) for _ in range(2)]
    out = {}
    for dev in ("cpu", cuda):
        rf = _rf_model(dev, sd)
        before = upfirdn2d.roles["tangent"]
        div = divergence_hutchinson(rf, x.to(dev), t.to(dev),
                                    probes=[p.to(dev) for p in probes])
        bpd = bits_per_dim(rf, x.to(dev), steps=2, probes=steps)
        torch.cuda.synchronize()
        out[str(dev)] = (div.cpu(), bpd.cpu(),
                         upfirdn2d.roles["tangent"] - before)
    (dw, bw, nw), (dg, bg, ng) = out["cpu"], out[str(cuda)]
    assert nw == 0 and ng > 0
    assert float((dg - dw).abs().max()) <= 1e-4 * float(dw.abs().max())
    assert float((bg - bw).abs().max()) <= 1e-4 * float(bw.abs().max())


# ------------------------------------------------------ data parallelism
def _dp_steps(cuda, sd, x0, x1, t, u, root):
    """One precoupled flow-matching step and one gradient-step denoiser
    step with ``fused_norm`` True on the card from ``sd``; their losses and
    parameters."""
    from pnpflow_tpu_torch.training import denoiser as td
    from pnpflow_tpu_torch.utils.config import CfgNode

    out = {}
    m = VelocityUNet(**SMALL_32, fused_norm=True)
    m.load_state_dict(sd)
    st = fm.new_state(m.to(cuda), 1e-4)
    out["fm"] = fm.make_fm_train_step_precoupled()(
        st, x0.to(cuda), x1.to(cuda), t=t.to(cuda))
    out["fm_p"] = {k: v.clone() for k, v in m.state_dict().items()}
    m = VelocityUNet(**SMALL_32, fused_norm=True)
    tr = td.GradientStepTrainer(CfgNode({
        "dataset": "synthetic", "model": "gradient_step", "dim_image": 32,
        "num_channels": 3, "lr": 1e-4, "num_epoch": 1, "seed": 0,
        "output_root": str(root), "batch_size_train": 4,
        "device": str(cuda)}), model=m)
    gs = tr.init_state()
    m.load_state_dict(sd)
    out["gs"], _ = tr.train_step(gs, x1.to(cuda), 0.13, u=u.to(cuda))
    out["gs_p"] = {k: v.clone() for k, v in m.state_dict().items()}
    return out


def test_world_size_one_nccl_step_equals_the_plain_step(cuda, monkeypatch,
                                                        tmp_path):
    """Both trainers' steps under an NCCL process group of one rank equal
    the steps without it, bit for bit: the all-reduce of one rank's
    gradients and loss is the identity."""
    import socket

    import torch.distributed as dist

    from pnpflow_tpu_torch.parallel import mesh

    sd = _randomized(VelocityUNet(**SMALL_32), 4).state_dict()
    x0, x1, t = _pairs(4, 32, 3)
    u = torch.randn(x1.shape, generator=torch.Generator().manual_seed(9))
    # cuDNN's default backward algorithms may add in a run-dependent order
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    plain = _dp_steps(cuda, sd, x0, x1, t, u, tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert mesh.init_distributed(cuda) and dist.get_backend() == "nccl"
    try:
        dp = _dp_steps(cuda, sd, x0, x1, t, u, tmp_path)
    finally:
        dist.destroy_process_group()
    for k in ("fm", "gs"):
        assert torch.equal(dp[k], plain[k]), k
        for n, v in plain[k + "_p"].items():
            assert torch.equal(dp[k + "_p"][n], v), (k, n)


def test_trainers_and_prefetch_take_the_ranks_card(monkeypatch, tmp_path):
    """Under a process group, a bare ``cuda`` is the card ``LOCAL_RANK``
    names (the last visible one here): both trainers hold it with its
    index, and the batches their prefetch thread makes lie on it, made
    while it is the thread's current card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import numpy as np
    import torch.distributed as dist

    from pnpflow_tpu_torch.data.prefetch import prefetch
    from pnpflow_tpu_torch.parallel import mesh
    from pnpflow_tpu_torch.training import denoiser as td
    from pnpflow_tpu_torch.utils.config import CfgNode

    card = torch.cuda.device_count() - 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", LOCAL_RANK=str(card), WORLD_SIZE="1",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    before = torch.cuda.current_device()
    assert mesh.init_distributed("cuda")
    try:
        args = dict(dataset="synthetic", dim_image=32, num_channels=3,
                    lr=1e-4, num_epoch=1, seed=0, batch_size_train=4,
                    output_root=str(tmp_path), device="cuda")
        gs = td.GradientStepTrainer(CfgNode(dict(args, model="gradient_step")),
                                    model=VelocityUNet(**SMALL_32))
        ot = fm.FlowMatchingTrainer(CfgNode(dict(args, model="indep")),
                                    model=VelocityUNet(**SMALL_32))
        want = torch.device("cuda", card)
        assert gs.device == ot.device == want
        made_on = []

        def batches():
            for i in range(3):
                made_on.append(torch.cuda.current_device())
                yield np.full((4, 32, 32, 3), i, np.float32), None

        got = [x for x, _ in prefetch(batches(), device=gs.device)]
        assert made_on == [card] * 3
        assert all(x.device == want for x in got)
    finally:
        dist.destroy_process_group()
        torch.cuda.set_device(before)


def cli_train_losses(out, opts, nproc=None, device="cuda",
                     timeout=600) -> list:
    """The losses that ``train True`` logs through the CLI in
    ``loss_training.txt``: one process, or ``nproc`` under ``torchrun``
    (one rank per card, gloo on the CPU).  A failing run raises with its
    output."""
    import glob
    import os
    import subprocess
    import sys

    launch = ([] if nproc is None else
              ["-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc)])
    cmd = [sys.executable, *launch, "-m", "pnpflow_tpu_torch", "--opts",
           *opts, "train", "True", "eval", "False", "seed", "0",
           "output_root", str(out), "device", device]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    (path,) = glob.glob(os.path.join(str(out), "**", "loss_training.txt"),
                        recursive=True)
    with open(path) as f:
        return [float(line.rsplit(maxsplit=1)[-1]) for line in f]


# a global batch of 16 over every card: exact OT on the host, Sinkhorn and
# independent coupling on the card, and the gradient-step denoiser (one
# epoch of the synthetic train split)
DP_RUNS = {
    "fm_exact": ["model", "ot", "max_iters_per_epoch", "3"],
    "fm_sinkhorn": ["model", "ot", "ot_method", "sinkhorn",
                    "max_iters_per_epoch", "3"],
    "fm_indep": ["model", "indep", "max_iters_per_epoch", "3"],
    "gs": ["model", "gradient_step"],
}


@pytest.mark.parametrize("run", list(DP_RUNS))
def test_data_parallel_training_on_every_card_equals_one_card(run,
                                                              tmp_path):
    """``torchrun --nproc_per_node <cards>`` trains through the CLI (the
    flagship U-Net at 32^2, a global batch of 16) to the losses that one
    process on one card logs: the first step's within 1e-5 relative (the
    ranks' sums add in another order), the later ones within 1e-3 (Adam's
    first step moves the weights whose gradient lies near zero by up to
    two learning rates either way).  Needs two cards or more."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    opts = ["dataset", "synthetic", "dim_image", "32", "num_epoch", "1",
            "batch_size_train", "16", *DP_RUNS[run]]
    want = cli_train_losses(tmp_path / "one", opts)
    got = cli_train_losses(tmp_path / "all", opts, nproc=n)
    assert len(got) == len(want) > 1
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    assert rel[0] <= 1e-5 and max(rel) <= 1e-3, rel


def test_sharded_restorer_equals_unsharded_on_the_card(tmp_path):
    """``Restorer(shard=True, n_devices=1)`` against ``shard=False`` on the
    same request (pnp_flow, the U-Net "conv" path at 64^2), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings

    from pnpflow_tpu_torch.serve import Restorer

    kw = dict(problem="gaussian_deblurring_FFT", dim_image=64, batch_size=4,
              overrides={"steps_pnp": 5, "num_samples": 2},
              output_root=str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plain = Restorer(**kw)
        sharded = Restorer(**kw, shard=True, n_devices=1)
    clean = torch.rand((4, 64, 64, 3), generator=torch.Generator()
                       .manual_seed(1)) * 2 - 1
    y = plain.degrade(clean, seed=2)
    before = conv3x3_gn.launches
    got = sharded.restore(y.cpu(), seed=3)
    assert conv3x3_gn.launches > before
    assert (got == plain.restore(y, seed=3)).all()


# the restorations that couple a batch's images: (Restorer keywords,
# model); sharded, one solver on the first card, its network fanned out
COUPLED = {
    "d_flow": dict(method="d_flow", problem="gaussian_deblurring_FFT",
                   dim_image=64, overrides={"max_iter": 1, "LBFGS_iter": 1,
                                            "steps_euler": 3}),
    "ot_ode_bicubic": dict(method="ot_ode", problem="superresolution_bicubic",
                           dim_image=32, overrides={"steps_ode": 5}),
    "pnp_gs_hqs_deblur": dict(method="pnp_gs", model="gradient_step",
                              problem="gaussian_deblurring_FFT", dim_image=64,
                              overrides={"algo": "hqs", "max_iter": 2}),
}


@pytest.mark.parametrize("layout", ["two_on_one_card", "every_card"])
@pytest.mark.parametrize("name", list(COUPLED))
def test_coupled_restoration_sharded_over_cards(cuda, name, layout,
                                                tmp_path, monkeypatch):
    """``Restorer(shard=True)`` of d_flow, ot_ode on bicubic SR and pnp_gs
    hqs deblurring (the flagship with real-scale random weights, fp32, cuDNN
    deterministic) against ``shard=False``: two shards on card 0, or one on
    every visible card (two cards or more).  ot_ode and pnp_gs within 1e-4
    of max.  d_flow's dopri5 inversion amplifies rounding on these weights:
    its sharded restore is held to the larger of 1e-4 and three times the
    unsharded run's change on a measurement changed by 1e-7 relative, and
    from the unsharded run's latent its LBFGS and flow to 1e-4.  Each shard
    launches the GroupNorm kernel on its own card, as often as every other
    shard, and the kernel matches its plain version there."""
    import collections
    import warnings

    import numpy as np

    from pnpflow_tpu_torch.models.registry import (
        checkpoint_paths, model_fingerprint, save_params_file)
    from pnpflow_tpu_torch.serve import Restorer
    from pnpflow_tpu_torch.solvers import d_flow
    from pnpflow_tpu_torch.utils.jax_params import flax_from_state_dict

    n = torch.cuda.device_count()
    if layout == "every_card" and n < 2:
        pytest.skip("needs two CUDA devices or more")
    devs = ["cuda:0"] * 2 if layout == "two_on_one_card" else [
        f"cuda:{i}" for i in range(n)]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = dict(COUPLED[name], batch_size=2 * len(devs),
              output_root=str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plain = Restorer(**kw)
    m = plain.bundle.model
    _randomized(m, 7)
    save_params_file(flax_from_state_dict(m.state_dict()),
                     checkpoint_paths(plain.args)["msgpack"],
                     fingerprint=model_fingerprint(m, plain.args))
    sharded = Restorer(**kw, shard=True, devices=devs)
    dim = kw["dim_image"]
    g = torch.Generator().manual_seed(1)
    clean = torch.rand((len(devs) * 2, dim, dim, 3), generator=g) * 2 - 1
    y = plain.degrade(clean, seed=2).cpu()
    starts, solve = [], d_flow.lbfgs_solve

    def record(loss_fn, z, **kw):
        starts.append(z.detach().clone())
        return solve(loss_fn, z, **kw)

    monkeypatch.setattr(d_flow, "lbfgs_solve", record)
    want = plain.restore(y, seed=3)

    def rel(a):
        return float(np.abs(a - want).max() / np.abs(want).max())

    bar = 1e-4
    if name == "d_flow":
        wiggle = 1.0 + 1e-7 * torch.randn(y.shape, generator=g)
        spread = rel(plain.restore(y * wiggle, seed=3))
        bar = max(bar, 3 * spread)
    groupnorm_swish_fwd.cards.clear()
    before = groupnorm_swish_fwd.launches
    got = sharded.restore(y, seed=3)
    launched = groupnorm_swish_fwd.launches - before
    forwards = sharded.solver.model.model.forwards
    by_card = dict(groupnorm_swish_fwd.cards)
    print(f"{name} on {devs}: {rel(got):.3g} of max from unsharded, "
          f"bar {bar:.3g}, {forwards} forwards")
    assert np.isfinite(got).all() and rel(got) <= bar, rel(got)
    if name == "d_flow":
        # as restore runs it: the backward in this thread
        with sharded.solver.grad_mode(), \
                torch.autograd.set_multithreading_enabled(False):
            x, _ = sharded.solver.solve_batch(
                None, y.to(sharded.home), sharded.home_degradation,
                sharded.sigma_noise, 3, z_init=starts[0].to(sharded.home))
        print(f"d_flow from the unsharded latent: "
              f"{rel(x.cpu().numpy()):.3g} of max")
        assert rel(x.cpu().numpy()) <= 1e-4
    shards = collections.Counter(torch.device(d).index for d in devs)
    norms = sum(isinstance(mod, torch.nn.GroupNorm) for mod in m.modules())
    per_shard = norms * forwards
    assert launched == per_shard * len(devs)
    assert by_card == {k: v * per_shard for k, v in shards.items()}
    for idx in shards:
        dev = torch.device("cuda", idx)
        gd = torch.Generator(device=dev).manual_seed(idx)
        x = torch.randn(2, 16, 16, 128, generator=gd, device=dev)
        s = 1.0 + 0.2 * torch.randn(128, generator=gd, device=dev)
        b = 0.1 * torch.randn(128, generator=gd, device=dev)
        y1 = groupnorm_swish_fwd(x, s, b)
        assert y1.device == dev
        assert float((y1 - gn_swish_reference(x, s, b)).abs().max()) <= 1e-4
