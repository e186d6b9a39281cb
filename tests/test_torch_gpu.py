"""Card-only tests of the port's kernels: each against its plain version on
CUDA tensors.  They skip, from inside a fixture, where no GPU is visible.

Run on a GPU machine with ``python -m pytest --noconftest -p
no:cacheprovider -m gpu tests/test_torch_gpu.py``; ``--noconftest`` because
``tests/conftest.py`` imports JAX, which a GPU machine need not have.
"""

import pytest
import torch

from pnpflow_tpu_torch.ops.fused_conv_gn import (
    channel_moments, conv3x3_gn, conv3x3_gn_reference, gn_prologue)
from pnpflow_tpu_torch.ops.gn_swish import (
    gn_swish_reference, groupnorm_swish, groupnorm_swish_fwd)
from pnpflow_tpu_torch.ops.gn_swish_bm import (
    groupnorm_swish_bm, groupnorm_swish_bm_fwd)
from pnpflow_tpu_torch.ops.upfirdn import (
    setup_kernel, upfirdn2d, upfirdn2d_reference)
from pnpflow_tpu_torch.models.ncsnpp import NCSNpp, init_ncsnpp
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("hw,c,swish", [(64, 96, True), (32, 192, True),
                                        (16, 128, False), (8, 512, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_swish_kernel(cuda, hw, c, swish, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, hw, hw, c, generator=g, device=cuda).to(dtype)
    s = torch.randn(c, generator=g, device=cuda) * 0.2 + 1
    b = torch.randn(c, generator=g, device=cuda) * 0.1
    before = groupnorm_swish_fwd.launches
    y = groupnorm_swish_fwd(x, s, b, 32, 1e-6, swish)
    torch.cuda.synchronize()
    assert groupnorm_swish_fwd.launches == before + 1
    want = gn_swish_reference(x, s, b, 32, 1e-6, swish)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert float((y.float() - want.float()).abs().max()) <= tol


def test_groupnorm_swish_backward_on_card(cuda):
    x = torch.randn(2, 8, 8, 64, device=cuda, requires_grad=True)
    s = torch.ones(64, device=cuda, requires_grad=True)
    b = torch.zeros(64, device=cuda, requires_grad=True)
    groupnorm_swish(x, s, b).sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("flags", range(8))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_gn_kernel(cuda, flags, dtype):
    n, h, c, co = 3, 16, 64, 128
    g = torch.Generator(device=cuda).manual_seed(flags)
    x = torch.randn(n, h, h, c, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 3, c, co, generator=g, device=cuda) / 24).to(dtype)
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
    y, m = conv3x3_gn(x, w, b, **kw)
    torch.cuda.synchronize()
    y2, m2 = conv3x3_gn_reference(x, w, b, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(y2.float().abs().max())
    assert float((y.float() - y2.float()).abs().max()) <= tol * scale
    assert float((m - m2).abs().max()) <= tol * float(m2.abs().max())


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


@pytest.mark.parametrize("hw,c,swish", [(64, 96, True), (32, 192, True),
                                        (16, 128, False), (8, 512, True),
                                        (7, 32, True), (64, 3 * 32, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_swish_bm_kernel(cuda, hw, c, swish, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(5, hw, hw, c, generator=g, device=cuda) * 2 + 0.5).to(
        dtype)
    s = torch.randn(c, generator=g, device=cuda) * 0.2 + 1
    b = torch.randn(c, generator=g, device=cuda) * 0.1
    before = groupnorm_swish_bm_fwd.launches
    y = groupnorm_swish_bm_fwd(x, s, b, 32, 1e-6, swish)
    torch.cuda.synchronize()
    assert groupnorm_swish_bm_fwd.launches == before + 1
    want = gn_swish_reference(x, s, b, 32, 1e-6, swish)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert y.dtype == dtype
    assert float((y.float() - want.float()).abs().max()) <= tol
    # the two-phase kernel reduces in a fixed order: it repeats exactly
    assert torch.equal(y, groupnorm_swish_bm_fwd(x, s, b, 32, 1e-6, swish))


def test_groupnorm_swish_bm_backward_on_card(cuda):
    x = torch.randn(2, 8, 8, 64, device=cuda, requires_grad=True)
    s = torch.ones(64, device=cuda, requires_grad=True)
    b = torch.zeros(64, device=cuda, requires_grad=True)
    groupnorm_swish_bm(x, s, b).sum().backward()
    assert torch.isfinite(x.grad).all()


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
