"""The port's pnp_flow solver, metrics and CLI against the JAX package.

JAX's CLI draws its own measurement and MC noise, so the parity bar is the
solver and the metrics on identical inputs: the same parameters (carried
across with ``state_dict_from_flax``), measurement and ``eps_seq``.

Bounds: 20-step solve max-abs 1e-4 at float32 (float32 rounding through 20
U-Net or NCSN++ forwards); PSNR 1e-4 dB; SSIM 1e-5.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.metrics.image_quality import psnr as jpsnr, ssim as jssim
from pnpflow_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.ops.degradations import GaussianDeblurring as JaxBlur
from pnpflow_tpu.solvers.pnp_flow import make_pnp_flow_solver as jax_solver
from pnpflow_tpu_torch.main import main
from pnpflow_tpu_torch.metrics.image_quality import psnr, ssim
from pnpflow_tpu_torch.models.ncsnpp import NCSNpp
from pnpflow_tpu_torch.models.registry import RectifiedAdapter
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.ops.degradations import GaussianDeblurring
from pnpflow_tpu_torch.solvers.base import draw_noise, measure
from pnpflow_tpu_torch.solvers.pnp_flow import (
    make_pnp_flow_solver, report_points)
from pnpflow_tpu_torch.utils.jax_params import (
    ncsnpp_state_dict_from_flax, state_dict_from_flax)

DIM, B, S, STEPS = 32, 2, 2, 20
CFG = dict(input_channels=3, input_height=DIM, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params():
    """JAX init with the near-zero output convs redrawn, so v is not ~0."""
    x = jnp.zeros((1, DIM, DIM, 3))
    params = JaxUNet(**CFG).init(jax.random.PRNGKey(0), x, jnp.zeros((1,)))
    rng = np.random.default_rng(5)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name and ("end_conv" in name or "conv2" in name
                                 or "proj_out" in name):
            fan_in = np.prod(leaf.shape[:-1])
            return jnp.asarray(rng.normal(size=leaf.shape) / np.sqrt(fan_in),
                               jnp.float32) * 0.5
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, params)


@pytest.mark.parametrize("fused", [False, "conv"])
def test_solver_matches_jax_with_shared_noise(fused):
    params = _params()
    rng = np.random.default_rng(0)
    clean = np.tanh(rng.normal(size=(B, DIM, DIM, 3)) * 0.3).astype(np.float32)
    eps = rng.normal(size=(STEPS, S, B, DIM, DIM, 3)).astype(np.float32)
    jop = JaxBlur(1.0, 9, "fft", 3, DIM)
    y = np.asarray(jop.H(jnp.asarray(clean))) + 0.05 * rng.normal(
        size=clean.shape).astype(np.float32)
    kw = dict(steps=STEPS, num_samples=S, lr_pnp=1.0,
              gamma_style="alpha_1_minus_t", alpha=1.0, noise_type="gaussian",
              sigma_noise=0.05)

    jm = JaxUNet(**CFG)
    jsolve = jax_solver(jm.apply, jop.H, jop.H_adj, eps_seq=eps, **kw)
    x0 = jop.H_adj(jnp.ones_like(jnp.asarray(y)))
    want = np.asarray(jsolve(params, jnp.asarray(y), x0,
                             jax.random.PRNGKey(1),
                             jnp.asarray(0, jnp.int32), STEPS))

    model = VelocityUNet(**CFG, fused_norm=fused)
    model.load_state_dict(state_dict_from_flax(params))
    top = GaussianDeblurring(1.0, 9, 3, DIM, device="cpu")
    solve = make_pnp_flow_solver(model, top.H, top.H_adj,
                                 eps_seq=torch.from_numpy(eps), **kw)
    ty = torch.from_numpy(y)
    with torch.inference_mode():
        got = solve(ty, top.H_adj(torch.ones_like(ty)), None, 0, STEPS)
    assert np.isfinite(want).all() and np.abs(want - np.asarray(x0)).max() > 0.1
    assert np.abs(got.numpy() - want).max() < 1e-4


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(3, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(psnr(ta, tb)) - float(jpsnr(a, b))) < 1e-4
    assert abs(float(ssim(ta, tb)) - float(jssim(a, b))) < 1e-5


def test_report_points_follow_reference():
    assert report_points(100) == [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]
    assert report_points(3) == [0, 1, 2]


def test_cli_writes_reference_file_set(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    args = main(["--opts", "dataset", "synthetic", "model", "ot", "eval",
                 "True", "method", "pnp_flow", "problem",
                 "gaussian_deblurring_FFT", "steps_pnp", "2", "num_samples",
                 "1", "batch_size_ip", "1", "max_batch", "1",
                 "save_results", "True", "compute_time", "True",
                 "output_root", str(tmp_path), "device", "cpu"])
    ip_dir = args.save_path_ip
    for fname in [
        "psnr_rec_batch0.txt", "psnr_noisy_batch0.txt", "ssim_rec_batch0.txt",
        "psnr_rec_average.txt", "ssim_rec_average.txt", "time_stats.txt",
        "time_average.txt", "gaussian_deblurring_FFT_pnp_flow_batch0_final.png",
    ]:
        assert os.path.exists(os.path.join(ip_dir, fname)), fname
    assert not os.path.exists(os.path.join(ip_dir, "memory_stats.txt"))
    for fname in ["final_psnr.txt", "final_ssim.txt"]:
        assert os.path.exists(os.path.join(args.save_path, fname)), fname
    with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
        header = f.readline().split()
        row = f.readline().split()
    assert header == ["psnr_rec", "psnr_noisy", "steps_pnp", "lr_pnp",
                      "gamma_style", "num_samples", "alpha"]
    assert np.isfinite(float(row[0]))
    with open(os.path.join(ip_dir, "psnr_rec_batch0.txt")) as f:
        assert [ln.split()[0] for ln in f] == ["0", "1", "1"]


def _solver(args):
    from pnpflow_tpu_torch.solvers.base import ModelBundle
    from pnpflow_tpu_torch.solvers.pnp_flow import PnPFlow

    model = VelocityUNet(**CFG).eval()
    return PnPFlow(ModelBundle(model=model, device=torch.device("cpu")), args)


def test_solve_ip_stops_at_dataset_end():
    """max_batch beyond the split ends like the reference's
    enumerate+break loop, not with StopIteration."""
    from pnpflow_tpu_torch.utils.config import CfgNode

    args = CfgNode(dict(steps_pnp=2, lr_pnp=1.0, gamma_style="constant",
                        num_samples=1, alpha=1.0, noise_type="gaussian",
                        problem="gaussian_deblurring_FFT", save_results=False,
                        compute_time=False, compute_memory=False,
                        max_batch=7))
    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(2, DIM, DIM, 3)).astype(np.float32),
                np.zeros(2)) for _ in range(2)]
    _solver(args).solve_ip(batches, GaussianDeblurring(1.0, 9, 3, DIM,
                                                      device="cpu"), 0.05)
    assert args.batch == 1 and args.max_batch == 2


def test_lpips_weights_present_raise(tmp_path):
    from pnpflow_tpu_torch.utils import reporting
    from pnpflow_tpu_torch.utils.config import CfgNode

    args = CfgNode(dict(output_root=str(tmp_path)))
    x = torch.zeros(1, 8, 8, 3)
    with pytest.warns(UserWarning, match="LPIPS"):
        assert reporting.compute_lpips(x, x, x, args) is None
    (tmp_path / "model").mkdir()
    (tmp_path / "model" / "lpips_alex.npz").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="LPIPS"):
        reporting.compute_lpips(x, x, x, args)


NCSNPP = dict(image_size=DIM, num_channels=3, nf=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(16,))


def _ncsnpp_params():
    """JAX NCSN++ parameters drawn at a real scale (the seeded init's output
    convs are near zero, so v would be ~0)."""
    x = np.zeros((1, DIM, DIM, 3), np.float32)
    shapes = jax.eval_shape(JaxNCSNpp(**NCSNPP).init, jax.random.PRNGKey(0),
                            x, np.ones((1,), np.float32))
    rng = np.random.default_rng(6)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.2 * rng.normal(size=leaf.shape)).astype(np.float32)
        if "bias" in name or name.endswith("['b']"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = max(int(np.prod(leaf.shape[:-1])), 1)
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _blur_problem(seed, noise):
    rng = np.random.default_rng(seed)
    clean = np.tanh(rng.normal(size=(B, DIM, DIM, 3)) * 0.3).astype(np.float32)
    eps = rng.normal(size=(STEPS, S, B, DIM, DIM, 3)).astype(np.float32)
    jop = JaxBlur(1.0, 9, "fft", 3, DIM)
    y = np.asarray(jop.H(jnp.asarray(clean))) + noise(rng, clean.shape)
    return clean, eps, jop, y.astype(np.float32)


def test_rectified_solver_matches_jax_with_shared_noise():
    """20 pnp_flow steps through the NCSN++ behind the t-floor adapter
    (t = 0 at the first step), with the same measurement and MC noise."""
    params = _ncsnpp_params()
    clean, eps, jop, y = _blur_problem(
        2, lambda rng, shape: 0.05 * rng.normal(size=shape))
    kw = dict(steps=STEPS, num_samples=S, lr_pnp=1.0,
              gamma_style="alpha_1_minus_t", alpha=1.0, noise_type="gaussian",
              sigma_noise=0.05)
    jm = JaxNCSNpp(**NCSNPP)

    def japply(p, x, t):
        return jm.apply(p, x, jnp.maximum(t, 1e-3) * 999.0)

    jsolve = jax_solver(japply, jop.H, jop.H_adj, eps_seq=eps, **kw)
    x0 = jop.H_adj(jnp.ones_like(jnp.asarray(y)))
    want = np.asarray(jsolve(params, jnp.asarray(y), x0,
                             jax.random.PRNGKey(1),
                             jnp.asarray(0, jnp.int32), STEPS))

    net = NCSNpp(**NCSNPP)
    net.load_state_dict(ncsnpp_state_dict_from_flax(params, net.sigmas))
    top = GaussianDeblurring(1.0, 9, 3, DIM, device="cpu")
    solve = make_pnp_flow_solver(RectifiedAdapter(net).eval(), top.H,
                                 top.H_adj, eps_seq=torch.from_numpy(eps),
                                 **kw)
    ty = torch.from_numpy(y)
    with torch.inference_mode():
        got = solve(ty, top.H_adj(torch.ones_like(ty)), None, 0, STEPS)
    assert np.isfinite(want).all() and np.abs(want - np.asarray(x0)).max() > 0.1
    assert np.abs(got.numpy() - want).max() < 1e-4
    got01, want01, clean01 = ((a + 1.0) / 2.0 for a in (got.numpy(), want,
                                                          clean))
    p_got = float(psnr(torch.from_numpy(got01), torch.from_numpy(clean01)))
    p_want = float(jpsnr(want01, clean01))
    assert abs(p_got - p_want) < 1e-4


def test_laplace_measurement_and_solver_match_jax():
    """Laplace noise: the measurement on injected noise, then pnp_flow's
    sign-subgradient data step, against JAX on the same inputs."""
    params = _params()
    rng = np.random.default_rng(8)
    noise = rng.laplace(size=(B, DIM, DIM, 3)).astype(np.float32)
    clean, eps, jop, _ = _blur_problem(3, lambda rng, shape: 0.0)
    top = GaussianDeblurring(1.0, 9, 3, DIM, device="cpu")
    y = measure(top.H, torch.from_numpy(clean), 0.3, "laplace", 0,
                noise=torch.from_numpy(noise))
    jy = np.asarray(jop.H(jnp.asarray(clean))) + 0.3 * noise
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-5, rtol=0)

    steps = 5
    kw = dict(steps=steps, num_samples=S, lr_pnp=1.0,
              gamma_style="alpha_1_minus_t", alpha=1.0, noise_type="laplace",
              sigma_noise=0.3)
    jsolve = jax_solver(JaxUNet(**CFG).apply, jop.H, jop.H_adj,
                        eps_seq=eps[:steps], **kw)
    x0 = jop.H_adj(jnp.ones_like(jnp.asarray(jy)))
    want = np.asarray(jsolve(params, jnp.asarray(jy), x0,
                             jax.random.PRNGKey(1),
                             jnp.asarray(0, jnp.int32), steps))
    model = VelocityUNet(**CFG)
    model.load_state_dict(state_dict_from_flax(params))
    solve = make_pnp_flow_solver(model.eval(), top.H, top.H_adj,
                                 eps_seq=torch.from_numpy(eps[:steps]), **kw)
    with torch.inference_mode():
        got = solve(torch.from_numpy(jy), top.H_adj(torch.ones_like(y)),
                    None, 0, steps)
    assert np.abs(want - np.asarray(x0)).max() > 0.1
    assert np.abs(got.numpy() - want).max() < 1e-4


def test_laplace_draws_have_laplace_statistics():
    gen = torch.Generator().manual_seed(0)
    z = draw_noise((1_000_000,), "laplace", gen, "cpu", torch.float32)
    assert abs(float(z.mean())) < 5e-3
    assert abs(float(z.var()) - 2.0) < 2e-2
    assert abs(float((z.abs() > 1.0).float().mean()) - np.exp(-1.0)) < 3e-3
    with pytest.raises(ValueError, match="Noise type"):
        draw_noise((4,), "poisson", gen, "cpu", torch.float32)


def test_rectified_superresolution_cli_on_cpu(tmp_path, monkeypatch):
    """The rectified CLI (NCSN++ at its full widths, 64x64) on a problem
    whose measurement is smaller than the image."""
    monkeypatch.chdir(REPO)
    args = main(["--opts", "dataset", "synthetic", "model", "rectified",
                 "dim_image", "64", "eval", "True", "method", "pnp_flow",
                 "problem", "superresolution", "steps_pnp", "2",
                 "num_samples", "1", "batch_size_ip", "1", "max_batch", "1",
                 "save_results", "True", "output_root", str(tmp_path),
                 "device", "cpu"])
    with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
        f.readline()
        row = f.readline().split()
    assert np.isfinite(float(row[0])) and np.isfinite(float(row[1]))
    assert os.path.exists(os.path.join(
        args.save_path_ip, "superresolution_noisy_batch0_final.png"))
