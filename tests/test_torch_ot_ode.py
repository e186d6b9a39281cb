"""The port's ot_ode solver against the JAX package on the same parameters,
measurement and starting point (JAX draws its start from its own key, so
the start is injected): 20 steps from start_time 0.2, i.e. 16 iterations
each taking a model VJP, for every closed form and the GMRES branch.

Bounds: max-abs 1e-4 after the 16 iterations (float32 rounding through 16
U-Net forwards and VJPs) and PSNR within 1e-4 dB.
"""

import functools
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.metrics.image_quality import psnr as jpsnr
from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.ops import degradations as jdeg
from pnpflow_tpu.solvers.ot_ode import make_ot_ode_solver as jax_solver
from pnpflow_tpu_torch.metrics.image_quality import psnr
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.ops import degradations as tdeg
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.solvers.ot_ode import (
    OTOde, make_ot_ode_solver, report_points)
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import state_dict_from_flax

DIM, B, STEPS, START = 32, 2, 20, 0.2
CFG = dict(input_channels=3, input_height=DIM, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,))
SIGMA = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def params():
    """JAX init with the near-zero output convs redrawn, so v is not ~0."""
    p = JaxUNet(**CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, DIM, DIM, 3)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(5)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name and ("end_conv" in name or "conv2" in name
                                 or "proj_out" in name):
            fan_in = np.prod(leaf.shape[:-1])
            return jnp.asarray(rng.normal(size=leaf.shape) / np.sqrt(fan_in),
                               jnp.float32) * 0.5
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, p)


def port_model(fused=True):
    m = VelocityUNet(**CFG, fused_norm=fused)
    m.load_state_dict(state_dict_from_flax(params()))
    return m.eval().requires_grad_(False)


PROBLEMS = {
    "gaussian_deblurring_FFT": (lambda: jdeg.GaussianDeblurring(
        1.0, 9, "fft", 3, DIM), lambda: tdeg.GaussianDeblurring(
        1.0, 9, 3, DIM, device="cpu")),
    "denoising": (jdeg.Denoising, tdeg.Denoising),
    "inpainting": (lambda: jdeg.BoxInpainting(8, DIM),
                   lambda: tdeg.BoxInpainting(8, DIM, device="cpu")),
    "superresolution": (lambda: jdeg.Superresolution(4, DIM),
                        lambda: tdeg.Superresolution(4, DIM, device="cpu")),
    "superresolution_bicubic": (
        lambda: jdeg.Superresolution(4, DIM, mode="bicubic"),
        lambda: tdeg.Superresolution(4, DIM, mode="bicubic", device="cpu")),
}


def problem_case(problem, seed):
    """(clean, y, x0, JAX operator, port operator) on numpy inputs."""
    jop, top = (f() for f in PROBLEMS[problem])
    rng = np.random.default_rng(seed)
    clean = np.tanh(rng.normal(size=(B, DIM, DIM, 3)) * 0.3).astype(
        np.float32)
    hx = np.asarray(jop.H(jnp.asarray(clean)))
    y = (hx + SIGMA * rng.normal(size=hx.shape)).astype(np.float32)
    eps = rng.normal(size=clean.shape).astype(np.float32)
    x0 = (START * np.asarray(jop.H_adj(jnp.asarray(y)))
          + (1 - START) * eps).astype(np.float32)
    return clean, y, x0, jop, top


@pytest.mark.parametrize("problem,gamma", [(p, "constant") for p in PROBLEMS]
                         + [("gaussian_deblurring_FFT", "gamma_t")])
def test_solver_matches_jax(problem, gamma):
    clean, y, x0, jop, top = problem_case(problem, 0)
    first = int(STEPS * START)
    kw = dict(problem=problem, steps=STEPS, gamma=gamma, sigma_noise=SIGMA)
    jm = JaxUNet(**CFG)
    want = np.asarray(jax_solver(jm.apply, jop, **kw)(
        params(), jnp.asarray(y), jnp.asarray(x0), None,
        jnp.asarray(first, jnp.int32), STEPS - first))

    solve = make_ot_ode_solver(port_model(), top, **kw)
    with torch.no_grad():
        got = solve(torch.from_numpy(y), torch.from_numpy(x0), first,
                    STEPS - first).numpy()
    assert np.isfinite(want).all() and np.abs(want - x0).max() > 0.1
    assert np.abs(got - want).max() <= 1e-4
    to01 = lambda a: (a + 1.0) / 2.0  # noqa: E731
    p_got = float(psnr(torch.from_numpy(to01(got)),
                       torch.from_numpy(to01(clean))))
    assert abs(p_got - float(jpsnr(to01(want), to01(clean)))) <= 1e-4


def test_report_points_follow_reference():
    assert report_points(100, 20) == [20, 30, 40, 50, 60, 70, 80, 90]
    assert report_points(20, 4) == [4, 6, 8, 10, 12, 14, 16, 18]


def _args(**kw):
    base = dict(problem="gaussian_deblurring_FFT", noise_type="gaussian",
                save_results=False, compute_time=False, compute_memory=False,
                max_batch=1, steps_ode=5, start_time=0.2, gamma="constant",
                method="ot_ode")
    return CfgNode({**base, **kw})


def test_ot_ode_runs_from_solve_ip():
    """The outer loop of a differentiating solver runs under no_grad, not
    inference_mode, whose tensors autograd cannot save; the model's
    parameters are frozen."""
    args = _args()
    model = port_model()
    model.requires_grad_(True)
    solver = OTOde(ModelBundle(model=model, device=torch.device("cpu")), args)
    assert not any(p.requires_grad for p in model.parameters())
    clean = np.tanh(np.random.default_rng(2).normal(size=(B, DIM, DIM, 3)))
    batches = [(clean.astype(np.float32), np.zeros(B))]
    op = tdeg.GaussianDeblurring(1.0, 9, 3, DIM, device="cpu")
    solver.solve_ip(batches, op, SIGMA)
    assert args.batch == 0 and args.max_batch == 1


# --------------------------------------------------- CLI and model defaults
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHOD_OPTS = {
    "ot_ode": ["steps_ode", "5"],
    "flow_priors": ["N", "2"],
    "d_flow": ["steps_euler", "3", "max_iter", "1", "LBFGS_iter", "2"],
}


def _file_set(root):
    """Every file under ``root``, relative, with the PSNR in the per-image
    .eps names (which depends on the restored image) cut out."""
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            out.add(re.sub(r"_pnsr-?[0-9.]+\.eps$", "_pnsr.eps",
                           os.path.relpath(os.path.join(d, f), root)))
    return out


def _jax_file_set(opts, root):
    """The files the JAX CLI's outer loop and reporting write for these
    options: its config, data, degradation and ``Solver.run_method``, with a
    solve_batch that returns at once (the file set does not depend on the
    solver's arithmetic)."""
    from pnpflow_tpu.data import DataLoaders as JaxLoaders
    from pnpflow_tpu.solvers.base import Solver as JaxSolver
    from pnpflow_tpu.utils.config import load_full_config

    args = load_full_config(opts)
    deg, sigma = jdeg.make_degradation(args)
    loaders = JaxLoaders(args.dataset, args.batch_size_ip,
                         args.batch_size_ip,
                         root=os.path.join(args.root, "data"),
                         dim_image=args.dim_image,
                         num_channels=args.num_channels).load_data()
    args.save_path = os.path.join(args.output_root, "results", args.dataset,
                                  args.model, args.problem, args.method,
                                  args.eval_split)
    os.makedirs(args.save_path, exist_ok=True)

    class Returns(JaxSolver):
        def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                        batch, report_cb=None):
            return noisy_img, 0

    Returns(None, args).run_method(loaders, deg, sigma)
    return _file_set(os.path.join(root, "results"))


@pytest.mark.parametrize("method", sorted(METHOD_OPTS))
def test_cli_writes_the_reference_file_set(method, tmp_path, monkeypatch):
    from pnpflow_tpu_torch.main import main

    monkeypatch.chdir(REPO)
    opts = ["dataset", "synthetic", "model", "ot", "dim_image", "16", "eval",
            "True", "method", method, "problem", "denoising",
            "batch_size_ip", "1", "max_batch", "1", "save_results", "True",
            "compute_time", "True", *METHOD_OPTS[method]]
    args = main(["--opts", *opts, "output_root", str(tmp_path / "port"),
                 "device", "cpu"])
    got = _file_set(os.path.join(tmp_path, "port", "results"))
    want = _jax_file_set([*opts, "output_root", str(tmp_path / "jax")],
                         str(tmp_path / "jax"))
    assert got == want
    assert f"synthetic/ot/denoising/{method}/test/final_psnr.txt" in got
    with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
        header, row = f.readline().split(), f.readline().split()
    cfg = load_method_config(method)
    assert header == ["psnr_rec", "psnr_noisy", *cfg]
    assert np.isfinite(float(row[0]))


def load_method_config(method):
    from pnpflow_tpu_torch.utils.config import load_cfg_from_cfg_file

    return list(load_cfg_from_cfg_file(os.path.join(
        REPO, "config", "method_config", f"{method}.yaml")))


@pytest.mark.parametrize("method", sorted(METHOD_OPTS))
def test_differentiated_methods_default_to_the_groupnorm_kernel(method):
    from pnpflow_tpu_torch.models.registry import define_model

    args = CfgNode(dict(model="ot", dim_image=16, num_channels=3,
                        method=method))
    assert define_model(args).fused_norm is True
    args.fused_norm = "conv"
    with pytest.raises(ValueError, match=method):
        define_model(args)
    args.method = "pnp_flow"
    assert define_model(args).fused_norm == "conv"
