"""The port's pnp_diff (DiffPIR, ``pnpflow_tpu_torch/solvers/pnp_diff.py``)
against the JAX package's (``pnpflow_tpu/solvers/pnp_diff.py``).

- every ``make_prox`` branch (mask, denoising, FFT deblur, decimation SR and
  laplace's 100-iteration L1 dual prox) on the same inputs within 1e-5 of
  max(1, |prox|), but the gaussian FFT deblur within 5e-5: its FFT takes
  d = H_adj(y) / sigma^2 + x / gamma, about 400 here, and JAX's own float32
  result lies 2.6e-5 from the float64 prox; the port is held to lie no
  farther from it than 1.5 times JAX's distance;
- the schedules: ``schedules()`` equal to JAX's ``_schedules()`` bit for
  bit, and the timesteps equal to JAX's construction;
- a 5-step DiffPIR solve with ``tests/test_solvers.py``'s tiny DiffUNet
  (every parameter at a real scale, so eps is not 0) within 1e-4, with the
  noise JAX draws from its own key chain (one split for the start, one a
  step) handed to the port, for inpainting, denoising and decimation SR.
  FFT deblurring is ill-conditioned in float32 at the first steps (gamma
  near 7e5 divides by 400 |F|^2 + 1/gamma, down to 1.7e-5): JAX against
  itself from a measurement scaled by 1 + 1e-7 differs by 0.037 after the
  5 steps, so the port is held to lie no farther from JAX than that there,
  and within 1e-4 at sigma 0.2 and lmbda 1e5, where JAX's own spread is
  about 2e-5;
- a CLI run of ``method pnp_diff model diffusion`` on the CPU.
"""

import functools
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.models.diffunet import DiffUNet as JaxDiffUNet
from pnpflow_tpu.ops import degradations as jdeg
from pnpflow_tpu.solvers import pnp_diff as jpd
from pnpflow_tpu_torch.main import main
from pnpflow_tpu_torch.models.diffunet import DiffUNet
from pnpflow_tpu_torch.ops import degradations as tdeg
from pnpflow_tpu_torch.solvers import pnp_diff as tpd
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import diffunet_state_dict_from_flax

DIM, B = 32, 2
TINY = dict(in_channels=3, out_channels=6, model_channels=32,
            channel_mult=(1, 2), num_res_blocks=1, attention_ds=(2,))
OPS = {
    "inpainting": (lambda: jdeg.BoxInpainting(8, DIM),
                   lambda: tdeg.BoxInpainting(8, DIM, device="cpu")),
    "denoising": (jdeg.Denoising, tdeg.Denoising),
    "gaussian_deblurring_FFT": (
        lambda: jdeg.GaussianDeblurring(1.0, 9, "fft", 3, DIM),
        lambda: tdeg.GaussianDeblurring(1.0, 9, 3, DIM, device="cpu")),
    "superresolution": (lambda: jdeg.Superresolution(4, DIM),
                        lambda: tdeg.Superresolution(4, DIM, device="cpu")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def measurement(problem, sigma, seed=0):
    jop, top = (f() for f in OPS[problem])
    rng = np.random.default_rng(seed)
    clean = np.tanh(rng.normal(size=(B, DIM, DIM, 3)) * 0.4).astype(
        np.float32)
    hx = np.asarray(jop.H(jnp.asarray(clean)))
    y = ((hx + sigma * rng.normal(size=hx.shape) + 1.0) / 2.0).astype(
        np.float32)
    return y, jop, top


@pytest.mark.parametrize("problem,noise", [
    (p, "gaussian") for p in OPS] + [("inpainting", "laplace"),
                                     ("gaussian_deblurring_FFT", "laplace")])
def test_prox_matches_jax(problem, noise):
    sigma = 0.3 if noise == "laplace" else 0.05
    y, jop, top = measurement(problem, sigma)
    x = np.random.default_rng(1).uniform(size=(B, DIM, DIM, 3)).astype(
        np.float32)
    gamma = np.float32(0.37)
    jprox = jpd.make_prox(problem, jop, sigma, noise)
    want = np.asarray(jax.jit(jprox)(jnp.asarray(x), jnp.asarray(y), gamma))
    got = tpd.make_prox(problem, top, sigma, noise)(
        torch.from_numpy(x), torch.from_numpy(y), float(gamma)).numpy()
    assert np.isfinite(want).all() and np.abs(want - x).max() > 1e-2
    tol = 1e-5
    if problem == "gaussian_deblurring_FFT" and noise == "gaussian":
        filt = np.asarray(jop.fft_filter).astype(np.complex128)

        def fft_apply(a, f):
            return np.real(np.fft.ifft2(np.fft.fft2(a, axes=(1, 2)) * f,
                                        axes=(1, 2)))

        norm, g = 1.0 / sigma ** 2, float(gamma)
        d = fft_apply(y.astype(np.float64), np.conj(filt)) * norm + x / g
        ref = fft_apply(d, 1.0 / (norm * np.abs(filt) ** 2 + 1.0 / g))
        assert np.abs(got - ref).max() <= 1.5 * np.abs(want - ref).max()
        tol = 5e-5
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def test_schedules_equal_jax():
    acp, sigmas = tpd.schedules()
    jacp, jsigmas = jpd._schedules()
    assert acp.dtype == np.float32 and np.array_equal(acp, jacp)
    assert np.array_equal(sigmas, jsigmas)
    for max_iter in (2, 5, 20, 100, 1000, 1500):
        # JAX's construction, pnpflow_tpu/solvers/pnp_diff.py:129-134
        seq = np.sqrt(np.linspace(0, jpd._T ** 2, max_iter))
        seq = np.unique(np.clip(seq.astype(np.int64), 0, jpd._T - 1))
        seq[-1] = jpd._T - 1
        desc = seq[::-1].copy()
        t, t_next = tpd.timesteps(max_iter)
        assert np.array_equal(t, desc)
        assert np.array_equal(t_next, np.concatenate([desc[1:], [0]]))
    assert len(tpd.timesteps(100)[0]) == 100


@functools.lru_cache(maxsize=None)
def tiny_params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(JaxDiffUNet(**TINY).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, DIM, DIM, 3)), jnp.zeros((1,)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif "bias" in name:
            v = 0.1 * rng.normal(size=leaf.shape)
        else:
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_key_chain_noise(key, shape, steps):
    """The draws of JAX's ``make_diffpir_solver``: one split for the start,
    then one split a step, each split keeping the first key."""
    out = []
    for _ in range(steps + 1):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    return out


def diffpir_both(problem, sigma, lmbda, max_iter=5):
    """JAX's and the port's DiffPIR solve on the same measurement and
    weights, the port given JAX's own draws; also JAX's solve from the
    measurement scaled by 1 + 1e-7, which shows float32's own spread."""
    y, jop, top = measurement(problem, sigma)
    params = tiny_params()
    jprox = jpd.make_prox(problem, jop, sigma, "gaussian")
    jsolve = jax.jit(jpd.make_diffpir_solver(
        JaxDiffUNet(**TINY).apply, jprox, jop.H_adj, lmbda=lmbda, zeta=0.3,
        max_iter=max_iter, sigma_noise=sigma))
    key = jax.random.PRNGKey(1000)
    want = np.asarray(jsolve(params, jnp.asarray(y), key))
    nudged = np.asarray(jsolve(params, jnp.asarray(y * (1 + 1e-7)), key))
    steps = len(tpd.timesteps(max_iter)[0])
    noise = jax_key_chain_noise(key, (B, DIM, DIM, 3), steps)

    m = DiffUNet(**TINY)
    m.load_state_dict(diffunet_state_dict_from_flax(params))
    solve = tpd.make_diffpir_solver(
        m, tpd.make_prox(problem, top, sigma, "gaussian"), top.H_adj,
        lmbda=lmbda, zeta=0.3, max_iter=max_iter, sigma_noise=sigma)
    with torch.no_grad():
        got = solve(torch.from_numpy(y), noise_seq=noise).numpy()
    assert steps == max_iter and np.isfinite(want).all()
    assert np.abs(want).max() > 0.1
    return got, want, nudged


@pytest.mark.parametrize("problem", list(OPS))
def test_diffpir_solve_matches_jax(problem):
    got, want, nudged = diffpir_both(problem, 0.05, 7.0)
    tol = 1e-4
    if problem == "gaussian_deblurring_FFT":
        # float32's own spread on this problem (see the module docstring)
        tol = np.abs(nudged - want).max()
        assert tol > 1e-2
    assert np.abs(got - want).max() <= tol


def test_diffpir_fft_deblur_matches_jax_where_well_conditioned():
    """FFT deblurring at sigma 0.2 and lmbda 1e5, where gamma stays small
    enough that JAX's own spread from a 1e-7-scaled measurement is about
    2e-5: the port within 1e-4 of JAX after 5 steps, the result still
    depending on the measurement."""
    got, want, nudged = diffpir_both("gaussian_deblurring_FFT", 0.2, 1e5)
    assert np.abs(nudged - want).max() < 5e-5
    assert np.abs(got - want).max() <= 1e-4


def test_solver_draws_from_a_generator_seeded_by_the_batch():
    """Without injected noise the draws come from a generator seeded
    1000 + batch: one batch repeats, another differs."""
    y, _, top = measurement("inpainting", 0.05)
    m = DiffUNet(**TINY)
    m.load_state_dict(diffunet_state_dict_from_flax(tiny_params()))
    args = CfgNode({"problem": "inpainting", "noise_type": "gaussian",
                    "lmbda": 7.0, "zeta": 0.3, "max_iter": 2})
    solver = tpd.PnPDiff(ModelBundle(model=m, device=torch.device("cpu")),
                         args)
    noisy = torch.from_numpy(2.0 * y - 1.0)
    with torch.no_grad():
        a, it = solver.solve_batch(None, noisy, top, 0.05, 0)
        b, _ = solver.solve_batch(None, noisy, top, 0.05, 0)
        c, _ = solver.solve_batch(None, noisy, top, 0.05, 1)
    assert it == 100 and torch.equal(a, b) and not torch.equal(a, c)


def test_cli_writes_the_reference_file_set(tmp_path):
    """``method pnp_diff model diffusion`` through the CLI on the CPU: the
    full-width DiffUNet at 64x64 (seeded init, whose output is 0, as JAX's
    is), FFT deblurring, 3 steps, reported once at iteration 100."""
    out = str(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        args = main(["--opts", "dataset", "synthetic", "dim_image", "64",
                     "model", "diffusion", "eval", "True", "method",
                     "pnp_diff", "problem", "gaussian_deblurring_FFT",
                     "max_iter", "3", "batch_size_ip", "1", "max_batch", "1",
                     "compute_time", "True", "device", "cpu",
                     "output_root", out])
    ip = args.save_path_ip
    for f in ("psnr_rec_batch0.txt", "psnr_noisy_batch0.txt",
              "ssim_rec_batch0.txt", "psnr_rec_average.txt",
              "time_stats.txt",
              "gaussian_deblurring_FFT_pnp_diff_batch0_final.png"):
        assert os.path.exists(os.path.join(ip, f)), f
    rows = np.loadtxt(os.path.join(ip, "psnr_rec_batch0.txt"), ndmin=2)
    assert len(rows) == 1 and np.isfinite(rows).all()
    with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
        assert f.readline().split() == ["psnr_rec", "psnr_noisy", "lmbda",
                                        "zeta", "sigma", "max_iter"]
