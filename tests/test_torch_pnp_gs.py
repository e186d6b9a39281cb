"""The port's pnp_gs (Prox-PnP with the gradient-step denoiser) against the
JAX package's ``make_pnp_gs_solver`` on the same parameters, measurement and
start, over 5 iterations of every algorithm / problem branch.

The model is ``tests/test_solvers.py``'s U-Net (32x32, ch 32, mult (1, 2),
one block, attention at 16), JAX's init with its near-zero output convs
redrawn so the denoiser is not the identity.  JAX runs ``fused_norm False``;
the port ``True`` (the plain kernel versions on the CPU, the VJP through the
autograd function's backward).

Bounds: max-abs 1e-4 after the 5 iterations (float32 rounding through 5
U-Net forwards and VJPs); the backtracked alpha equal to float32 rounding
(rel 1e-6).  The deblurring start is H_adj(y) plus noise, so that the
backtracking shrinks alpha on some iterations and not on others.

Bicubic super-resolution runs at sf 2 (the 128x128 datasets' factor).  At
sf 4 the reference's block-splitting step amplifies float32 rounding about
tenfold an iteration with this random denoiser: JAX against itself from a
start scaled by 1 + 1e-7 differs by 7.1e-3 after 5 iterations, the port
from JAX by 3.2e-3 (read on this model; not a test).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.ops import degradations as jdeg
from pnpflow_tpu.solvers.pnp_gs import _splits_mean as jax_splits_mean
from pnpflow_tpu.solvers.pnp_gs import make_pnp_gs_solver as jax_solver
from pnpflow_tpu_torch.models import registry as treg
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.ops import degradations as tdeg
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.solvers.pnp_gs import (
    ProxPnP, _splits_mean, initial_iterate, make_pnp_gs_solver,
    report_points)
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import state_dict_from_flax

DIM, B, ITERS = 32, 2, 5
CFG = dict(input_channels=3, input_height=DIM, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def params():
    """JAX init with the near-zero output convs redrawn, so D is not ~x."""
    p = JaxUNet(**CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, DIM, DIM, 3)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(5)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name and ("end_conv" in name or "conv2" in name
                                 or "proj_out" in name):
            fan_in = np.prod(leaf.shape[:-1])
            return jnp.asarray(rng.normal(size=leaf.shape) / np.sqrt(fan_in),
                               jnp.float32) * 0.05
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, p)


def port_model(fused=True):
    m = VelocityUNet(**CFG, fused_norm=fused)
    m.load_state_dict(state_dict_from_flax(params()))
    return m.eval().requires_grad_(False)


OPS = {
    "gaussian_deblurring_FFT": (
        lambda: jdeg.GaussianDeblurring(1.0, 9, "fft", 3, DIM),
        lambda: tdeg.GaussianDeblurring(1.0, 9, 3, DIM, device="cpu")),
    "denoising": (jdeg.Denoising, tdeg.Denoising),
    "inpainting": (lambda: jdeg.BoxInpainting(8, DIM),
                   lambda: tdeg.BoxInpainting(8, DIM, device="cpu")),
    "random_inpainting": (lambda: jdeg.RandomInpainting(0.7, DIM, B),
                          lambda: tdeg.RandomInpainting(0.7, DIM, B,
                                                        device="cpu")),
    "superresolution_bicubic": (
        lambda: jdeg.Superresolution(2, DIM, mode="bicubic"),
        lambda: tdeg.Superresolution(2, DIM, mode="bicubic", device="cpu")),
}

# name: (algo, problem, noise, sigma, max_iter, start): random inpainting
# runs iterations 18-22 of 23, across the denoiser's level switch at 20
# and into the last iteration, whose prox the reference skips
CASES = {
    "pgd_deblur": ("pgd", "gaussian_deblurring_FFT", "gaussian", 0.05, 30, 0),
    "pgd_denoising": ("pgd", "denoising", "gaussian", 0.2, 30, 0),
    "pgd_inpainting_laplace": ("pgd", "inpainting", "laplace", 0.3, 30, 0),
    "hqs_random_inpainting": ("hqs", "random_inpainting", "gaussian", 0.01,
                              23, 18),
    "hqs_deblur": ("hqs", "gaussian_deblurring_FFT", "gaussian", 0.05, 30, 0),
    "hqs_sr_bicubic": ("hqs", "superresolution_bicubic", "gaussian", 0.05, 30,
                       0),
}
ALPHA = 0.5
START_NOISE = {"hqs_deblur": 0.3}


def case_inputs(problem, sigma, noise, seed=0):
    jop, top = (f() for f in OPS[problem])
    rng = np.random.default_rng(seed)
    clean = np.tanh(rng.normal(size=(B, DIM, DIM, 3)) * 0.3).astype(
        np.float32)
    hx = np.asarray(jop.H(jnp.asarray(clean)))
    n = (rng.laplace(size=hx.shape) if noise == "laplace"
         else rng.normal(size=hx.shape))
    y = (hx + sigma * n).astype(np.float32)
    return y, jop, top


@functools.lru_cache(maxsize=None)
def jax_result(name):
    algo, problem, noise, sigma, max_iter, start = CASES[name]
    y, jop, _ = case_inputs(problem, sigma, noise)
    if problem == "random_inpainting":
        x0 = 1.5 * y - np.asarray(jop.H(jnp.asarray(y)))
    else:
        x0 = np.asarray(jop.H_adj(jnp.asarray(y)))
    x0 = (x0 + START_NOISE.get(name, 0.0) * np.random.default_rng(9).normal(
        size=x0.shape)).astype(np.float32)
    solve = jax_solver(
        JaxUNet(**CFG).apply, jop, problem=problem, algo=algo,
        noise_type=noise, sigma_noise=sigma, lr_pnp=1.0, alpha=ALPHA,
        sigma_factor=1.0, max_iter=max_iter)
    x, a = solve(params(), jnp.asarray(y), jnp.asarray(x0),
                 jnp.asarray(ALPHA, jnp.float32),
                 jnp.asarray(start, jnp.int32), ITERS)
    return y, x0, np.asarray(x), float(a)


@pytest.mark.parametrize("name", list(CASES))
def test_solver_matches_jax(name):
    algo, problem, noise, sigma, max_iter, start = CASES[name]
    y, x0, want, want_alpha = jax_result(name)
    _, _, top = case_inputs(problem, sigma, noise)
    solve = make_pnp_gs_solver(
        port_model().forward, top, problem=problem, algo=algo,
        noise_type=noise, sigma_noise=sigma, lr_pnp=1.0, sigma_factor=1.0,
        max_iter=max_iter)
    with torch.no_grad():
        got, alpha = solve(torch.from_numpy(y), torch.from_numpy(x0),
                           torch.tensor(ALPHA), start, ITERS)
    assert got.grad_fn is None
    assert np.isfinite(want).all() and np.abs(want - x0).max() > 1e-2
    assert np.abs(got.numpy() - want).max() <= 1e-4
    assert abs(float(alpha) - want_alpha) <= 1e-6 * want_alpha
    if name == "hqs_deblur":
        # the backtracking shrank alpha on 3 of the 5 iterations, each
        # decision taken on the device
        assert want_alpha == pytest.approx(ALPHA * 0.9 ** 3)
        assert alpha.dim() == 0


def test_random_inpainting_keeps_the_previous_iterate_at_the_end():
    """On the last iteration the reference computes the denoiser and keeps
    the iterate: one step from max_iter - 1 returns its input."""
    _, problem, noise, sigma, max_iter, _ = CASES["hqs_random_inpainting"]
    y, _, top = case_inputs(problem, sigma, noise)
    solve = make_pnp_gs_solver(
        port_model().forward, top, problem=problem, algo="hqs",
        noise_type=noise, sigma_noise=sigma, lr_pnp=1.0, sigma_factor=1.0,
        max_iter=max_iter)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, DIM, DIM, 3)).astype(np.float32))
    with torch.no_grad():
        last, _ = solve(torch.from_numpy(y), x, torch.tensor(ALPHA),
                        max_iter - 1, 1)
        before, _ = solve(torch.from_numpy(y), x, torch.tensor(ALPHA),
                          max_iter - 2, 1)
    assert torch.equal(last, x) and not torch.equal(before, x)


def test_splits_mean_matches_jax():
    a = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
    for sf in (2, 4):
        want = np.asarray(jax_splits_mean(jnp.asarray(a), sf))
        got = _splits_mean(torch.from_numpy(a), sf).numpy()
        assert got.shape == (2, 8 // sf, 8 // sf, 3)
        assert np.abs(got - want).max() <= 1e-6
    x = torch.arange(16.0).reshape(1, 4, 4, 1)
    assert float(_splits_mean(x, 2)[0, 0, 0, 0]) == np.mean([0, 2, 8, 10])


def test_initial_iterates():
    y = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, DIM // 4, DIM // 4, 3)).astype(np.float32))
    sr = tdeg.Superresolution(4, DIM, device="cpu")
    bic = tdeg.Superresolution(4, DIM, mode="bicubic", device="cpu")
    # plain super-resolution starts from the bicubic operator's adjoint
    assert torch.equal(initial_iterate("superresolution", sr, y),
                       bic.H_adj(y))
    ri = tdeg.RandomInpainting(0.7, DIM, B, device="cpu")
    z = torch.ones(B, DIM, DIM, 3)
    assert torch.equal(initial_iterate("random_inpainting", ri, z),
                       1.5 * z - ri.H(z))
    assert report_points(30) == [0, 10, 20]


def _args(**kw):
    base = dict(problem="gaussian_deblurring_FFT", noise_type="gaussian",
                save_results=False, compute_time=False, compute_memory=False,
                max_batch=2, max_iter=3, lr_pnp=1.0, alpha=ALPHA, algo="hqs",
                sigma_factor=1.0, method="pnp_gs")
    return CfgNode({**base, **kw})


def test_alpha_carries_across_batches_and_resets_on_new_physics(
        monkeypatch):
    """The backtracked alpha of one batch seeds the next within a
    ``solve_ip``; a new ``solve_ip``, on the same physics or on new, starts
    again from ``args.alpha``."""
    import pnpflow_tpu_torch.solvers.pnp_gs as mod

    model = port_model()
    model.requires_grad_(True)
    solver = ProxPnP(ModelBundle(model=model, device=torch.device("cpu")),
                     _args(alpha=2.0))
    assert not any(p.requires_grad for p in model.parameters())
    _, _, top = case_inputs("gaussian_deblurring_FFT", 0.05, "gaussian")
    clean = np.tanh(np.random.default_rng(2).normal(size=(B, DIM, DIM, 3)))
    batches = [(clean.astype(np.float32), np.zeros(B))] * 2
    starts, ends = [], []

    def spy(*a, **kw):
        solve = make_pnp_gs_solver(*a, **kw)

        def wrapped(y, x, alpha_c, start, n):
            starts.append(float(alpha_c))
            x, alpha_c = solve(y, x, alpha_c, start, n)
            ends.append(float(alpha_c))
            return x, alpha_c
        return wrapped

    monkeypatch.setattr(mod, "make_pnp_gs_solver", spy)
    solver.solve_ip(batches, top, 0.05)
    solver.solve_ip(batches[:1], top, 0.05)
    other = tdeg.GaussianDeblurring(1.0, 9, 3, DIM, device="cpu")
    solver.solve_ip(batches[:1], other, 0.05)
    assert ends[0] < 2.0                    # batch 0 backtracked
    assert starts == [2.0, ends[0], 2.0, 2.0]


def test_conv_mode_is_refused_for_pnp_gs():
    args = CfgNode({"model": "gradient_step", "dim_image": 64,
                    "num_channels": 3, "method": "pnp_gs"})
    assert treg.define_model(args).fused_norm is True
    args.fused_norm = "conv"
    with pytest.raises(ValueError, match="forward-only"):
        treg.define_model(args)
