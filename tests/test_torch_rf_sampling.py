"""The port's rectified-flow samplers against JAX's on the same NCSN++
weights (the tiny RF config) and the same draws: JAX's keys replayed here
and handed to the port as its start ``z`` and Euler step noise.

Bounds: samples within 1e-5 of max|x| (a few float32 steps of the same
arithmetic); the rk45 sampler takes the same number of evaluations.  rk45
runs at ode_tol 0.1: its error estimate is a difference of nearly equal
sums, which turns the two packages' float32 rounding of a random-weight
network (1e-7 relative) into error ratios that drift apart step by step,
and at tight tolerances into different step sizes (at 1e-5 here 1302
against 1316 evaluations); at 0.1 every accept decision and step size
coincides.  A wrong tableau or controller still misses by far more."""

import jax
import numpy as np
import pytest
import torch

from pnpflow_tpu.training.sampling import (
    get_rectified_flow_sampler as jsampler, get_sampling_fn as jget)
from pnpflow_tpu_torch.training.sampling import (
    get_rectified_flow_sampler, get_sampling_fn)

import rf_tiny

SHAPE = (2, 8, 8, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return rf_tiny.models(seed=3)


def _jax_euler_noise(key, steps, shape, explicit_z):
    """JAX's draws: the start (z=None) and the per-step noise."""
    k0, k1 = jax.random.split(key)
    if explicit_z:
        k_loop, z0 = k1, None
    else:
        k0, k_loop = jax.random.split(k0)
        z0 = np.asarray(jax.random.normal(k0, shape))
    steps_noise = []
    for _ in range(steps):
        k_loop, sub = jax.random.split(k_loop)
        steps_noise.append(np.asarray(jax.random.normal(sub, shape)))
    return z0, np.stack(steps_noise)


@pytest.mark.parametrize("explicit_z", [False, True])
def test_euler_with_injected_noise_matches_jax(pair, explicit_z):
    _, _, apply, params, rf = pair
    kw = dict(use_ode_sampler="euler", sample_N=6, sigma_variance=0.7,
              init_noise_scale=1.3)
    key = jax.random.PRNGKey(5)
    z0, steps = _jax_euler_noise(key, 6, SHAPE, explicit_z)
    if explicit_z:
        z = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
        want, nfe_j = jsampler(apply, SHAPE, **kw)(params, key, z=z)
        start = z
    else:
        want, nfe_j = jsampler(apply, SHAPE, **kw)(params, key)
        start = np.float32(1.3) * z0
    got, nfe = get_rectified_flow_sampler(rf, SHAPE, **kw)(
        z=torch.from_numpy(start), step_noise=torch.from_numpy(steps))
    assert nfe == nfe_j == 6
    rf_tiny.close(got, want, 1e-5)


def test_rk45_matches_jax_with_the_same_nfe(pair):
    jc, tc, apply, params, rf = pair
    jc.sampling.use_ode_sampler = tc.sampling.use_ode_sampler = "rk45"
    jc.sampling.ode_tol = tc.sampling.ode_tol = 0.1
    key = jax.random.PRNGKey(7)
    scale = lambda x: (x + 1.0) / 2.0  # noqa: E731
    want, nfe_j = jget(jc, apply, SHAPE, inverse_scaler=scale)(params, key)
    z = np.asarray(jax.random.normal(key, SHAPE))
    got, nfe = get_sampling_fn(tc, rf, SHAPE, inverse_scaler=scale)(
        z=torch.from_numpy(z))
    assert nfe == nfe_j and nfe > 21
    rf_tiny.close(got, want, 1e-5)


def test_drawn_samples_and_dispatch(pair):
    _, tc, _, _, rf = pair
    for name in ("euler", "rk45"):
        s = get_rectified_flow_sampler(rf, SHAPE, use_ode_sampler=name,
                                       sample_N=3, ode_tol=1e-2)
        a, _ = s(torch.Generator().manual_seed(0))
        b, _ = s(torch.Generator().manual_seed(0))
        assert a.shape == SHAPE and torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
    with pytest.raises(NotImplementedError):
        get_rectified_flow_sampler(rf, SHAPE, init_type="uniform")
    with pytest.raises(ValueError, match="Sampler"):
        get_rectified_flow_sampler(rf, SHAPE, use_ode_sampler="heun")
    tc.sampling.method = "ddim"
    with pytest.raises(ValueError, match="Sampler name"):
        get_sampling_fn(tc, rf, SHAPE)
