"""The port's likelihood (Hutchinson divergence, the midpoint
change-of-variables solve, bits/dim) against JAX's on the same NCSN++ (the
CelebA-HQ RF config cut to 16x16, so every JVP goes through the FIR
resampling's tangent) and the same Rademacher probes, JAX's replayed from
its keys.

Bounds: the divergence within 1e-5 of its max (one JVP in float32);
log-likelihood and bits/dim at 3 steps within 1e-4 relative (the
divergence sums over D terms and the solve compounds 3 steps)."""

import jax
import numpy as np
import pytest
import torch

from pnpflow_tpu.ops import likelihood as jlik
from pnpflow_tpu_torch.ops import likelihood as tlik

import rf_tiny

SHAPE = (2, 16, 16, 3)


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
    _, _, apply, params, rf = rf_tiny.models(fir=True, seed=11)

    def jfwd(x, t):
        return apply(params, x, t)

    return jfwd, rf


def _x():
    rng = np.random.default_rng(12)
    return np.tanh(rng.normal(size=SHAPE)).astype(np.float32)


def _jax_probes(key, n):
    return [np.asarray(jax.random.rademacher(k, SHAPE, np.float32))
            for k in jax.random.split(key, n)]


def test_divergence_with_injected_probes_matches_jax(pair):
    jfwd, rf = pair
    x, key = _x(), jax.random.PRNGKey(3)
    t = np.asarray([0.3, 0.8], np.float32)
    want = np.asarray(jax.jit(jlik.divergence_hutchinson, static_argnums=(
        0, 4))(jfwd, x, t, key, 2))
    probes = [torch.from_numpy(p) for p in _jax_probes(key, 2)]
    got = tlik.divergence_hutchinson(rf, torch.from_numpy(x),
                                     torch.from_numpy(t), probes=probes)
    rf_tiny.close(got, want, 1e-5)
    drawn = tlik.divergence_hutchinson(
        rf, torch.from_numpy(x), torch.from_numpy(t),
        generator=torch.Generator().manual_seed(0), n_probes=3)
    assert drawn.shape == (2,) and bool(torch.isfinite(drawn).all())


def _step_probes(key, steps, n):
    """JAX's probes of each step's midpoint evaluation: every evaluation
    splits the carried key, and the midpoint's subkey gives the probes."""
    out = []
    for _ in range(steps):
        key, _ = jax.random.split(key)
        key, sub = jax.random.split(key)
        out.append(np.stack(_jax_probes(sub, n)))
    return out


def test_log_likelihood_and_bits_per_dim_match_jax(pair):
    jfwd, rf = pair
    x, key = _x(), jax.random.PRNGKey(4)
    want, wz = jlik.log_likelihood(jfwd, x, key, steps=3, n_probes=1)
    probes = _step_probes(key, 3, 1)
    got, z = tlik.log_likelihood(rf, torch.from_numpy(x), steps=3,
                                 probes=probes)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    rf_tiny.close(z, wz, 1e-5)
    wb = np.asarray(jlik.bits_per_dim(jfwd, x, key, steps=3))
    gb = tlik.bits_per_dim(rf, torch.from_numpy(x), steps=3, probes=probes)
    assert np.abs(gb.numpy() - wb).max() <= 1e-4 * np.abs(wb).max()
    drawn = tlik.bits_per_dim(rf, torch.from_numpy(x), steps=2,
                              generator=torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(drawn).all())


def test_rademacher_draws():
    r = tlik.rademacher((4000,), torch.Generator().manual_seed(0))
    assert set(np.unique(r.numpy())) == {-1.0, 1.0}
    assert abs(float(r.mean())) < 0.05 and r.dtype == torch.float32
