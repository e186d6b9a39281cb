"""The port's flow_priors solver against the JAX package: N 5 outer steps of
K 2 Adam steps each, on the same parameters, measurement, start x_init and
Rademacher probes (the probes JAX draws from its key schedule, rebuilt here
and passed through the port's ``probes`` seam).

JAX runs its U-Net with ``fused_norm False`` (its ``custom_vjp`` GroupNorm
refuses the JVP of the trace term); the port runs ``True``, the default for
this method, whose forward-mode rule carries the tangent.

Bound: max-abs 1e-4 after the 5 x 2 steps.  Adam normalises each element's
gradient, so an element whose gradient is rounding noise in both packages
could step by about eta either way; any element beyond the bound is printed
with both gradients' context before the assertion.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.solvers.flow_priors import (
    make_flow_priors_solver as jax_solver)
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.solvers.flow_priors import (
    FlowPriors, make_flow_priors_solver, rademacher)

from test_torch_ot_ode import (
    B, CFG, DIM, PROBLEMS, _args, params, port_model, problem_case)

N, K = 5, 2
KW = dict(N=N, K=K, lmbda=1000.0, eta=0.01, start_time=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_probes(key, shape):
    """The probes JAX's solver draws from ``key``: a split per outer step,
    K keys from it, and one Rademacher draw per inner step
    (``hutchinson_trace`` with one probe)."""
    out = []
    for _ in range(N):
        key, sub = jax.random.split(key)
        out.append([np.asarray(jax.random.rademacher(
            jax.random.split(k, 1)[0], shape, jnp.float32))
            for k in jax.random.split(sub, K)])
    return np.asarray(out)


@pytest.mark.parametrize("noise_type", ["gaussian", "laplace"])
def test_solver_matches_jax(noise_type):
    _, y, _, jop, top = problem_case("gaussian_deblurring_FFT", 1)
    rng = np.random.default_rng(3)
    x_init = rng.normal(size=(B, DIM, DIM, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jm = JaxUNet(**CFG)
    solve = jax_solver(jm.apply, jop.H, noise_type=noise_type,
                       sigma_noise=0.05, **KW)
    h_x_init = jop.H(jnp.asarray(x_init))
    want = np.asarray(solve(params(), jnp.asarray(y), h_x_init,
                            jnp.asarray(x_init), key))
    probes = jax_probes(key, x_init.shape)
    assert set(np.unique(probes)) == {-1.0, 1.0}

    tsolve = make_flow_priors_solver(port_model(), top.H,
                                     noise_type=noise_type, **KW)
    tx = torch.from_numpy(x_init)
    with torch.no_grad():
        got = tsolve(torch.from_numpy(y), top.H(tx), tx,
                     lambda i, k: torch.from_numpy(probes[i, k])).numpy()
    err = np.abs(got - want)
    for idx in zip(*np.nonzero(err > 1e-4)):
        print(f"element {idx}: port {got[idx]}, JAX {want[idx]}, "
              f"start {x_init[idx]}")
    assert np.isfinite(want).all() and np.abs(want - x_init).max() > 0.1
    assert err.max() <= 1e-4


def test_rademacher_probes_are_signs():
    g = torch.Generator().manual_seed(0)
    r = rademacher((4, 8, 8, 3), g, torch.device("cpu"))
    assert set(r.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(r.mean())) < 0.1


def test_flow_priors_runs_from_solve_ip():
    args = _args(method="flow_priors", N=2, K=1, lmbda=1000.0, eta=0.01,
                 start_time=0.0)
    model = port_model()
    solver = FlowPriors(ModelBundle(model=model, device=torch.device("cpu")),
                        args)
    clean = np.tanh(np.random.default_rng(2).normal(size=(B, DIM, DIM, 3)))
    solver.solve_ip([(clean.astype(np.float32), np.zeros(B))],
                    PROBLEMS["gaussian_deblurring_FFT"][1](), 0.05)
    assert args.batch == 0
