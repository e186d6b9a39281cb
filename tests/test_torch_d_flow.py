"""The port's d_flow pieces against the JAX package on the same parameters,
measurement and latent: the forward flow T(z) (midpoint steps under
checkpoints), the objective and its gradient, and a whole solve.

The port optimises with ``torch.optim.LBFGS`` (strong Wolfe), as the
upstream reference does; JAX with optax's ``lbfgs`` and a zoom line search.
The two take different trajectories from one start (an intended
divergence, ROADMAP queue 1 item 8), so a whole solve is held to lowering
its own objective, and the gap to JAX's final objective is printed.

Bounds: T(z) within 1e-5 max-abs; the loss within 1e-5 relative; its
gradient within 1e-4 of max|grad|.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.solvers.d_flow import (
    make_d_flow_solver as jax_solver, make_forward_flow as jax_flow)
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.solvers.d_flow import (
    DFlow, lbfgs_solve, make_forward_flow, make_loss)

from test_torch_ot_ode import (
    B, CFG, DIM, PROBLEMS, _args, params, port_model, problem_case)

STEPS_EULER, START, LMBDA = 3, 0.0, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case():
    _, y, _, jop, top = problem_case("gaussian_deblurring_FFT", 4)
    z = np.random.default_rng(9).normal(size=(B, DIM, DIM, 3)).astype(
        np.float32)
    return y, z, jop, top


def _jax_loss(jop, y):
    """The objective of the JAX solver (``make_d_flow_solver``'s
    ``loss_fn``) on its own forward flow."""
    forward = jax_flow(JaxUNet(**CFG).apply, STEPS_EULER, START)

    def loss_fn(z):
        d = z.shape[1] * z.shape[2] * z.shape[3]
        norm = jnp.sqrt(jnp.sum(z ** 2, axis=(1, 2, 3)))
        reg = 0.5 * jnp.clip(norm ** 2, -1e6, 1e6) - (d - 1) * jnp.log(
            norm + 1e-5)
        resid = jop.H(forward(params(), z)) - y
        return jnp.sum(jnp.sum(resid ** 2, axis=(1, 2, 3)) + LMBDA * reg)

    return loss_fn


def _port_loss(top, y):
    forward = make_forward_flow(port_model(), STEPS_EULER, START)
    return make_loss(forward, top.H, torch.from_numpy(y), LMBDA)


def test_forward_flow_matches_jax():
    _, z, _, _ = _case()
    want = np.asarray(jax_flow(JaxUNet(**CFG).apply, STEPS_EULER, START)(
        params(), jnp.asarray(z)))
    with torch.no_grad():
        got = make_forward_flow(port_model(), STEPS_EULER, START)(
            torch.from_numpy(z)).numpy()
    assert np.abs(want - z).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5


def test_loss_and_gradient_match_jax():
    y, z, jop, top = _case()
    want, want_g = jax.value_and_grad(_jax_loss(jop, jnp.asarray(y)))(
        jnp.asarray(z))
    want, want_g = float(want), np.asarray(want_g)
    tz = torch.from_numpy(z).requires_grad_()
    loss = _port_loss(top, y)(tz)
    (g,) = torch.autograd.grad(loss, tz)
    assert abs(float(loss.detach()) - want) <= 1e-5 * abs(want)
    assert np.abs(g.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()


def test_whole_solve_lowers_the_objective():
    y, z, jop, top = _case()
    jloss = _jax_loss(jop, jnp.asarray(y))
    solve = jax_solver(JaxUNet(**CFG).apply, jop.H, steps_euler=STEPS_EULER,
                       start_time=START, lmbda=LMBDA, max_iter=1,
                       lbfgs_iter=5)
    jz, _ = solve(params(), jnp.asarray(y), jnp.asarray(z))
    jax_final = float(jloss(jz))

    loss_fn = _port_loss(top, y)
    with torch.no_grad():
        initial = float(loss_fn(torch.from_numpy(z)))
        got = lbfgs_solve(loss_fn, torch.from_numpy(z), max_iter=1,
                          lbfgs_iter=5)
        final = float(loss_fn(got))
    print(f"d_flow objective: start {initial:.6g}, port {final:.6g}, "
          f"JAX {jax_final:.6g} (port - JAX {final - jax_final:.6g}, "
          f"{(final - jax_final) / abs(jax_final):.3g} of JAX's)")
    assert np.isfinite(final) and final < initial


def test_d_flow_runs_from_solve_ip():
    """The whole method from the outer loop: the dopri5 inversion and the
    LBFGS through the flow, under no_grad outside what it differentiates."""
    args = _args(method="d_flow", steps_euler=3, lmbda=LMBDA, alpha=0.1,
                 max_iter=1, LBFGS_iter=2, start_time=0.0)
    solver = DFlow(ModelBundle(model=port_model(),
                               device=torch.device("cpu")), args)
    clean = np.tanh(np.random.default_rng(2).normal(size=(B, DIM, DIM, 3)))
    solver.solve_ip([(clean.astype(np.float32), np.zeros(B))],
                    PROBLEMS["gaussian_deblurring_FFT"][1](), 0.05)
    assert args.batch == 0
