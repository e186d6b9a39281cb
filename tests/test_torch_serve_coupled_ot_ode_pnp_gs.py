"""Sharded serving of ot_ode on bicubic super-resolution and pnp_gs hqs
deblurring, the restorations that couple a batch's images through GMRES
and through the step-size backtracking (``pnpflow_tpu_torch/serve.py``;
the wrapper and d_flow: ``tests/test_torch_serve_coupled.py``).

At the flagship widths from one msgpack checkpoint of random weights at a
real scale, ``Restorer(shard=True, devices=["cpu", "cpu"])`` against the
unsharded ``Restorer``: ot_ode at 32² (2 VJP steps) and pnp_gs at 64² (1
iteration; the 61-tap blur must fit) within 1e-4 max-abs.  Against JAX's
``Restorer(shard=True, n_devices=2)`` (two of the eight virtual CPU
devices, ``tests/conftest.py``) reading the same checkpoint, within 1e-4
max-abs: ot_ode from one injected start (JAX's ``solve_batch`` draws its
start in y's shape, which does not broadcast for super-resolution), and
pnp_gs's first request (JAX's ``Restorer`` carries the backtracked alpha
into later ones).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve_coupled import B, Case, sharded_equals_unsharded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(request, tmp_path_factory):
    return Case(request.param, tmp_path_factory.mktemp(request.param),
                with_jax=True)


def _shard_jax(jr, a):
    return jr._shard_batch(jnp.asarray(a), jr.mesh)


@pytest.mark.parametrize("case", ["ot_ode", "pnp_gs"], indirect=True)
def test_sharded_restore_equals_unsharded(case):
    # the sharded backward runs in this thread (serve.Restorer.restore)
    threads = []
    hook = case.sharded.solver.model.model.replicas[1].register_forward_hook(
        lambda *_: threads.append(torch._C._is_multithreading_enabled()))
    try:
        got, want = sharded_equals_unsharded(case)
    finally:
        hook.remove()
    assert threads and not any(threads)
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("case", ["ot_ode"], indirect=True)
def test_sharded_ot_ode_matches_jax_sharded(case):
    r, jr = case.sharded, case.jax
    steps = int(r.args.steps_ode)
    first = int(steps * float(r.args.start_time))
    x0 = np.random.default_rng(4).normal(size=(B, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        got, _ = r.solver.solve_batch(
            None, torch.from_numpy(case.y), r.home_degradation,
            r.sigma_noise, 0, x_init=torch.from_numpy(x0))
    solve = jr.solver._build(jr.degradation, jr.sigma_noise)
    want = np.asarray(solve(jr.bundle.params, _shard_jax(jr, case.y),
                            _shard_jax(jr, x0), None,
                            jnp.asarray(first, jnp.int32), steps - first))
    assert np.abs(want - x0).max() > 0.1
    assert np.abs(got.numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("case", ["pnp_gs"], indirect=True)
def test_sharded_pnp_gs_matches_jax_sharded(case):
    want = case.jax.restore(case.y, seed=3)
    got = case.sharded.restore(case.y, seed=3)
    assert np.abs(got - want).max() <= 1e-4
