"""d_flow's sharded network against JAX's d_flow loss on a mesh-sharded
latent (``pnpflow_tpu_torch/serve.py``, ``parallel/mesh.py:ShardedModel``;
the rest of the coupled restorations: ``tests/test_torch_serve_coupled.py``
and ``tests/test_torch_serve_coupled_ot_ode_pnp_gs.py``).

The port's ``Restorer(shard=True, devices=["cpu", "cpu"])`` for d_flow on
denoising at 16² (the flagship, one checkpoint of real-scale random
weights): the objective and its gradient at one latent through its sharded
network against JAX's loss of the same weights on the latent sharded over
two of the eight virtual CPU devices (``tests/conftest.py``), rel 1e-5 and
1e-4 of max.  The whole LBFGS solve is not compared with JAX's
(``tests/test_torch_d_flow.py``: torch's LBFGS and optax's take different
trajectories).  Most of the test's time is JAX tracing the flagship's VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.parallel import mesh as jmesh
from pnpflow_tpu.solvers.d_flow import make_forward_flow as jax_flow
from pnpflow_tpu_torch.solvers import d_flow
from pnpflow_tpu_torch.utils.jax_params import flax_from_state_dict

from test_torch_serve_coupled import B, Case, _rel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def d_flow_case(tmp_path_factory):
    return Case("d_flow", tmp_path_factory.mktemp("d_flow"))


def test_sharded_d_flow_objective_matches_jax_sharded(d_flow_case):
    case = d_flow_case
    args = case.sharded.args
    steps, start = int(args.steps_euler), float(args.start_time)
    lmbda = float(args.lmbda)
    z = np.random.default_rng(5).normal(size=(B, 16, 16, 3)).astype(
        np.float32)
    forward = d_flow.make_forward_flow(case.sharded.solver.model.grad_forward,
                                       steps, start)
    zt = torch.from_numpy(z).requires_grad_()
    loss = d_flow.make_loss(forward, case.sharded.home_degradation.H,
                            torch.from_numpy(case.y), lmbda)(zt)
    (grad,) = torch.autograd.grad(loss, zt)

    # JAX's flagship on the checkpoint's weights, its loss on z sharded
    # over two devices (denoising: H is the identity)
    m = case.plain.bundle.model
    jforward = jax_flow(JaxUNet(
        input_channels=3, input_height=16, ch=m.ch, ch_mult=m.ch_mult,
        num_res_blocks=m.num_res_blocks,
        attn_resolutions=m.attn_resolutions).apply, steps, start)
    jy = jnp.asarray(case.y)

    def jloss(params, z):
        d = z.shape[1] * z.shape[2] * z.shape[3]
        norm = jnp.sqrt(jnp.sum(z ** 2, axis=(1, 2, 3)))
        reg = 0.5 * jnp.clip(norm ** 2, -1e6, 1e6) - (d - 1) * jnp.log(
            norm + 1e-5)
        resid = jforward(params, z) - jy
        return jnp.sum(jnp.sum(resid ** 2, axis=(1, 2, 3)) + lmbda * reg)

    mesh = jmesh.make_mesh(2)
    want, want_g = jax.jit(jax.value_and_grad(jloss, argnums=1))(
        jmesh.replicate(flax_from_state_dict(m.state_dict()), mesh),
        jmesh.shard_batch(jnp.asarray(z), mesh))
    want, want_g = float(want), np.asarray(want_g)
    assert abs(float(loss.detach()) - want) <= 1e-5 * abs(want)
    assert _rel(grad.numpy(), want_g) <= 1e-4
