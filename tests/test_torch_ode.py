"""The port's ODE integrators and GMRES against the JAX package.

The trainer's dopri5 sampler (``apply_flow_matching(method="dopri5")``)
from JAX's z and the same parameters: within 1e-5 max-abs of JAX's, with
the same number of model evaluations.

Bounds: dopri5 within 1e-5 max-abs of JAX's ``_odeint_dopri5_stats`` with
the same number of function evaluations, on the U-Net from t = 1 to 0 (the
d_flow inversion) and on a linear field whose solution is known; euler,
midpoint and heun within 1e-6 of max(1, max|x|) (states near 4.5, where a
float32 ulp is 4.8e-7); GMRES on the ot_ode system for bicubic
super-resolution within 1e-4 of max(1, max|sol|) of
``jax.scipy.sparse.linalg.gmres`` (batched, the JAX defaults): at
sigma^2 = 0.0025 the solution is up to 1/sigma^2 = 400 times d, so an
absolute bound would ask for more digits than float32 holds.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.ops import ode as jode
from pnpflow_tpu.ops.degradations import Superresolution as JaxSR
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.ops import ode
from pnpflow_tpu_torch.ops.degradations import Superresolution
from pnpflow_tpu_torch.ops.linalg import gmres
from pnpflow_tpu_torch.training import flow_matching as fm
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import state_dict_from_flax

CFG = dict(input_channels=3, input_height=32, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,))
RATE = np.float32(-0.7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _unet():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(JaxUNet(**CFG).init, jax.random.PRNGKey(0), x,
                            np.zeros((2,), np.float32))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif "bias" in name:
            v = 0.1 * rng.normal(size=leaf.shape)
        else:
            v = 0.5 * rng.normal(size=leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    m = VelocityUNet(**CFG, fused_norm=True)
    m.load_state_dict(state_dict_from_flax(params))
    return params, m.eval(), x


def _fields():
    """(JAX field, port field, x0) of the U-Net and of dx/dt = RATE x."""
    params, m, x = _unet()
    jm = JaxUNet(**CFG)

    def jf(z, t):
        return jm.apply(params, z, jnp.full((z.shape[0],), t, jnp.float32))

    def tf(z, t):
        return m(z, torch.full((z.shape[0],), t, dtype=torch.float32))

    return {"unet": (jf, tf, x),
            "linear": (lambda z, t: RATE * z, lambda z, t: float(RATE) * z,
                       x)}


@pytest.mark.parametrize("field", ["unet", "linear"])
def test_dopri5_matches_jax_with_equal_nfe(field):
    jf, tf, x = _fields()[field]
    want, want_nfe = jode._odeint_dopri5_stats(jf, jnp.asarray(x), 1.0, 0.0)
    with torch.no_grad():
        got, nfe = ode.odeint_dopri5_stats(tf, torch.from_numpy(x), 1.0, 0.0)
    assert nfe == int(want_nfe) and nfe > 7
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
    if field == "linear":  # x(0) = exp(-RATE) x(1)
        exact = np.exp(-np.float64(RATE)) * x
        assert np.abs(got.numpy() - exact).max() <= 1e-4


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun"])
@pytest.mark.parametrize("field", ["unet", "linear"])
def test_fixed_step_integrators_match_jax(method, field):
    jf, tf, x = _fields()[field]
    want = jode.odeint(jf, jnp.asarray(x), 0.1, 1.0, method=method, steps=5)
    with torch.no_grad():
        got = getattr(ode, f"odeint_{method}")(tf, torch.from_numpy(x), 0.1,
                                                1.0, 5)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(
        1.0, np.abs(want).max())


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "dopri5"])
def test_odeint_dispatches_like_jax(method):
    jf, tf, x = _fields()["linear"]
    want = jode.odeint(jf, jnp.asarray(x), 0.0, 1.0, method=method, steps=4)
    got = ode.odeint(tf, torch.from_numpy(x), 0.0, 1.0, method=method,
                     steps=4)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6 * max(
        1.0, float(np.abs(want).max()))
    with pytest.raises(ValueError, match="Unknown ODE method"):
        ode.odeint(tf, torch.from_numpy(x), 0.0, 1.0, method="rk4")


def test_trainer_dopri5_sampler_matches_jax(tmp_path):
    """``apply_flow_matching(method="dopri5")`` samples as JAX's trainer
    does from the z JAX draws from its key: JAX's method is
    ``odeint_dopri5`` of the model from z, t = 0 to 1, rtol = atol = 1e-5
    (``pnpflow_tpu/training/flow_matching.py:469-479``), run here through
    ``_odeint_dopri5_stats``, which also gives its nfe."""
    params, _, _ = _unet()
    n, key = 2, jax.random.PRNGKey(3)
    args = {"dataset": "synthetic", "model": "ot", "dim_image": 32,
            "num_channels": 3, "lr": 1e-3, "num_epoch": 1, "seed": 0,
            "output_root": str(tmp_path), "batch_size_train": 2}
    z = np.asarray(jax.random.normal(key, (n, 32, 32, 3)))
    jm = JaxUNet(**CFG)
    want, want_nfe = jode._odeint_dopri5_stats(
        lambda x, t: jm.apply(params, x, jnp.full((x.shape[0],), t,
                                                   jnp.float32)),
        jnp.asarray(z), 0.0, 1.0, rtol=1e-5, atol=1e-5)
    want = np.asarray(want)

    model = VelocityUNet(**CFG, fused_norm=True)
    model.load_state_dict(state_dict_from_flax(params))
    tr = fm.FlowMatchingTrainer(CfgNode(dict(args, device="cpu")),
                                model=model)
    state = fm.new_state(tr.model, tr.lr)
    calls = []
    tr.model.register_forward_pre_hook(lambda *a: calls.append(1))
    got = tr.apply_flow_matching(state, n, method="dopri5", z=z)
    assert len(calls) == int(want_nfe) and len(calls) > 7
    assert np.abs(got.numpy() - want).max() <= 1e-5
    with pytest.raises(ValueError, match="euler or dopri5"):
        tr.apply_flow_matching(state, n, method="rk4", z=z)


def test_dopri5_respects_max_steps():
    _, tf, x = _fields()["linear"]
    got, nfe = ode.odeint_dopri5_stats(tf, torch.from_numpy(x), 1.0, 0.0,
                                       max_steps=2)
    assert nfe == 14 and not torch.equal(got, torch.from_numpy(x))


@pytest.mark.parametrize("rt2", [0.05, 0.5, 0.95])
def test_gmres_matches_jax_on_bicubic_superresolution(rt2):
    """ot_ode's generic branch: (rt2 H H_adj + s2 I) sol = d for bicubic
    super-resolution, the whole batch one vector, as JAX solves it."""
    s2 = 0.05 ** 2
    rng = np.random.default_rng(int(rt2 * 100))
    d = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    jop = JaxSR(4, 32, mode="bicubic")
    top = Superresolution(4, 32, mode="bicubic", device="cpu")
    want, _ = jax.scipy.sparse.linalg.gmres(
        lambda z: rt2 * jop.H(jop.H_adj(z)) + s2 * z, jnp.asarray(d),
        maxiter=100, solve_method="batched")
    want = np.array(want)

    def C(z):
        return rt2 * top.H(top.H_adj(z)) + s2 * z

    got, restarts = gmres(C, torch.from_numpy(d), maxiter=100)
    res_port = float((C(got) - torch.from_numpy(d)).norm())
    res_jax = float((C(torch.from_numpy(want)) - torch.from_numpy(d)).norm())
    print(f"rt2 {rt2}: residual port {res_port:.3e}, JAX {res_jax:.3e}, "
          f"|d| {np.linalg.norm(d):.3e}, restarts {restarts}")
    assert np.abs(got.numpy() - want).max() <= 1e-4 * max(
        1.0, np.abs(want).max())
    assert res_port <= 1e-4 * np.linalg.norm(d)
