"""The port's demos (``pnpflow_tpu_torch/demos/``) against the JAX scripts
(``toy_example.py``, ``demo/dirichlet.py``) on the same parameters and
injected noise, and each demo's ``main`` at its shrunk knobs.

- the toy MLP's flow-matching step: loss within rel 1e-5, the parameters
  after one Adam step (lr 1e-3) within 1e-5;
- the 2-D PnP-Flow iterations: within 1e-5 after 5 steps;
- the Dirichlet PnP step and the Dirichlet D-Flow objective (value rel
  1e-5, gradient to the latent within 1e-4 of its max) with the notebooks'
  small U-Net (``demo/dirichlet.py``'s, attention at 16 never reached at
  28x28).
"""

import functools
import importlib.util
import math
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu_torch.demos import demo, dirichlet, toy_example
from pnpflow_tpu_torch.utils.jax_params import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # flax's dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def jax_toy():
    return _load("jax_toy_example", os.path.join(REPO, "toy_example.py"))


@functools.lru_cache(maxsize=None)
def jax_dirichlet():
    return _load("jax_dirichlet", os.path.join(REPO, "demo", "dirichlet.py"))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def toy_case():
    """JAX's MLP parameters and the port's MLP carrying them."""
    params = jax_toy().VelocityMLP().init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 2)), jnp.zeros((1,)))
    return params


def _toy_port(params):
    m = toy_example.VelocityMLP()
    with torch.no_grad():
        for i, lin in enumerate(m.layers):
            d = params["params"][f"Dense_{i}"]
            lin.weight.copy_(_t(d["kernel"]).T)
            lin.bias.copy_(_t(d["bias"]))
    return m


def test_toy_fm_step_matches_jax():
    params = toy_case()
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((64, 2)).astype(np.float32)
    x1 = (2.0 * rng.standard_normal((64, 2))).astype(np.float32)
    t = rng.uniform(size=(64,)).astype(np.float32)
    model = jax_toy().VelocityMLP()

    def loss_fn(p):
        xt = t[:, None] * x1 + (1 - t[:, None]) * x0
        return jnp.sum((model.apply(p, xt, t) - (x1 - x0)) ** 2) / 64

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adam(1e-3)
    upd, _ = tx.update(grads, tx.init(params))
    want = optax.apply_updates(params, upd)

    m = _toy_port(params)
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    got = toy_example.fm_step(m, opt, _t(x0), _t(x1), _t(t))
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    for i, lin in enumerate(m.layers):
        d = want["params"][f"Dense_{i}"]
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(d["kernel"]).T, atol=1e-5)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(d["bias"]), atol=1e-5)


def test_toy_pnp_iterations_match_jax():
    params = toy_case()
    model = jax_toy().VelocityMLP()
    rng = np.random.default_rng(1)
    steps, S, n = 5, 3, 16
    eps = rng.standard_normal((steps, S, n, 2)).astype(np.float32)
    A = np.array([[1.0, 0.0]], np.float32)
    y = (2.0 * rng.standard_normal((1, n))).astype(np.float32)
    # toy_example.pnp_flow_2d's body with its draws replaced by eps
    x = jnp.zeros((n, 2))
    sigma = 0.3
    for i in range(steps):
        t = jnp.float32(i) / steps
        lr_t = sigma ** 2 * 1.0 * (1 - t)
        z = x - lr_t / sigma ** 2 * (A.T @ (A @ x.T - y)).T
        flat = (t * z[None] + (1 - t) * eps[i]).reshape(-1, 2)
        den = flat + (1 - t) * model.apply(params, flat,
                                           jnp.full((flat.shape[0],), t))
        x = jnp.mean(den.reshape(S, -1, 2), axis=0)
    got, traj = toy_example.pnp_flow_2d(
        _toy_port(params), _t(y), _t(A), steps=steps, num_samples=S,
        eps_seq=_t(eps))
    assert traj.shape == (steps, n, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(x), atol=1e-5)


@functools.lru_cache(maxsize=None)
def diri_case():
    """Real-scale parameters of the notebooks' U-Net, a batch and the
    draws, from numpy seeds, at unit scale.  On the simplex itself (pixels
    near 1/784) the one-pass variance E[x^2] - E[x]^2 that both packages'
    GroupNorms take cancels in float32 (the first norms' inputs vary by
    1e-4 of their mean), so the two frameworks' summation orders alone move
    the U-Net's output by up to 1e-2 of its max; the steps' arithmetic is
    held where the network is well conditioned."""
    rng = np.random.default_rng(3)
    cfg = dict(input_channels=1, input_height=28, ch=32, ch_mult=(1, 2),
               num_res_blocks=2, attn_resolutions=(16,))
    shapes = jax.eval_shape(JaxUNet(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif "bias" in name:
            v = 0.1 * rng.normal(size=leaf.shape)
        else:
            v = rng.normal(size=leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    x = rng.standard_normal((2, 28, 28, 1)).astype(np.float32)
    draws = rng.standard_normal((2, 2, 28, 28, 1)).astype(np.float32)
    model = demo.small_unet(channels=1, dim=28)
    model.load_state_dict(state_dict_from_flax(params))
    return cfg, params, x, draws, model.eval()


def test_dirichlet_pnp_step_matches_jax():
    cfg, params, x, draws, model = diri_case()
    apply = jax.jit(JaxUNet(**cfg, fused_norm=True).apply)
    y = x[:, ::2, ::2] + 1e-4
    H, H_adj = jax_dirichlet().downsample, jax_dirichlet().upsample
    t = np.float32(3) / np.float32(10)
    # dirichlet.pnp_dirichlet's step with the draws given
    z = x - (1.0 - t) * H_adj(H(x) - y)
    acc = jnp.zeros_like(z)
    for z2 in draws:
        zn = t * z + (1.0 - t) * z2
        acc = acc + zn + (1.0 - t) * apply(params, zn, jnp.full((2,), t))
    want = np.asarray(acc / len(draws))
    got = dirichlet.pnp_step(model, _t(x), _t(y), dirichlet.downsample,
                             dirichlet.upsample, float(t), list(_t(draws)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(
        want).max())


def test_dirichlet_dflow_objective_matches_jax():
    cfg, params, x, draws, model = diri_case()
    jd = jax_dirichlet()
    jm = JaxUNet(**cfg, fused_norm=True)
    y = x[:, :14] + 1e-4
    z = draws[0]

    def objective(zz):
        xx = jd.flow_forward(jm, params, zz)
        fit = jnp.mean(jnp.sum((xx[:, :14] - y) ** 2, axis=(1, 2, 3)))
        return fit + 100.0 * jnp.mean((jnp.sum(zz, axis=(1, 2, 3)) - 1) ** 2)

    value, grad = jax.jit(jax.value_and_grad(objective))(z)
    zt = _t(z).requires_grad_()
    got = dirichlet.dflow_objective(model, zt, _t(y), lambda a: a[:, :14],
                                    100.0)
    got.backward()
    assert abs(got.item() - float(value)) <= 1e-5 * abs(float(value))
    g = np.asarray(grad)
    assert np.abs(zt.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max()


def test_dirichlet_draws_lie_on_the_simplex():
    s = dirichlet.dirichlet_sample(3, torch.Generator().manual_seed(0))
    assert s.shape == (3, 28, 28, 1) and float(s.min()) > 0
    torch.testing.assert_close(s.sum(dim=(1, 2, 3)), torch.ones(3))
    up = dirichlet.upsample(dirichlet.downsample(s))
    assert torch.equal(up[:, ::2, ::2], s[:, ::2, ::2])
    assert float(up.sum()) == pytest.approx(float(s[:, ::2, ::2].sum()))


def test_dirichlet_dflow_lbfgs_lowers_the_objective(capsys):
    """``dflow_dirichlet``'s LBFGS loop on a pointwise linear field: the
    objective falls, and the result is the flow of the optimised latent."""
    field = torch.nn.Conv2d(1, 1, 1)
    with torch.no_grad():
        field.weight.fill_(0.3)
        field.bias.fill_(1e-3)

    def model(x, t):
        return field(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    model.requires_grad_ = field.requires_grad_
    gen = torch.Generator().manual_seed(0)
    clean = dirichlet.dirichlet_sample(dirichlet.B, gen)
    y = dirichlet.downsample(clean)
    z0 = math.sqrt(0.1) * dirichlet.flow_inverse(
        model, dirichlet.H_adj_init(y)) + math.sqrt(0.9) * \
        dirichlet.dirichlet_sample(dirichlet.B,
                                   torch.Generator().manual_seed(5))
    with torch.no_grad():
        start = float(dirichlet.dflow_objective(
            model, z0, y, dirichlet.downsample, 100.0))
    x = dirichlet.dflow_dirichlet(model, y, dirichlet.downsample,
                                  torch.Generator().manual_seed(5), 100.0,
                                  iters=3)
    assert x.shape == clean.shape and bool(torch.isfinite(x).all())
    end = float(capsys.readouterr().out.split("objective")[-1])
    assert end < start


def test_toy_main(tmp_path):
    toy_example.main(["--device", "cpu", "--steps", "2",
                      "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["toy_flow.png", "toy_pnp.png"]


def test_demo_main(tmp_path):
    x = demo.main(["--device", "cpu", "--epochs", "1", "--steps-per-epoch",
                   "1", "--pnp-steps", "2", "--out", str(tmp_path)])
    assert x.shape == (4, 32, 32, 3) and bool(torch.isfinite(x).all())
    assert os.listdir(tmp_path) == ["demo_restoration.png"]


def test_dirichlet_main(tmp_path, monkeypatch):
    # no LBFGS iteration: one takes about 20 s here, its strong-Wolfe line
    # search evaluating the 12-forward flow many times (the loop is held by
    # the test above on a small model); the inverse flow that starts D-Flow
    # in 2 Euler steps, not 24
    inverse = dirichlet.flow_inverse
    monkeypatch.setattr(dirichlet, "flow_inverse",
                        lambda model, x: inverse(model, x, 2))
    for k, v in dict(DIRI_STEPS="2", DIRI_MC="1", DIRI_TRAIN_ITERS="1",
                     DIRI_DFLOW_ITERS="0",
                     DIRI_OUT=str(tmp_path / "out")).items():
        monkeypatch.setenv(k, v)
    out = dirichlet.main(["--device", "cpu"])
    assert sorted(out) == ["denoising", "inpainting", "sr2"]
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        ["clean.png"] + [f"{k}_{n}.png" for k in ("pnp", "dflow")
                         for n in ("sr2", "denoising", "inpainting")])
    for x_pnp, x_df in out.values():
        assert bool(torch.isfinite(x_pnp).all() & torch.isfinite(x_df).all())
