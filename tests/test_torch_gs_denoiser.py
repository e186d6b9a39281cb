"""The port's gradient-step denoiser and its trainer
(``pnpflow_tpu_torch/training/denoiser.py``) against the JAX package's
(``pnpflow_tpu/training/denoiser.py``) on the same parameters, images, sigma
and noise.

The model is ``tests/test_solvers.py``'s U-Net (32x32, 3 channels, ch 32,
mult (1, 2), one block, attention at 16) with every parameter drawn at a
real scale.  JAX runs it with ``fused_norm False``; the port with ``True``
(the plain kernel versions on the CPU, through the autograd function) and
``False``.  The GS loss differentiates a VJP of the model, so its parameter
gradient is second order through the GroupNorm rules.

Bounds:
- ``calculate_grad``: Dg and N within 1e-5 of their max, g within rel 1e-5;
- the GS loss within rel 1e-5, each gradient tensor within 1e-4 of its
  max|g|; tensors whose JAX gradient is below 1e-6 of the largest are zero
  in exact arithmetic (attention key biases, biases that meet a GroupNorm
  of one channel a group) and are held to being noise in the port too;
- the Jacobian spectral norm (3 power steps from one start) within rel 1e-4;
- one Adam step (lr 1e-4) of the JAX trainer's ``train_step`` with the u it
  draws from its key: parameters within 1e-5 max-abs, where an element may
  miss only if both packages' gradients there are noise (Adam's first step
  is about lr times the gradient's sign, and noise has no sign).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.training import denoiser as jd
from pnpflow_tpu.utils.config import CfgNode as JaxCfg
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.training import denoiser as td
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import state_dict_from_flax

DIM, B = 32, 2
CFG = dict(input_channels=3, input_height=DIM, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,))
NOISE_FLOOR = 1e-6
SIGMA = 0.13
KEY = jax.random.PRNGKey(3)
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def case():
    """(params, y, u): real-scale random parameters, images, and the u that
    JAX's train step draws from KEY."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(JaxUNet(**CFG).init, jax.random.PRNGKey(0),
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

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    y = np.tanh(rng.normal(size=(B, DIM, DIM, 3)) * 0.4).astype(np.float32)
    u = np.asarray(jax.random.normal(KEY, y.shape, jnp.float32))
    return params, y, u


def port_model(fused):
    m = VelocityUNet(**CFG, fused_norm=fused)
    m.load_state_dict(state_dict_from_flax(case()[0]))
    return m


def _t(a):
    return torch.from_numpy(np.array(a))


def _sigma_vec():
    return np.full((B,), SIGMA, np.float32)


@functools.lru_cache(maxsize=None)
def jax_calculate_grad():
    params, y, u = case()
    fn = jax.jit(lambda p, x, s: jd.make_calculate_grad(JaxUNet(**CFG).apply)(
        p, x, s, compute_g=True))
    return tuple(np.asarray(v) for v in fn(params, y + SIGMA * u,
                                           _sigma_vec()))


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads():
    """The JAX trainer's loss (``GradientStepTrainer._build_train_step``'s
    ``loss_fn`` with u given) and its parameter gradient."""
    params, y, u = case()
    forward = jd.make_denoiser_forward(JaxUNet(**CFG).apply)

    def loss_fn(p):
        x = y + SIGMA * u
        x_hat, _ = forward(p, x, jnp.full((B,), SIGMA, jnp.float32))
        return jnp.mean(jnp.mean((x_hat - y).reshape(B, -1) ** 2, axis=1))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), state_dict_from_flax(jax.device_get(grads))


def _trainer(tmp_path, model=None, **extra):
    args = dict({"dataset": "synthetic", "model": "gradient_step",
                 "dim_image": DIM, "num_channels": 3, "lr": LR,
                 "num_epoch": 1, "seed": 0, "output_root": str(tmp_path),
                 "batch_size_train": B, "device": "cpu"}, **extra)
    return td.GradientStepTrainer(CfgNode(args), model=model or port_model(
        True))


@pytest.mark.parametrize("fused", [True, False])
def test_calculate_grad_matches_jax(fused):
    params, y, u = case()
    want_dg, want_n, want_g = jax_calculate_grad()
    with torch.no_grad():
        dg, n, g = td.calculate_grad(port_model(fused), _t(y + SIGMA * u),
                                     _t(_sigma_vec()), compute_g=True)
    assert dg.grad_fn is None and n.grad_fn is None
    for got, want in ((dg, want_dg), (n, want_n)):
        scale = np.abs(want).max()
        assert scale > 0.1
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    assert abs(float(g) - float(want_g)) <= 1e-5 * abs(float(want_g))


@pytest.mark.parametrize("fused", [True, False])
def test_gs_loss_and_second_order_gradients_match_jax(fused):
    from pnpflow_tpu_torch.ops.gn_swish import _GroupNormSwish

    params, y, u = case()
    want_loss, want = jax_loss_and_grads()
    m = port_model(fused)
    calls = _GroupNormSwish.backward_calls
    x = _t(y + SIGMA * u)
    sv = torch.full((B,), SIGMA)
    with torch.enable_grad():
        x_hat, _ = td.denoiser_forward(m, x, sv, create_graph=True)
        loss = ((x_hat - _t(y)) ** 2).reshape(B, -1).mean(dim=1).mean()
        got = dict(zip([n for n, _ in m.named_parameters()],
                       torch.autograd.grad(loss, list(m.parameters()))))
    # True: the autograd function's backward runs at each of the model's
    # GroupNorms twice, in the VJP and in the parameter gradient of N's own
    # path; the gradient through the VJP differentiates the backward's
    # recorded plain ops
    n_norms = sum(isinstance(mod, torch.nn.GroupNorm) for mod in m.modules())
    assert _GroupNormSwish.backward_calls - calls == (
        2 * n_norms if fused else 0)
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    assert set(got) == set(want)
    gmax = max(float(g.abs().max()) for g in want.values())
    noise = 0
    for n, g in got.items():
        scale = float(want[n].abs().max())
        if scale < NOISE_FLOOR * gmax:
            noise += 1
            assert float(g.abs().max()) < NOISE_FLOOR * gmax, n
            continue
        err = float((g - want[n]).abs().max())
        assert err <= 1e-4 * scale, (n, err, scale)
    assert 0 < noise < len(got) // 4


def test_jacobian_spectral_norm_matches_jax():
    params, y, u = case()
    x = y + SIGMA * u
    key = jax.random.PRNGKey(7)
    jac = jax.jit(functools.partial(
        jd.make_jacobian_spectral_norm(JaxUNet(**CFG).apply), steps=3))
    want = np.asarray(jac(params, x, _sigma_vec(), key))
    # JAX's start: U[0, 1) drawn from the key, injected into the port
    v0 = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    got = td.jacobian_spectral_norm(port_model(True), _t(x), _t(_sigma_vec()),
                                    v0=_t(v0), steps=3)
    assert want.shape == (B,) and np.all(want > 0.1)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-4 * want.max()


@pytest.mark.parametrize("jtype", ["max", "exp"])
def test_jacobian_penalty_enters_the_loss_with_its_gradient(tmp_path, jtype):
    """The penalty's term is ``w * clip(max(jn, 1 - eps) or exp(jn - 1 -
    eps), 0, 1e3)`` per image, and the loss stays differentiable through
    the power iteration (third order through the GroupNorm rules)."""
    params, y, u = case()
    tr = _trainer(tmp_path, jacobian_loss_weight=0.5,
                  jacobian_loss_type=jtype)
    tr.power_iteration_steps = 2
    v0 = torch.rand(B, DIM, DIM, 3, generator=torch.Generator().manual_seed(1))
    with torch.enable_grad():
        loss, mse = tr.loss_fn(_t(y), SIGMA, _t(u), v0=v0)
        grads = torch.autograd.grad(loss, list(tr.model.parameters()))
    jn = td.jacobian_spectral_norm(tr.model, _t(y + SIGMA * u),
                                   torch.full((B,), SIGMA), v0=v0, steps=2)
    term = (jn.clamp_min(0.9) if jtype == "max"
            else torch.exp(jn - 1.1)).clamp(0.0, 1e3)
    with torch.no_grad():
        plain, _ = _trainer(tmp_path).loss_fn(_t(y), SIGMA, _t(u))
    want = float(plain + 0.5 * term.mean().detach())
    assert abs(float(loss.detach()) - want) <= 1e-5 * want
    assert all(torch.isfinite(g).all() for g in grads)


def test_adam_step_matches_jax_train_step(tmp_path):
    params, y, u = case()
    jtr = jd.GradientStepTrainer(JaxCfg({
        "dataset": "synthetic", "model": "gradient_step", "dim_image": DIM,
        "num_channels": 3, "lr": LR, "num_epoch": 1,
        "output_root": str(tmp_path / "jax")}), model=JaxUNet(**CFG))
    state = {"params": params, "opt_state": jtr.tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    new, jloss, jpsnr = jtr.train_step(state, y, SIGMA, KEY)
    new = jax.device_get(new)
    want_p = state_dict_from_flax(new["params"])
    want_mu = state_dict_from_flax(new["opt_state"][0].mu)

    tr = _trainer(tmp_path)
    st = tr.init_state()
    st.model.load_state_dict(state_dict_from_flax(params))
    loss, psnr = tr.train_step(st, _t(y), SIGMA, u=_t(u))
    assert st.step == 1 and int(new["step"]) == 1
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(psnr) - float(jpsnr)) <= 1e-4
    # JAX's largest gradient, read back from mu = (1 - b1) g
    floor = NOISE_FLOOR * max(float(v.abs().max())
                              for v in want_mu.values()) / 0.1
    missed = 0
    for n, p in st.model.named_parameters():
        g = st.optimizer.state[p]["exp_avg"] / 0.1
        jg = want_mu[n] / 0.1
        off = (p.detach() - want_p[n]).abs() > 1e-5
        missed += int(off.sum())
        if off.any():
            assert float(g[off].abs().max()) < floor, n
            assert float(jg[off].abs().max()) < floor, n
    print(f"{missed} elements differ by more than 1e-5 after the step, all "
          "where both gradients are noise")


def test_lr_milestones_follow_optax():
    for milestone in (1, 3):
        sched = optax.piecewise_constant_schedule(
            LR, {m * milestone: 0.5 for m in (300, 600, 900, 1200)})
        for count in sorted({c + d for c in (0, 300, 600, 900, 1200)
                             for d in (-1, 0, 1)} | {1500}):
            count *= milestone
            if count < 0:
                continue
            want = float(sched(count))
            got = td.milestone_lr(LR, milestone, count)
            assert abs(got - want) <= 1e-7 * want, (milestone, count)
    assert td.milestone_lr(LR, 0, 10 ** 6) == LR
