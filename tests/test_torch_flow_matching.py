"""The port's flow-matching loss, train steps and samplers
(``pnpflow_tpu_torch/training/flow_matching.py``) against the JAX package's
(``pnpflow_tpu/training/flow_matching.py``) on the same parameters (carried
across with ``state_dict_from_flax``), pairs, times and noise.

The model is the JAX trainer tests' ``tiny`` U-Net (16x16, 1 channel, ch 32,
mult (1, 2), one block, attention at 8) with every parameter drawn at a real
scale, so that each carries a gradient.  JAX's ``fused_norm True`` runs its
plain GroupNorm with its custom VJP on the CPU, as its own tests do.

Bounds:
- loss within rel 1e-5 (float32 sums in another order);
- each gradient tensor within 1e-4 of that tensor's max|g|;
- one Adam (lr 1e-4) + EMA (0.999) step: params and EMA within 1e-5
  max-abs, Adam's mu / nu within rel 1e-4 of each tensor's max;
- Euler sampling over 10 steps from the same noise within 1e-4.

Fifteen tensors of this U-Net have a gradient that is zero in exact
arithmetic (:data:`ZERO_GRAD`): each attention's key bias (softmax does not
change when one value is added to a whole row of logits) and the biases
whose output meets a GroupNorm of one channel a group (32 channels in 32
groups) before anything else.  Both packages give them float32 rounding
noise, below 1e-6 of the largest gradient, and Adam's first step, which
divides each gradient by its own size, turns that noise into steps of up to
lr in either direction.  The tests hold those tensors to being noise in
both packages, and show each element whose step differs by more than the
bound: its two gradients, both noise, and whether its sign flipped.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.training import flow_matching as jfm
from pnpflow_tpu.utils.torch_convert import convert_unet_state_dict
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.training import flow_matching as fm
from pnpflow_tpu_torch.utils.jax_params import (
    flax_adam_state, flax_from_state_dict, state_dict_from_flax)

DIM, B = 16, 4
TINY = dict(input_channels=1, input_height=DIM, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,))
NOISE_FLOOR = 1e-6      # of the largest gradient: rounding noise below it
STEP_KEY = jax.random.PRNGKey(5)
ZERO_GRAD = sorted(
    [f"{m}.attn_k.bias" for m in (
        "down_modules.1.1a_0b_attn", "mid_modules.1",
        "up_modules.0.1a_0b_attn", "up_modules.0.1a_1b_attn")]
    + [f"{b}.{leaf}" for b in (
        "down_modules.0.0a_0a_block", "up_modules.1.0a_0a_block",
        "up_modules.1.0a_1a_block")
       for leaf in ("conv1.bias", "temb_proj.weight", "temb_proj.bias")]
    + ["up_modules.1.0a_1a_block.conv2.bias",
       "up_modules.1.0a_1a_block.shortcut.bias"])
_CACHE = {}


def _randomized(params, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif "bias" in name:
            v = 0.1 * rng.normal(size=leaf.shape)
        else:
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _case():
    if "case" not in _CACHE:
        rng = np.random.default_rng(0)
        x0 = rng.standard_normal((B, DIM, DIM, 1)).astype(np.float32)
        x1 = (0.5 * rng.standard_normal((B, DIM, DIM, 1))).astype(np.float32)
        # the t that JAX's precoupled step draws from STEP_KEY
        t = np.asarray(jax.random.uniform(STEP_KEY, (B,), jnp.float32))
        shapes = jax.eval_shape(JaxUNet(**TINY).init, jax.random.PRNGKey(0),
                                x0[:1], t[:1])
        _CACHE["case"] = (_randomized(shapes, 1), x0, x1, t)
    return _CACHE["case"]


def _jax_loss_and_grads(fused):
    key = ("grad", fused)
    if key not in _CACHE:
        params, x0, x1, t = _case()
        loss_fn = jfm.make_fm_loss(JaxUNet(**TINY, fused_norm=fused).apply)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, x0, x1, t)
        _CACHE[key] = (float(loss), state_dict_from_flax(grads))
    return _CACHE[key]


def _port_model(fused, params=None):
    m = VelocityUNet(**TINY, fused_norm=fused)
    m.load_state_dict(state_dict_from_flax(
        _case()[0] if params is None else params))
    return m


def _t(a):
    return torch.from_numpy(np.array(a))


def _noise_names(grads):
    gmax = max(float(g.abs().max()) for g in grads.values())
    return sorted(n for n, g in grads.items()
                  if float(g.abs().max()) < NOISE_FLOOR * gmax), gmax


@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_loss_matches_jax(fused, jax_fused):
    _, x0, x1, t = _case()
    want, _ = _jax_loss_and_grads(jax_fused)
    with torch.no_grad():
        got = fm.make_fm_loss(_port_model(fused))(_t(x0), _t(x1), _t(t))
    assert abs(float(got) - want) <= 1e-5 * abs(want), (float(got), want)


@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_gradients_match_jax(fused, jax_fused):
    _, x0, x1, t = _case()
    _, want = _jax_loss_and_grads(jax_fused)
    m = _port_model(fused)
    fm.make_fm_loss(m)(_t(x0), _t(x1), _t(t)).backward()
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want)
    noise, gmax = _noise_names(want)
    assert noise == ZERO_GRAD
    for n, g in got.items():
        if n in ZERO_GRAD:
            # zero in exact arithmetic: rounding noise in both packages
            assert float(g.abs().max()) < NOISE_FLOOR * gmax, n
            continue
        scale = float(want[n].abs().max())
        err = float((g - want[n]).abs().max())
        assert err <= 1e-4 * scale, (n, err, scale)


def _jax_step():
    if "step" not in _CACHE:
        params, x0, x1, _ = _case()
        tx = optax.adam(1e-4)
        state = {"params": params, "opt_state": tx.init(params),
                 "ema": jax.tree_util.tree_map(jnp.copy, params),
                 "step": jnp.zeros((), jnp.int32)}
        step = jax.jit(jfm.make_fm_train_step_precoupled(
            JaxUNet(**TINY).apply, tx, ema_decay=0.999))
        new, loss = step(state, x0, x1, STEP_KEY)
        _CACHE["step"] = (jax.device_get(new), float(loss))
    return _CACHE["step"]


def _check_step(m, state, new):
    """Hold the port's state after one step to JAX's: params and EMA within
    1e-5, Adam's moments within rel 1e-4 of each tensor's max, the step
    counts at 1.

    An element may miss the 1e-5 bound only where both packages' gradients
    are rounding noise (below 1e-6 of the largest gradient): Adam's first
    step is about lr times the gradient's sign, and noise has no sign.  The
    gradients are read back from mu = (1 - b1) g.  Each such element is
    printed with its two gradients."""
    want_p = state_dict_from_flax(new["params"])
    want_e = state_dict_from_flax(new["ema"])
    adam = new["opt_state"][0]
    assert int(adam.count) == 1 and state.step == 1
    want_mu, want_nu = (state_dict_from_flax(adam.mu),
                        state_dict_from_flax(adam.nu))
    floor = NOISE_FLOOR * 10.0 * max(float(v.abs().max())
                                     for v in want_mu.values())
    shown = []
    for n, p in m.named_parameters():
        st = state.optimizer.state[p]
        assert int(st["step"]) == 1
        g, jg = st["exp_avg"] / 0.1, want_mu[n] / 0.1
        for i in torch.nonzero((p.detach() - want_p[n]).abs() > 1e-5):
            i = tuple(i.tolist())
            shown.append((n, i, float(p.detach()[i]), float(want_p[n][i]),
                          float(g[i]), float(jg[i])))
        if n in ZERO_GRAD:
            assert float(g.abs().max()) < floor, n
        else:
            for got_m, want_m in ((st["exp_avg"], want_mu[n]),
                                  (st["exp_avg_sq"], want_nu[n])):
                scale = float(want_m.abs().max())
                assert float((got_m - want_m).abs().max()) <= 1e-4 * scale, n
        err = float((state.ema[n] - want_e[n]).abs().max())
        assert err <= 1e-5, (n, err)
    print(f"{len(shown)} elements differ by more than 1e-5 after the step, "
          f"{sum(np.sign(s[4]) != np.sign(s[5]) for s in shown)} of them "
          "with a flipped sign; outside the zero-gradient tensors:")
    for s in shown:
        if s[0] not in ZERO_GRAD:
            print("  {} {}: port {:.6g}, JAX {:.6g}; gradients {:.3g} / "
                  "{:.3g}".format(*s))
    for s in shown:
        assert max(abs(s[4]), abs(s[5])) < floor, s


@pytest.mark.parametrize("fused", [False, True])
def test_precoupled_step_matches_jax(fused):
    """One Adam + EMA step of the port (``fused_norm`` False and the
    trainer's True) against JAX's precoupled step on the JAX trainer's
    model (``fused_norm`` False), with the t that JAX drew injected."""
    _, x0, x1, t = _case()
    new, jloss = _jax_step()
    m = _port_model(fused)
    state = fm.new_state(m, 1e-4)
    step = fm.make_fm_train_step_precoupled(ema_decay=0.999)
    loss = step(state, _t(x0), _t(x1), t=_t(t))
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    _check_step(m, state, new)


def test_adam_state_maps_to_optax():
    """After the same step, the port's Adam state in optax's layout has
    JAX's ``ScaleByAdamState`` tree, leaf for leaf (the same transposes as
    the params), and its values within the step test's bounds."""
    _, x0, x1, t = _case()
    new, _ = _jax_step()
    _, jgrads = _jax_loss_and_grads(False)
    _, gmax = _noise_names(jgrads)
    m = _port_model(False)
    state = fm.new_state(m, 1e-4)
    names = [n for n, _ in m.named_parameters()]
    before = flax_adam_state(state.optimizer, names)
    assert int(before["0"]["count"]) == 0 and before["1"] == {}
    fm.make_fm_train_step_precoupled()(state, _t(x0), _t(x1), t=_t(t))
    tree = flax_adam_state(state.optimizer, names)
    assert tree["0"]["count"].dtype == np.int32
    assert tree["0"]["count"].shape == () and int(tree["0"]["count"]) == 1
    jadam = new["opt_state"][0]
    for key, floor in (("mu", 0.1 * NOISE_FLOOR * gmax),
                       ("nu", 1e-3 * (NOISE_FLOOR * gmax) ** 2)):
        want = getattr(jadam, key)
        assert (jax.tree_util.tree_structure(tree["0"][key])
                == jax.tree_util.tree_structure(jax.device_get(want)))
        got_sd, want_sd = (state_dict_from_flax(tree["0"][key]),
                           state_dict_from_flax(want))
        for n, w in want_sd.items():
            g = got_sd[n]
            if n in ZERO_GRAD:
                assert float(g.abs().max()) < floor, (key, n)
                continue
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-4 * scale, (key, n)


def test_indep_step_with_coupling_inside_matches_jax():
    """The coupling-inside entry with ``indep``: x0 and t as JAX's step draws
    them from its key, injected into the port."""
    params, _, x1, _ = _case()
    tx = optax.adam(1e-4)
    state = {"params": params, "opt_state": tx.init(params),
             "ema": jax.tree_util.tree_map(jnp.copy, params),
             "step": jnp.zeros((), jnp.int32)}
    key = jax.random.PRNGKey(11)
    step = jax.jit(jfm.make_fm_train_step(JaxUNet(**TINY).apply, tx,
                                          coupling="indep"))
    new, jloss = step(state, x1, key)
    k_noise, k_t, _ = jax.random.split(key, 3)
    x0 = np.asarray(jax.random.normal(k_noise, x1.shape, jnp.float32))
    t = np.asarray(jax.random.uniform(k_t, (B,), jnp.float32))
    m = _port_model(False)
    pstate = fm.new_state(m, 1e-4)
    loss = fm.make_fm_train_step(coupling="indep")(
        pstate, _t(x1), torch.Generator(), x0=_t(x0), t=_t(t))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _check_step(m, pstate, jax.device_get(new))


@pytest.mark.parametrize("method", ["exact", "sinkhorn"])
def test_ot_step_with_coupling_inside_runs(method):
    _, _, x1, _ = _case()
    m = _port_model(True)
    state = fm.new_state(m, 1e-4)
    step = fm.make_fm_train_step(coupling="ot", ot_method=method)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(state, _t(x1), gen)) for _ in range(2)]
    assert state.step == 2 and np.isfinite(losses).all()
    assert int(state.optimizer.state[m.begin_conv.weight]["step"]) == 2


def test_remat_gives_the_same_loss_and_gradients():
    _, x0, x1, t = _case()
    grads = []
    for remat in (False, True):
        m = _port_model(True)
        loss = fm.make_fm_loss(m, remat=remat)(_t(x0), _t(x1), _t(t))
        loss.backward()
        grads.append((float(loss), {n: p.grad for n, p in
                                    m.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for n, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][n], g, rtol=0, atol=0)


def test_euler_sample_matches_jax():
    params = _case()[0]
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(
        lambda p, k: jfm.euler_sample(JaxUNet(**TINY).apply, p, k,
                                      (2, DIM, DIM, 1), steps=10))(params,
                                                                   key))
    noise = np.asarray(jax.random.normal(key, (2, DIM, DIM, 1)))
    got = fm.euler_sample(_port_model(True), (2, DIM, DIM, 1), steps=10,
                          noise=noise).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sigma_var", [0.0, 0.5])
def test_stochastic_euler_matches_jax(sigma_var):
    """The same start and step noise as JAX's draws from its key."""
    params = _case()[0]
    key, shape, steps = jax.random.PRNGKey(9), (2, DIM, DIM, 1), 6
    want = np.asarray(jfm.euler_sample_stochastic(
        JaxUNet(**TINY).apply, params, key, shape, steps=steps,
        sigma_var=sigma_var, noise_scale=0.8))
    k0, k = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k0, shape))
    step_noise = []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        step_noise.append(np.asarray(jax.random.normal(sub, shape)))
    got = fm.euler_sample_stochastic(
        _port_model(False), shape, steps=steps, sigma_var=sigma_var,
        noise_scale=0.8, noise=noise, step_noise=step_noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_flax_from_state_dict_equals_the_jax_converter():
    m = _port_model(False)
    got = flax_from_state_dict(m.state_dict())
    want = convert_unet_state_dict(
        {k: v.numpy() for k, v in m.state_dict().items()}, 2)
    flat_g = {str(k): v for k, v in jax.tree_util.tree_leaves_with_path(got)}
    flat_w = {str(k): v for k, v in jax.tree_util.tree_leaves_with_path(want)}
    assert set(flat_g) == set(flat_w)
    for k, v in flat_w.items():
        assert flat_g[k].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(flat_g[k], v)
    with pytest.raises(KeyError, match="unrecognized"):
        flax_from_state_dict({"down_modules.0.conv9.weight": torch.zeros(1)})
