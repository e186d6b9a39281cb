"""The port's reflow module against JAX's on the same NCSN++ weights (the
tiny RF config) and the same draws: the t-schedules, every loss (LPIPS by
a stub and by the real network, whose gradient runs through the port's
plain convolutions), one train step and one online step, and the Euler
pairs.

Bounds: losses within 1e-5 relative; gradients within 1e-4 of each max
(float32 backward through the network's rounding); parameters after a
step within 1e-5 of max|p|, and the step's own change within 1e-4 of its
max; pairs within 1e-5 of max|x1|."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pnpflow_tpu.metrics.lpips import lpips_distance
from pnpflow_tpu.training import reflow as jreflow
from pnpflow_tpu_torch.metrics.lpips import LPIPS
from pnpflow_tpu_torch.training import reflow as treflow
from pnpflow_tpu_torch.training.flow_matching import TrainState
from pnpflow_tpu_torch.utils.jax_params import flax_from_ncsnpp_state_dict
from pnpflow_tpu_torch.utils.lpips_convert import synthetic_weights

import rf_tiny

SHAPE = (4, 8, 8, 3)
LR = 0.5


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
    return rf_tiny.models(seed=5)


def _pairs(seed):
    rng = np.random.default_rng(seed)
    z0 = rng.normal(size=SHAPE).astype(np.float32)
    x1 = np.tanh(rng.normal(size=SHAPE)).astype(np.float32)
    return z0, x1


def _t(x):
    return torch.from_numpy(np.array(x))


def test_t_schedules():
    g = torch.Generator().manual_seed(0)
    eps = treflow.EPS
    assert torch.equal(treflow.sample_reflow_t(5, "t0"),
                       torch.full((5,), eps))
    assert torch.equal(treflow.sample_reflow_t(5, "t1"), torch.ones(5))
    u = treflow.sample_reflow_t(4000, "uniform", generator=g)
    assert float(u.min()) >= eps and float(u.max()) <= 1.0
    assert abs(float(u.mean()) - (1 + eps) / 2) < 0.02
    k = treflow.sample_reflow_t(4000, 4, generator=g)
    grid = np.arange(4) * (1 - eps) / 4 + eps
    np.testing.assert_allclose(np.unique(k.numpy()), grid, rtol=1e-6)
    want = jreflow.sample_reflow_t(jax.random.PRNGKey(0), 3, "t0")
    np.testing.assert_array_equal(treflow.sample_reflow_t(3, "t0"), want)
    with pytest.raises(NotImplementedError):
        treflow.sample_reflow_t(2, "t2")


def _stub_j(a, b):
    return jnp.mean(jnp.abs(a - b), axis=(1, 2, 3))


def _stub_t(a, b):
    return (a - b).abs().mean(dim=(1, 2, 3))


@pytest.mark.parametrize("loss_type,reduce_mean,schedule", [
    ("l2", True, "uniform"), ("l2", False, 3), ("lpips", True, "t0"),
    ("lpips+l2", True, "t0")])
def test_loss_values_match_jax(pair, loss_type, reduce_mean, schedule):
    _, _, apply, params, rf = pair
    z0, x1 = _pairs(1)
    t = np.asarray(jreflow.sample_reflow_t(jax.random.PRNGKey(2), 4,
                                           schedule))
    want = jreflow.make_reflow_loss(apply, schedule, loss_type, _stub_j,
                                    reduce_mean)(params, z0, x1, t)
    with torch.no_grad():
        got = treflow.make_reflow_loss(rf, schedule, loss_type, _stub_t,
                                       reduce_mean)(_t(z0), _t(x1), _t(t))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_loss_arguments_are_checked(pair):
    rf = pair[4]
    with pytest.raises(ValueError, match="lpips_fn"):
        treflow.make_reflow_loss(rf, "t0", "lpips")
    with pytest.raises(ValueError, match="t_schedule 't0'"):
        treflow.make_reflow_loss(rf, "uniform", "lpips", _stub_t)
    loss = treflow.make_reflow_loss(rf, "t0", "l1")
    with pytest.raises(NotImplementedError):
        loss(*(_t(a) for a in _pairs(0)), torch.full((4,), 0.5))


def _grads_close(got, want, tol=1e-4):
    """Each gradient within ``tol`` of its max.  A leaf whose gradient is
    below 1e-6 of the largest one is float32 noise (the attention key
    bias's is zero in exact arithmetic: softmax ignores a shift of every
    logit), and both packages' must then stay below that floor, the rule
    of ``chip_smoke.py``'s training parity."""
    floor = 1e-6 * max(float(np.abs(np.asarray(w)).max())
                       for w in want.values())
    for k, g in got.items():
        w = np.asarray(want[k])
        scale = float(np.abs(w).max())
        if scale < floor:
            assert float(np.abs(g).max()) < floor, k
            continue
        assert float(np.abs(g - w).max()) <= tol * scale, k


def test_lpips_loss_gradient_matches_jax():
    """The real LPIPS network (seeded synthetic weights) at 32x32: the loss
    and every model gradient, the port's ``LPIPS.distances`` against JAX's
    ``lpips_distance`` per image."""
    jc, tc, apply, params, rf = rf_tiny.models(
        seed=6, extra=["data.image_size", "32", "model.ch_mult", "(1, 2)"])
    w = synthetic_weights(0)
    rng = np.random.default_rng(3)
    z0 = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x1 = np.tanh(rng.normal(size=(2, 32, 32, 3))).astype(np.float32)
    t = np.full((2,), jreflow.EPS, np.float32)
    jl = jax.vmap(lambda a, b: lpips_distance(w, a[None], b[None]))
    jloss = jreflow.make_reflow_loss(apply, "t0", "lpips+l2", jl)
    want, wgrad = jax.jit(jax.value_and_grad(jloss))(params, z0, x1, t)
    tloss = treflow.make_reflow_loss(rf, "t0", "lpips+l2",
                                     LPIPS(w).distances)
    loss = tloss(_t(z0), _t(x1), _t(t))
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    got = {k: p.grad for k, p in rf.model.named_parameters()
           if p.grad is not None}
    got = flax_from_ncsnpp_state_dict(got)["params"]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(wgrad["params"])[0])
    _grads_close(flat_got, flat_want)


def _jax_state(params, tx):
    return {"params": params, "opt_state": tx.init(params), "ema": params,
            "step": jnp.int32(0)}


def _torch_state(rf):
    opt = torch.optim.SGD([p for p in rf.parameters() if p.requires_grad],
                          lr=LR)
    ema = {n: p.detach().clone() for n, p in rf.named_parameters()}
    return TrainState(rf, opt, ema, 0)


def _check_step(before, jstate, rf):
    after = flax_from_ncsnpp_state_dict(rf.model.state_dict())["params"]
    want = jax.device_get(jstate["params"]["params"])
    leaves = jax.tree_util.tree_leaves
    delta_w = [np.asarray(a) - np.asarray(b) for a, b in
               zip(leaves(want), leaves(before))]
    delta_g = [a - np.asarray(b) for a, b in zip(leaves(after),
                                                  leaves(before))]
    moved = max(float(np.abs(d).max()) for d in delta_w)
    assert moved > 1e-3
    ulp = np.finfo(np.float32).eps
    for a, b, dw, dg in zip(leaves(after), leaves(want), delta_w, delta_g):
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) <= 1e-5 * scale
        # a change read off two float32 parameters resolves no finer than
        # their ulp
        assert float(np.abs(dg - dw).max()) <= max(
            1e-4 * float(np.abs(dw).max()), 4 * ulp * scale)


def test_train_step_matches_jax(pair):
    _, _, apply, params, _ = pair
    _, _, _, _, rf = rf_tiny.models(seed=5)
    tx = optax.sgd(LR)
    z0, x1 = _pairs(7)
    key = jax.random.PRNGKey(8)
    t = np.asarray(jreflow.sample_reflow_t(key, 4, "uniform"))
    step = jreflow.make_reflow_train_step(apply, tx, t_schedule="uniform",
                                          ema_decay=0.9)
    jstate, jloss = jax.jit(step)(_jax_state(params, tx), z0, x1, key)
    state = _torch_state(rf)
    loss = treflow.make_reflow_train_step(
        rf, t_schedule="uniform", ema_decay=0.9)(state, _t(z0), _t(x1),
                                                  t=_t(t))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert state.step == 1
    _check_step(params["params"], jstate, rf)
    jema = jax.device_get(jstate["ema"]["params"])
    tema = flax_from_ncsnpp_state_dict(
        {k[len("model."):]: v for k, v in state.ema.items()})["params"]
    for a, b in zip(jax.tree_util.tree_leaves(tema),
                    jax.tree_util.tree_leaves(jema)):
        assert float(np.abs(a - b).max()) <= 1e-5 * max(
            float(np.abs(b).max()), 1e-6)


def test_online_step_matches_jax(pair):
    _, _, apply, params, _ = pair
    _, _, _, _, rf = rf_tiny.models(seed=5)
    tx = optax.sgd(LR)
    key = jax.random.PRNGKey(9)
    k_gen, k_t = jax.random.split(key)
    z0 = np.asarray(jax.random.normal(k_gen, SHAPE))
    t = np.asarray(jreflow.sample_reflow_t(k_t, 4, "uniform"))
    step = jreflow.make_online_reflow_step(
        apply, tx, t_schedule="uniform", gen_steps=3, ema_decay=0.9)
    jstate, jloss = jax.jit(functools.partial(step, shape=SHAPE))(
        _jax_state(params, tx), key=key)
    state = _torch_state(rf)
    loss = treflow.make_online_reflow_step(
        rf, t_schedule="uniform", gen_steps=3, ema_decay=0.9)(
            state, SHAPE, z0=_t(z0), t=_t(t))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _check_step(params["params"], jstate, rf)


@pytest.mark.parametrize("sampler", ["euler", "midpoint"])
def test_pairs_match_jax(pair, sampler):
    _, _, apply, params, rf = pair
    key = jax.random.PRNGKey(10)
    z0, x1 = jreflow.generate_reflow_pairs(apply, params, key, SHAPE,
                                           sampler=sampler, steps=4,
                                           init_noise_scale=1.5)
    gz, gx = treflow.generate_reflow_pairs(rf, SHAPE, sampler=sampler,
                                           steps=4, z0=_t(z0))
    assert torch.equal(gz, _t(z0))
    rf_tiny.close(gx, x1, 1e-5)
    a, b = (treflow.generate_reflow_pairs(
        rf, SHAPE, steps=2, init_noise_scale=1.5,
        generator=torch.Generator().manual_seed(0)) for _ in range(2))
    assert torch.equal(a[1], b[1]) and a[0].std() > 1.2
