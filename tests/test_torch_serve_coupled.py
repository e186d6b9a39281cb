"""Sharded serving of the restorations that couple a batch's images
(``pnpflow_tpu_torch/serve.py``): one solver on the first device, its
network fanned out over the devices (``parallel/mesh.py:ShardedModel``).
This file holds the wrapper and d_flow; ``tests/test_torch_serve_coupled_
ot_ode_pnp_gs.py`` the other two.

The wrapper, two shards on ``["cpu", "cpu"]`` of a small U-Net with
``fused_norm True``: its forward, its VJP with respect to x and its JVP
(``torch.func.jvp`` and forward AD) against the whole-batch model within
1e-6 of max (whether they are bit-equal is printed); the same with
``remat`` True against False, where each shard's replica runs again in the
backward and ``ModelBundle.grad_forward`` adds no second checkpoint; no
thread; what it refuses.

The restorations run at the flagship widths from one msgpack checkpoint
of random weights at a real scale (the seeded init outputs about 3e-5),
``Restorer(shard=True, devices=["cpu", "cpu"])`` against the unsharded
``Restorer``.  d_flow on denoising at 16² (one midpoint step, ``max_iter 1``):
its final objective within rel 1e-5 and its output within 1e-4 of max.  It
runs one LBFGS iteration: from the second on, torch's LBFGS turns the
float rounding of its input into other steps (at two iterations a change
of 1e-7 relative in the measurement moves the unsharded restore by 2.7e-3
of max at these sizes, ``scripts/torch_d_flow_spread.py``), and a shard's
network rounds otherwise than the whole batch's (the time-embedding GEMM
at 2 images instead of 4).  d_flow against JAX:
``tests/test_torch_serve_coupled_d_flow_jax.py``.
"""

import copy
import threading
import warnings

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from flax import serialization

from pnpflow_tpu.serve import Restorer as JaxRestorer
from pnpflow_tpu_torch.models.registry import (
    checkpoint_paths, model_fingerprint, save_params_file)
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.parallel.mesh import ShardedModel
from pnpflow_tpu_torch.serve import Restorer
from pnpflow_tpu_torch.solvers import d_flow
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.utils.jax_params import flax_from_state_dict

B = 4
SMALL = dict(input_channels=3, input_height=16, ch=32, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(8,), fused_norm=True)
CASES = {
    "d_flow": dict(method="d_flow", problem="denoising", dim_image=16,
                   overrides={"max_iter": 1, "LBFGS_iter": 1,
                              "steps_euler": 2}),
    "ot_ode": dict(method="ot_ode", problem="superresolution_bicubic",
                   dim_image=32, overrides={"steps_ode": 5,
                                            "start_time": 0.6}),
    "pnp_gs": dict(method="pnp_gs", problem="gaussian_deblurring_FFT",
                   model="gradient_step", dim_image=64,
                   overrides={"algo": "hqs", "max_iter": 1}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the wrapper


def _small_unet(seed=3):
    m = init_weights(VelocityUNet(**SMALL), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return m.eval().requires_grad_(False)


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 16, 16, 3, generator=g), torch.rand(B, generator=g),
            torch.randn(B, 16, 16, 3, generator=g))


def _apply(kind, fn, x, t, v):
    """``fn``'s forward, VJP (cotangent v) or JVP (tangent v) at x."""
    if kind == "forward":
        with torch.no_grad():
            return fn(x, t)
    if kind == "vjp":
        xg = x.clone().requires_grad_()
        return torch.autograd.grad(fn(xg, t), xg, v)[0]
    if kind == "func_jvp":
        return torch.func.jvp(lambda z: fn(z, t), (x,), (v,))[1]
    with fwAD.dual_level():
        return fwAD.unpack_dual(fn(fwAD.make_dual(x, v), t)).tangent


KINDS = ["forward", "vjp", "func_jvp", "forward_ad"]


@pytest.mark.parametrize("kind", KINDS)
def test_two_shards_equal_the_whole_batch(kind):
    m = _small_unet()
    w = ShardedModel([m, copy.deepcopy(m)], ["cpu", "cpu"])
    x, t, v = _inputs()
    want = _apply(kind, m, x, t, v)
    got = _apply(kind, w, x, t, v)
    print(f"{kind}: bit-equal {torch.equal(got, want)}")
    assert float(want.abs().max()) > 0.1
    assert _rel(got, want) <= 1e-6
    # a scalar t goes to every shard whole
    if kind == "forward":
        with torch.no_grad():
            assert _rel(w(x, t[:1]), m(x, t[:1])) <= 1e-6


@pytest.mark.parametrize("kind", KINDS)
def test_remat_checkpoints_each_shard(kind):
    m = _small_unet()
    reps = [m, copy.deepcopy(m)]
    runs = [0, 0]
    for k, r in enumerate(reps):
        r.register_forward_pre_hook(
            lambda mod, inp, k=k: runs.__setitem__(k, runs[k] + 1))
    x, t, v = _inputs(1)
    want = _apply(kind, ShardedModel(reps, ["cpu", "cpu"]), x, t, v)
    runs[:] = [0, 0]
    w = ShardedModel(reps, ["cpu", "cpu"], remat=True)
    got = _apply(kind, w, x, t, v)
    assert _rel(got, want) <= 1e-6
    # the backward recomputes each shard's forward
    assert runs == ([2, 2] if kind == "vjp" else [1, 1])


def test_grad_forward_does_not_checkpoint_the_wrapper_again():
    m = _small_unet()
    reps = [m, copy.deepcopy(m)]
    runs = []
    for r in reps:
        r.register_forward_pre_hook(lambda mod, inp: runs.append(1))
    bundle = ModelBundle(model=ShardedModel(reps, ["cpu", "cpu"], True),
                         remat=True)
    x, t, v = _inputs(2)
    xg = x.clone().requires_grad_()
    torch.autograd.grad(bundle.grad_forward(xg, t), xg, v)
    assert len(runs) == 4 and bundle.model.forwards == 1


def test_the_wrapper_starts_no_thread(monkeypatch):
    def refuse(self):
        raise AssertionError("a thread was started")

    monkeypatch.setattr(threading.Thread, "start", refuse)
    m = _small_unet()
    w = ShardedModel([m, copy.deepcopy(m)], ["cpu", "cpu"], remat=True)
    x, t, v = _inputs(3)
    for kind in KINDS:
        _apply(kind, w, x, t, v)
    assert w.forwards == len(KINDS)


def test_the_wrapper_refuses_what_it_cannot_shard():
    m = _small_unet()
    with pytest.raises(ValueError, match="not on cpu"):
        ShardedModel([m, copy.deepcopy(m).to("meta")], ["cpu", "cpu"])
    with pytest.raises(ValueError, match="2 replicas for 3 devices"):
        ShardedModel([m, m], ["cpu"] * 3)
    w = ShardedModel([m, copy.deepcopy(m)], ["cpu", "cpu"])
    x, t, _ = _inputs()
    with pytest.raises(ValueError, match="does not divide"), \
            torch.no_grad():
        w(x[:3], t[:3])


# ---------------------------------------------------------------------------
# the restorations


def _real_scale(module, seed=0):
    """Every parameter drawn at a real scale, in place (fan-in scaled
    weights, GroupNorm scales near 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1 and "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.5 * torch.randn(p.shape, generator=g)
                        / p[0].numel() ** 0.5)


class Case:
    """The unsharded and the sharded port ``Restorer`` of one restoration
    and, with ``with_jax``, JAX's sharded one, all from one checkpoint that
    the first writes under the output root; ``y`` a measured batch."""

    def __init__(self, name, root, with_jax=False):
        kw = dict(CASES[name], batch_size=B, output_root=str(root))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the random-init warning
            self.plain = Restorer(**kw, device="cpu")
        model, args = self.plain.bundle.model, self.plain.args
        _real_scale(model)
        save_params_file(flax_from_state_dict(model.state_dict()),
                         checkpoint_paths(args)["msgpack"],
                         fingerprint=model_fingerprint(model, args))
        self.sharded = Restorer(**kw, device="cpu", shard=True,
                                devices=["cpu", "cpu"])
        self.jax = None
        if with_jax:
            # JAX's Restorer takes the checkpoint as flax's msgpack reader
            # gives it: its own resolution would first trace an init of the
            # flagship op by op, tens of seconds on this CPU
            with open(checkpoint_paths(args)["msgpack"], "rb") as f:
                params = serialization.msgpack_restore(f.read())["params"]
            self.jax = JaxRestorer(**kw, params=params, shard=True,
                                   n_devices=2)
        dim = CASES[name]["dim_image"]
        clean = np.tanh(np.random.default_rng(1).normal(
            size=(B, dim, dim, 3))).astype(np.float32)
        self.y = self.plain.degrade(clean, seed=2).numpy()


def sharded_equals_unsharded(case):
    """The sharded restore and the unsharded one, the latter non-trivial
    (away from the adjoint of y)."""
    want = case.plain.restore(case.y, seed=3)
    got = case.sharded.restore(case.y, seed=3)
    start = case.plain.home_degradation.H_adj(torch.from_numpy(case.y))
    assert np.abs(want - start.numpy()).max() > 0.01
    assert np.isfinite(got).all()
    return got, want


@pytest.fixture(scope="module")
def d_flow_case(tmp_path_factory):
    return Case("d_flow", tmp_path_factory.mktemp("d_flow"))


def test_sharding_builds_one_solver_on_the_first_device(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = Restorer(**CASES["d_flow"], batch_size=2, device="cpu",
                     output_root=str(tmp_path), shard=True,
                     devices=["cpu", "cpu"])
    w = r.solver.model.model
    assert r.shards is None and isinstance(w, ShardedModel)
    assert w.replicas[0] is r.bundle.model and len(w.replicas) == 2
    assert r.home_degradation is not r.degradation
    with pytest.raises(ValueError, match="does not divide"):
        r.restore(np.zeros((3, 16, 16, 3), np.float32))


def test_sharded_d_flow_equals_unsharded(d_flow_case, monkeypatch):
    objectives = []

    def lbfgs_solve(loss_fn, z, **kw):
        z = solve(loss_fn, z, **kw)
        objectives.append(float(loss_fn(z)))
        return z

    solve = d_flow.lbfgs_solve
    monkeypatch.setattr(d_flow, "lbfgs_solve", lbfgs_solve)
    got, want = sharded_equals_unsharded(d_flow_case)
    assert d_flow_case.sharded.solver.model.model.forwards > 0
    plain, sharded = objectives
    print(f"d_flow objective: unsharded {plain:.9g}, sharded {sharded:.9g}")
    assert abs(sharded - plain) <= 1e-5 * abs(plain)
    assert _rel(got, want) <= 1e-4
