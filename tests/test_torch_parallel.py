"""Data parallelism in the port (``pnpflow_tpu_torch/parallel/mesh.py``):
the trainers' steps on two ranks of a gloo process group against the
one-process step on the whole batch and JAX's single-device step, and the
inference fan-out (sharded ``Restorer``, the Inception chunker, the metric
sampler) against the unsharded runs.

Two ranks: ``tests/torch_dp_worker.py`` runs once per rank in its own
process (120 s timeout each), one step of the flow-matching trainer on
precoupled (exact-OT) pairs, one that couples by Sinkhorn inside the step,
and one of the gradient-step trainer, from the same parameters on a global
batch of 8 (4 a rank).  Bounds, those of ``tests/test_torch_flow_matching.
py``: the loss within rel 1e-5; each gradient tensor (read back from Adam's
first moment, 0.1 g after the first step) within 1e-4 of its max; the
parameters after one Adam step (lr 1e-4) within 1e-5, but where both
gradients are rounding noise (below 1e-6 of the largest), which Adam's
first step turns into steps of up to lr either way.  The two ranks end with
equal parameters, bit for bit.

Fan-out over ``["cpu", "cpu"]``: the sharded restoration and the sampler
draw the whole batch's noise and keep their rows, so they equal the
unsharded run bit for bit; the Inception features, computed at other batch
sizes, within 1e-6 of their max.
"""

import functools
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.training import denoiser as jd
from pnpflow_tpu.training import flow_matching as jfm
from pnpflow_tpu_torch.metrics.generative import ComputeMetric
from pnpflow_tpu_torch.models.inception import get_inception_fns
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.ops.ot import ot_pair_indices
from pnpflow_tpu_torch.parallel import mesh
from pnpflow_tpu_torch.serve import Restorer
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.utils import inception_convert
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import (
    flax_from_state_dict, state_dict_from_flax)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_dp_worker as worker  # noqa: E402

GLOBAL_B = 8
NOISE_FLOOR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def spec() -> dict:
    """Parameters at a real scale and the global batch's data and draws,
    from numpy seeds."""
    rng = np.random.default_rng(0)
    m = init_weights(VelocityUNet(**worker.TINY), 0)
    out = {}
    for n, p in m.named_parameters():
        if n.endswith("weight") and p.dim() > 1:
            fan_in = p[0].numel()
            v = rng.normal(size=p.shape) / np.sqrt(fan_in)
        elif "norm" in n and n.endswith("weight"):
            v = 1.0 + 0.2 * rng.normal(size=p.shape)
        else:
            v = 0.1 * rng.normal(size=p.shape)
        out["p/" + n] = v.astype(np.float32)
    shape = (GLOBAL_B, 16, 16, 1)
    out["x0"] = rng.standard_normal(shape).astype(np.float32)
    out["x1"] = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    out["t"] = rng.uniform(size=(GLOBAL_B,)).astype(np.float32)
    out["u"] = rng.standard_normal(shape).astype(np.float32)
    out["seed"] = np.int64(7)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each rank's results of :func:`torch_dp_worker.run_steps`."""
    d = tmp_path_factory.mktemp("dp")
    np.savez(d / "spec.npz", **spec())
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_worker.py"),
         str(d / "spec.npz"), str(d / "out")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(d / f"out.{r}.npz")) for r in range(2)]


@functools.lru_cache(maxsize=None)
def one_process() -> dict:
    import tempfile

    assert not mesh.is_distributed()
    with tempfile.TemporaryDirectory() as d:
        return worker.run_steps(spec(), d)


def _jax_params():
    return flax_from_state_dict({k[2:]: torch.from_numpy(v)
                                 for k, v in spec().items()
                                 if k.startswith("p/")})


@functools.lru_cache(maxsize=None)
def jax_step(name) -> dict:
    """JAX's single-device step on the same pairs and draws: the loss, the
    gradients and the parameters after optax's Adam."""
    s = spec()
    params = _jax_params()
    apply = JaxUNet(**worker.TINY, fused_norm=True).apply
    x0, x1, t = s["x0"], s["x1"], s["t"]
    if name == "gs":
        forward = jd.make_denoiser_forward(apply)

        def loss_fn(p):
            x_hat, _ = forward(p, x1 + worker.SIGMA * s["u"],
                               jnp.full((GLOBAL_B,), worker.SIGMA))
            return jnp.mean(jnp.mean(
                (x_hat - x1).reshape(GLOBAL_B, -1) ** 2, axis=1))
    else:
        if name == "fm_sinkhorn":
            # the pairs the port's step draws from its generator
            i0, i1 = ot_pair_indices(
                torch.from_numpy(x0), torch.from_numpy(x1),
                torch.Generator().manual_seed(int(s["seed"])), "sinkhorn")
            x0, x1 = x0[i0.numpy()], x1[i1.numpy()]
        fm_loss = jfm.make_fm_loss(apply)

        def loss_fn(p):
            return fm_loss(p, x0, x1, t)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adam(worker.LR)
    upd, _ = tx.update(grads, tx.init(params))
    new = optax.apply_updates(params, upd)
    return {"loss": float(loss), "g": state_dict_from_flax(grads),
            "p": state_dict_from_flax(new)}


def _unpack(res, name):
    g = {k.split("/", 2)[2]: torch.from_numpy(v) / 0.1
         for k, v in res.items() if k.startswith(name + "/mu/")}
    p = {k.split("/", 2)[2]: torch.from_numpy(v)
         for k, v in res.items() if k.startswith(name + "/p/")}
    return {"loss": float(res[name + "/loss"]), "g": g, "p": p}


def _hold(got, want):
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert set(got["g"]) == set(want["g"]) == set(got["p"])
    floor = NOISE_FLOOR * max(float(v.abs().max())
                              for v in want["g"].values())
    for n, g in got["g"].items():
        w = want["g"][n]
        assert float((g - w).abs().max()) <= 1e-4 * float(
            w.abs().max()) + floor, n
        off = (got["p"][n] - want["p"][n]).abs() > 1e-5
        if off.any():
            assert float(g[off].abs().max()) < floor, n
            assert float(w[off].abs().max()) < floor, n
            assert float((got["p"][n] - want["p"][n]).abs().max()) \
                <= 2 * worker.LR, n


@pytest.mark.parametrize("name", worker.STEPS)
def test_two_ranks_equal_one_process_and_jax(two_ranks, name):
    r0, r1 = (_unpack(r, name) for r in two_ranks)
    # every rank takes the same step
    assert r0["loss"] == r1["loss"]
    for n in r0["p"]:
        assert torch.equal(r0["p"][n], r1["p"][n]), n
        assert torch.equal(r0["g"][n], r1["g"][n]), n
    one = _unpack(one_process(), name)
    _hold(r0, one)
    _hold(one, jax_step(name))


def test_process_batch_slice_and_indivisible_batch(monkeypatch):
    assert mesh.process_batch_slice(8) == (0, 8)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    assert mesh.process_batch_slice(8) == (4, 4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.process_batch_slice(7)
    # without a process group nothing is reduced
    monkeypatch.undo()
    t = torch.ones(3)
    assert mesh.all_reduce_sum(t) is t
    assert not mesh.init_distributed("cpu") or mesh.is_distributed()


def test_rank_device_names_the_local_rank_card(monkeypatch):
    """A bare ``cuda`` resolves to ``LOCAL_RANK``'s card under a process
    group and to the current card without one; an index or the CPU is
    kept (the CUDA calls are stood in for, so this runs without a card).
    Both trainers take their device from it (``tests/test_torch_gpu.py``
    holds them on the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.rank_device("cuda") == torch.device("cuda", 2)
    monkeypatch.setattr(mesh, "is_distributed", lambda: True)
    assert mesh.rank_device(None) == torch.device("cuda", 3)
    assert mesh.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mesh.rank_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# fan-out inside one process


@pytest.fixture(scope="module")
def restorers(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard")
    kw = dict(problem="random_inpainting", dim_image=16, num_channels=1,
              batch_size=4, overrides={"steps_pnp": 3, "num_samples": 2},
              device="cpu", output_root=str(root))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (Restorer(**kw),
                Restorer(**kw, shard=True, devices=["cpu", "cpu"]))


def test_sharded_restorer_equals_unsharded(restorers):
    plain, sharded = restorers
    assert len(sharded.shards) == 2
    # the per-image mask is cut into the shards' rows
    assert [d.mask.shape[0] for _, d in sharded.shards] == [2, 2]
    clean = np.tanh(np.random.default_rng(1).normal(size=(4, 16, 16, 1)))
    y = plain.degrade(clean.astype(np.float32), seed=2)
    want = plain.restore(y, seed=3)
    got = sharded.restore(y, seed=3)
    assert np.isfinite(want).all() and np.array_equal(got, want)


def test_sharding_refusals(restorers):
    _, sharded = restorers
    with pytest.raises(ValueError, match="does not divide"):
        sharded.restore(np.zeros((3, 16, 16, 1), np.float32))
    with pytest.raises(ValueError, match="n_devices 2: 1 cpu"):
        mesh.devices(2, "cpu")
    with pytest.raises(ValueError, match="need shard=True"):
        Restorer(device="cpu", n_devices=1)


@pytest.fixture(scope="module")
def inception_args(tmp_path_factory):
    root = tmp_path_factory.mktemp("incep")
    (root / "model").mkdir()
    inception_convert.main("--synthetic",
                           str(root / "model" / "inception_fid.npz"))
    return CfgNode({"output_root": str(root)})


def test_inception_chunker_fans_out(inception_args):
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(5, 32, 32, 3)).astype(np.float32))
    f1, o1 = get_inception_fns(inception_args, batch=3, device="cpu")
    want, want_p = o1(x)
    f2, o2 = get_inception_fns(inception_args, batch=3, device="cpu",
                               devices=["cpu", "cpu"])
    got, got_p = o2(x)
    assert got.shape == (5, 2048) and got_p.shape == (5, 1008)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert float((got_p - want_p).abs().max()) <= 1e-6
    assert torch.equal(f2(x), got)


def test_metric_sampler_fans_out(tmp_path):
    model = init_weights(VelocityUNet(**worker.TINY), 0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    args = CfgNode({"output_root": str(tmp_path), "dataset": "synthetic",
                    "model": "ot", "dim_image": 16, "num_channels": 1,
                    "eval_split": "test", "seed": 0})
    bundle = ModelBundle(model=model.eval(), device=torch.device("cpu"))
    one = ComputeMetric({}, bundle, args)
    two = ComputeMetric({}, bundle, args, devices=["cpu", "cpu"])
    assert one.devices == [torch.device("cpu")]
    x0 = torch.randn((5, 16, 16, 1), generator=torch.Generator()
                     .manual_seed(3))
    with torch.inference_mode():
        want = one._sample_batch(x0, 3, "euler")
        got = two._sample_batch(x0, 3, "euler")
    assert len(two._replicas) == 2 and torch.equal(got, want)
