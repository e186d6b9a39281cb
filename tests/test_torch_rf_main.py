"""The port's ``rf_main`` against JAX's ``rf_main`` at the tiny
sizes of ``tests/test_rf_main.py:_tiny_opts``, on the CPU: every mode and
its files, three train steps from one state on JAX's draws, the state
file read across the two packages, and the optimizer's clip against
optax's.

Bounds: parameters after three steps within 1e-5 of each leaf's max (the
first update is exactly zero under the warmup); each package's forward on
a state read from the other's file within 1e-6 of its forward on the
weights written (they are read bit for bit), and the two packages'
forwards within 1e-5 of max|out| (the zoo's bound); the clip and the Adam
steps within 1e-6 relative."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from pnpflow_tpu import rf_main as jrf
from pnpflow_tpu_torch import rf_main as trf
from pnpflow_tpu_torch.models.registry import read_msgpack

import rf_tiny

OPTS = ["--opts", "device", "cpu", *rf_tiny.TINY]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mode, wd, *extra, n_iters=None):
    argv = ["--config", "cifar10_rf_gaussian_ddpmpp", "--mode", mode,
            "--workdir", str(wd)]
    if n_iters is not None:
        argv += ["--n_iters", str(n_iters)]
    return trf.main(argv + OPTS + list(extra))


def test_every_mode_runs_and_writes_its_files(tmp_path, capsys):
    wd = tmp_path / "run"
    stats = _run("train", wd, n_iters=2)
    assert os.path.exists(wd / "state.msgpack")
    assert len(stats["losses"]) == 2 == len(stats["step_seconds"])
    out = capsys.readouterr().out
    assert out.count("loss") == 2 and "synthetic smoke data" in out
    stats = trf.main(["--config", "cifar10_rf_gaussian_ddpmpp", "--mode",
                      "sample", "--n_samples", "3", "--workdir", str(wd),
                      *OPTS])
    samples = np.load(wd / "samples.npz")["samples"]
    assert samples.shape == (3, 8, 8, 3) and np.isfinite(samples).all()
    assert stats["nfe"] == 5
    assert open(wd / "samples.png", "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert "restored" in capsys.readouterr().out
    _run("reflow", wd, "reflow.reflow_type", "train_reflow",
         "reflow.reflow_t_schedule", "uniform", "reflow.reflow_loss", "l2",
         n_iters=1)
    with pytest.warns(UserWarning, match="LPIPS"):
        _run("reflow", wd, "reflow.reflow_type", "train_online_reflow",
             "reflow.reflow_t_schedule", "t0", "reflow.reflow_loss",
             "lpips", n_iters=1)
    _run("generate_pairs", wd, "reflow.total_number_of_samples", "6")
    pairs = np.load(wd / "reflow_pairs.npz")
    assert pairs["z0"].shape == pairs["x1"].shape == (6, 8, 8, 3)
    with pytest.raises(KeyError):
        trf.main(["--config", "nope", "--mode", "sample"])
    with pytest.raises(NotImplementedError, match="NCSN"):
        _run("sample", wd, "model.name", "ddpm")


def _jax_draws(i, shape):
    key = jax.random.PRNGKey(i)
    z0 = jax.random.normal(jax.random.fold_in(key, 1), shape)
    t = jax.random.uniform(key, (shape[0],), jnp.float32)
    return np.asarray(z0), np.asarray(t)


def _leaves(path):
    tree, fp = read_msgpack(path)
    assert fp is None           # JAX's raw tree, no envelope
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _template(model, cfg, seed=0):
    """JAX's ``_init_params`` tree by shape alone: its ``_load_or_init``
    restores every leaf from the file over it (the eager flax init takes
    about 18 s here)."""
    d = cfg.data
    x = np.zeros((1, d.image_size, d.image_size, d.num_channels), np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(seed), x,
                                               jnp.zeros((1,))))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """One real-scale starting state, written by JAX; JAX's ``rf_main`` builds
    its restore template by shape."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jrf, "_init_params", _template)
    jc, _, _, params, _ = rf_tiny.models(seed=21)
    wd = tmp_path_factory.mktemp("start")
    jrf._save(params, str(wd))
    yield jc, str(wd / "state.msgpack"), params
    mp.undo()


def _from(start_path, wd):
    os.makedirs(wd)
    shutil.copy(start_path, os.path.join(wd, "state.msgpack"))
    return str(wd)


def test_train_steps_match_jax_and_the_first_update_is_zero(start, tmp_path):
    jc, path, _ = start
    jwd, twd = _from(path, tmp_path / "j"), _from(path, tmp_path / "t")
    jrf.mode_train(jc, jwd, 3)
    _, tc = rf_tiny.configs()
    stats = trf.mode_train(tc, twd, 3, torch.device("cpu"),
                           draws=lambda i, x1: _jax_draws(i, x1.shape))
    assert all(np.isfinite(stats["losses"]))
    for (kp, a), (_, b) in zip(_leaves(os.path.join(twd, "state.msgpack")),
                               _leaves(os.path.join(jwd, "state.msgpack"))):
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) <= 1e-5 * scale, kp
    one = _from(path, tmp_path / "one")
    trf.mode_train(tc, one, 1, torch.device("cpu"),
                   draws=lambda i, x1: _jax_draws(i, x1.shape))
    for (kp, a), (_, b) in zip(_leaves(os.path.join(one, "state.msgpack")),
                               _leaves(path)):
        assert np.array_equal(a, b), kp


def test_state_file_reads_across_packages(start, tmp_path):
    """Each package restores the other's ``state.msgpack`` bit for bit, so
    its forward on what it read equals its forward on the weights written;
    across the packages the two forwards agree as the zoo's do."""
    jc, path, params = start
    _, tc = rf_tiny.configs()
    jm, apply = jrf._model_and_apply(jc)
    apply = jax.jit(apply)
    x = np.random.default_rng(22).normal(size=(2, 8, 8, 3)).astype(
        np.float32)
    t = np.asarray([0.25, 0.75], np.float32)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    # JAX's file in the port
    _, _, _, _, ref = rf_tiny.models(seed=21)
    rf = trf._model(tc, torch.device("cpu"))
    trf._load_or_init(rf, os.path.dirname(path))
    with torch.no_grad():
        got, own = rf(xt, tt), ref(xt, tt)
    rf_tiny.close(got, own, 1e-6)
    want = np.asarray(apply(params, x, t))
    rf_tiny.close(got, want, 1e-5)
    # the port's file in JAX's _load_or_init
    wd = str(tmp_path / "port")
    trf._save(rf, wd)
    back = jrf._load_or_init(jm, jc, wd)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    rf_tiny.close(np.asarray(apply(back, x, t)), want, 1e-6)
    with open(os.path.join(wd, "state.msgpack"), "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    assert set(raw) == {"params"}


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32)
            for s in ((3, 4), (5,), (2, 2, 2))]


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    """Below its threshold the clip leaves g alone; above it g becomes
    (g / norm) * max_norm, optax's order of operations."""
    gs = _grads(1, scale)
    want, _ = optax.clip_by_global_norm(1.0).update(gs, None)
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(ps, gs):
        p.grad = torch.from_numpy(g.copy())
    opt = trf.ClippedAdamWarmup(ps, lr=0.1, warmup=1, grad_clip=1.0)
    opt.step()   # the first update is zero; the clip acts on the grads
    for p, w in zip(ps, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=0)
        assert not p.detach().abs().max()


def test_optimizer_matches_optax_chain():
    """Three steps of ``rf_main``'s optimizer on fixed gradients against
    ``rf_main._optimizer``: clip, Adam, and the warmup's rates 0, lr/2,
    lr."""
    _, tc = rf_tiny.configs()
    tc.optim.lr, tc.optim.grad_clip = 0.1, 2.0
    params = [np.ones(s, np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    tx = jrf._optimizer(tc)
    st = tx.init(params)
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = trf.make_optimizer(ps, tc)
    jp = params
    for i in range(3):
        gs = _grads(10 + i, 1.0)
        upd, st = tx.update(gs, st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, w in zip(ps, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
    assert [opt.rate(k) for k in range(4)] == pytest.approx(
        [0.0, 0.05, 0.1, 0.1])


def test_runs_on_the_card_unless_asked(tmp_path):
    """Without ``--opts device cpu`` ``rf_main`` asks for ``cuda`` and, with
    no GPU visible, raises rather than run on the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trf.main(["--config", "cifar10_rf_gaussian_ddpmpp", "--mode",
                  "sample", "--workdir", str(tmp_path), "--opts",
                  *rf_tiny.TINY])
