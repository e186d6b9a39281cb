"""The port's minibatch-OT couplings (``pnpflow_tpu_torch/ops/ot.py``)
against the JAX package's ``pnpflow_tpu/ops/ot.py`` on the same numpy
inputs.

Bounds: the squared-distance matrix within 1e-5 of max|cost| (one float32
matmul against another, summed in another order); the Sinkhorn log-plan
within 1e-5 absolute (100 float32 logsumexp sweeps); the host pairing and
the exact assignment index for index.  Draws from a plan are held to the
plan's probabilities by their frequencies (the two packages' random numbers
differ): each within 5 binomial standard deviations plus 1e-3.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pnpflow_tpu.ops import ot as jot
from pnpflow_tpu_torch.ops import ot


def _batch(seed, n=8, dim=(6, 6, 3)):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, *dim), dtype=np.float32)
    x1 = (0.5 * rng.standard_normal((n, *dim)) + 0.3).astype(np.float32)
    return x0, x1


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_sq_dists_matches_jax(seed):
    x0, x1 = _batch(seed)
    want = np.asarray(jot.pairwise_sq_dists(jnp.asarray(x0), jnp.asarray(x1)))
    got = ot.pairwise_sq_dists(torch.from_numpy(x0),
                               torch.from_numpy(x1)).numpy()
    assert got.shape == (8, 8) and (got >= 0).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", [2, 16, 64])
def test_host_ot_pair_is_index_identical_to_jax(n):
    x0, x1 = _batch(n, n=n, dim=(8, 8, 3))
    want = jot.host_ot_pair(x0, x1, np.random.default_rng(7))
    got = ot.host_ot_pair(x0, x1, np.random.default_rng(7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # rows are a resample with replacement; each row keeps its partner
    sigma = ot._host_assignment(((x0.reshape(n, 1, -1)
                                  - x1.reshape(1, n, -1)) ** 2).sum(-1))
    np.testing.assert_array_equal(got[1], sigma[got[0]])


@pytest.mark.parametrize("n", [1, 5, 32])
def test_exact_assignment_equals_scipy(n):
    cost = np.random.default_rng(n).random((n, n)) * 10.0
    _, col = linear_sum_assignment(cost)
    got = ot.exact_assignment(torch.from_numpy(cost).float())
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), col)
    np.testing.assert_array_equal(ot._host_assignment(cost), col)


def test_scipy_only_where_the_native_solver_fails(monkeypatch):
    class Failing:
        def lap_solve(self, *args):
            return 1

    cost = np.random.default_rng(3).random((6, 6))
    monkeypatch.setattr(ot, "load_lap", lambda: Failing())
    np.testing.assert_array_equal(ot._host_assignment(cost),
                                  linear_sum_assignment(cost)[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_sinkhorn_log_plan_matches_jax(seed):
    x0, x1 = _batch(seed)
    cost = np.array(jot.pairwise_sq_dists(jnp.asarray(x0),
                                          jnp.asarray(x1)))
    want = np.asarray(jot.sinkhorn_plan(jnp.asarray(cost), reg=0.05,
                                        iters=100))
    got = ot.sinkhorn_plan(torch.from_numpy(cost), reg=0.05,
                           iters=100).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # uniform marginals
    plan = np.exp(got.astype(np.float64))
    np.testing.assert_allclose(plan.sum(0), 1 / 8, rtol=1e-4)


def test_pairs_drawn_from_the_plan_follow_it():
    probs = np.array([[0.30, 0.05, 0.0, 0.0],
                      [0.0, 0.15, 0.05, 0.05],
                      [0.05, 0.0, 0.10, 0.0],
                      [0.0, 0.05, 0.0, 0.20]])
    log_plan = torch.log(torch.from_numpy(probs).float())
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros((4, 4))
    for _ in range(2500):
        i, j = ot.sample_pairs_from_log_plan(log_plan, gen)
        np.add.at(counts, (i.numpy(), j.numpy()), 1)
    n = counts.sum()
    assert n == 10000
    freq = counts / n
    tol = 5 * np.sqrt(probs * (1 - probs) / n) + 1e-3
    assert (np.abs(freq - probs) <= tol).all(), freq
    assert (counts[probs == 0] == 0).all()


@pytest.mark.parametrize("method", ["exact", "sinkhorn", "indep"])
def test_ot_pair_indices_couples_noise_with_data(method):
    x0, x1 = _batch(4)
    t0, t1 = torch.from_numpy(x0), torch.from_numpy(x1)
    i0, i1 = ot.ot_pair_indices(t0, t1, torch.Generator().manual_seed(1),
                                method=method)
    assert i0.shape == i1.shape == (8,)
    assert int(i0.min()) >= 0 and int(i1.max()) < 8
    if method == "indep":
        np.testing.assert_array_equal(i0.numpy(), np.arange(8))
        np.testing.assert_array_equal(i1.numpy(), np.arange(8))
    if method == "exact":
        cost = ot.pairwise_sq_dists(t0, t1).double().numpy()
        sigma = linear_sum_assignment(cost)[1]
        np.testing.assert_array_equal(i1.numpy(), sigma[i0.numpy()])
    with pytest.raises(ValueError, match="Unknown"):
        ot.ot_pair_indices(t0, t1, None, method="emd")


def test_lap_is_built_into_build_never_into_csrc(monkeypatch, tmp_path):
    repo = ot.LAP_SOURCE.parents[1]
    assert ot.LAP_SOURCE == repo / "csrc" / "lap.cpp"
    assert ot.lap_library_path().parent == repo / "build"
    csrc_before = sorted(p.name for p in (repo / "csrc").iterdir())
    monkeypatch.setattr(ot, "LAP_BUILD_DIR", tmp_path / "build")
    ot.load_lap.cache_clear()
    try:
        lib = ot.load_lap()
        so = ot.lap_library_path()
        assert so.parent == tmp_path / "build" and so.exists()
        assert so.name.startswith("liblap-") and so.suffix == ".so"
        cost = np.ascontiguousarray(np.random.default_rng(0).random((5, 5)))
        out = np.empty(5, np.int32)
        assert lib.lap_solve(5, cost.ctypes.data, out.ctypes.data) == 0
        np.testing.assert_array_equal(out, linear_sum_assignment(cost)[1])
        # the source directory gains no file of the port's naming
        after = sorted(p.name for p in (repo / "csrc").iterdir())
        assert not [f for f in after if f.startswith("liblap-")]
        assert set(after) - set(csrc_before) <= {"liblap.so"}
    finally:
        ot.load_lap.cache_clear()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "lap.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ot, "LAP_SOURCE", bad)
    monkeypatch.setattr(ot, "LAP_BUILD_DIR", tmp_path / "build")
    ot.load_lap.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            ot.load_lap()
    finally:
        ot.load_lap.cache_clear()
