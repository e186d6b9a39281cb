"""The port's serving API (``pnpflow_tpu_torch/serve.py``).

``restore`` is the solver's ``solve_batch`` on the same input and seed,
bit for bit; ``degrade`` is seeded; what sharding refuses;
a ``Restorer`` writes nothing under its output root.
"""

import os

import numpy as np
import pytest
import torch

from pnpflow_tpu_torch.serve import Restorer

DIM = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def restorer(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    with pytest.warns(UserWarning, match="random init"):
        r = Restorer(problem="denoising", dim_image=DIM, batch_size=2,
                     overrides={"steps_pnp": 2, "num_samples": 1},
                     device="cpu", output_root=str(root))
    return r, root


def _clean(seed=0):
    return np.tanh(np.random.default_rng(seed).normal(
        size=(2, DIM, DIM, 3))).astype(np.float32)


def test_restore_is_solve_batch(restorer):
    r, root = restorer
    y = r.degrade(_clean(), seed=3)
    got = r.restore(y, seed=5)
    with torch.inference_mode():
        want, _ = r.solver.solve_batch(y, y, r.degradation, r.sigma_noise, 5)
    assert got.shape == (2, DIM, DIM, 3) and np.isfinite(got).all()
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(r.restore(y.numpy(), seed=5), got)
    assert not np.array_equal(r.restore(y, seed=6), got)
    assert r.warmup() is r
    assert os.listdir(root) == []       # no side effects on the results


@pytest.mark.parametrize("noise", ["gaussian", "laplace"])
def test_degrade_is_seeded(noise, tmp_path):
    with pytest.warns(UserWarning, match="random init"):
        r = Restorer(problem="denoising", dim_image=DIM, noise_type=noise,
                     overrides={"steps_pnp": 1}, device="cpu",
                     output_root=str(tmp_path))
    clean = _clean()
    a, b, c = (r.degrade(clean, seed=s) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert r.sigma_noise == (0.3 if noise == "laplace" else 0.2)
    # the noise is the draw of a generator seeded like the call
    noise_1 = (a - torch.from_numpy(clean)) / r.sigma_noise
    assert abs(float(noise_1.std()) - (2 ** 0.5 if noise == "laplace"
                                       else 1.0)) < 0.05


def test_sharding_raises():
    """Sharding is ported (``tests/test_torch_parallel.py``,
    ``tests/test_torch_serve_coupled*.py``); what it refuses: more devices
    than are visible and a device count without ``shard=True``.  A
    restoration that couples the batch's images is no longer refused: it
    keeps one solver, its network fanned out."""
    with pytest.raises(ValueError, match="n_devices 2: 1 cpu"):
        Restorer(device="cpu", shard=True, n_devices=2, dim_image=16,
                 problem="denoising", batch_size=2)
    with pytest.raises(ValueError, match="need shard=True"):
        Restorer(device="cpu", n_devices=2)
    with pytest.warns(UserWarning, match="random init"):
        r = Restorer(device="cpu", method="d_flow", problem="denoising",
                     dim_image=16, batch_size=2, shard=True,
                     devices=["cpu", "cpu"])
    assert r.shards is None and len(r.solver.model.model.replicas) == 2


def test_pnp_gs_request_does_not_depend_on_earlier_ones(tmp_path):
    """hqs deblurring's backtracking shrinks alpha on the warmup's zeros;
    a later request still starts from args.alpha, so it gives what it gave
    before the warmup (JAX's Restorer carries the shrunken alpha over)."""
    with pytest.warns(UserWarning, match="random init"):
        r = Restorer(method="pnp_gs", problem="gaussian_deblurring_FFT",
                     model="gradient_step", dim_image=64, batch_size=1,
                     overrides={"algo": "hqs", "max_iter": 1}, device="cpu",
                     output_root=str(tmp_path))
    clean = np.tanh(np.random.default_rng(0).normal(
        size=(1, 64, 64, 3))).astype(np.float32)
    y = r.degrade(clean, seed=0)
    first = r.restore(y, seed=1)
    r.warmup()
    assert r.solver._alpha_carry < float(r.args.alpha)   # it shrank
    assert np.array_equal(r.restore(y, seed=1), first)
