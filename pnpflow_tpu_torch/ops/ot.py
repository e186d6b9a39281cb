"""Minibatch optimal-transport couplings for flow-matching training (port of
``pnpflow_tpu/ops/ot.py``).

The reference pairs each minibatch of noise x0 with data x1 by an exact OT
plan (POT's ``ot.emd`` on squared euclidean costs) and samples B index pairs
from it.  Two couplings, as in the JAX package:

  * ``exact``    -- with uniform marginals and equal batch sizes the plan is
                    a permutation / B, i.e. a linear assignment, solved on the
                    host by the repository's C++ solver (``csrc/lap.cpp``),
                    then B matched pairs resampled with replacement;
  * ``sinkhorn`` -- log-domain Sinkhorn on the device, pairs drawn from the
                    entropic plan with Gumbel noise from an explicit
                    ``torch.Generator``.

:func:`host_ot_pair` makes the same numpy draws from the same
``np.random.Generator`` as the JAX function, so both packages pair a batch
alike.  The solver is compiled from ``csrc/lap.cpp`` (read, never written)
by ``g++`` into ``build/``, named by a hash of the source and flags, at the
first call that needs it; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

_REPO = Path(__file__).resolve().parents[2]
LAP_SOURCE = _REPO / "csrc" / "lap.cpp"
LAP_BUILD_DIR = _REPO / "build"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, B) squared euclidean distances of flattened samples: one matmul
    plus rank-1 corrections, clamped at 0."""
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    a2 = (a * a).sum(dim=1, keepdim=True)
    b2 = (b * b).sum(dim=1, keepdim=True)
    return torch.clamp(a2 - 2.0 * (a @ b.T) + b2.T, min=0.0)


def lap_library_path() -> Path:
    h = hashlib.sha256(LAP_SOURCE.read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    return LAP_BUILD_DIR / f"liblap-{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def load_lap():
    """The native Jonker-Volgenant solver, built on first use.  Raises
    ``RuntimeError`` if ``g++`` fails."""
    so = lap_library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(LAP_SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {LAP_SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.lap_solve.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.lap_solve.restype = ctypes.c_int
    lib.sq_dist_matrix.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.sq_dist_matrix.restype = None
    return lib


def _lap_solve(cost: np.ndarray):
    """Column of each row, or None where the native solver reports an
    error.  ``cost`` is a C-contiguous (n, n) float64 array."""
    n = cost.shape[0]
    out = np.empty(n, np.int32)
    rc = load_lap().lap_solve(n, cost.ctypes.data, out.ctypes.data)
    return out if rc == 0 else None


def _host_assignment(cost: np.ndarray) -> np.ndarray:
    """Exact assignment of a (B, B) cost on the host; scipy's
    ``linear_sum_assignment`` only where the native solver returns an error
    code, as in the JAX package."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    sigma = _lap_solve(cost)
    if sigma is not None:
        return sigma
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)[1].astype(np.int32)


def exact_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Exact OT assignment sigma (row i of x0 pairs with sigma(i) of x1) of a
    cost on any device, solved on the host; returned on the cost's device."""
    sigma = _host_assignment(cost.detach().double().cpu().numpy())
    return torch.from_numpy(sigma.astype(np.int64)).to(cost.device)


def sinkhorn_plan(cost: torch.Tensor, reg: float = 0.05, iters: int = 100):
    """Log-domain Sinkhorn with uniform marginals; returns the log-plan
    (B, B).  ``reg`` is relative to the mean cost."""
    b = cost.shape[0]
    eps = reg * cost.mean() + 1e-12
    log_k = -cost / eps
    log_mu = torch.full((b,), -float(np.log(b)), dtype=cost.dtype,
                        device=cost.device)
    f = torch.zeros(b, dtype=cost.dtype, device=cost.device)
    g = torch.zeros_like(f)
    for _ in range(iters):
        f = log_mu - torch.logsumexp(log_k + g[None, :], dim=1)
        g = log_mu - torch.logsumexp(log_k + f[:, None], dim=0)
    return log_k + f[:, None] + g[None, :]


def sample_pairs_from_log_plan(log_plan: torch.Tensor,
                               generator: torch.Generator):
    """Draw B (i, j) pairs from the plan with replacement: a Gumbel-max over
    the flattened plan, the noise from ``generator`` (on the plan's
    device)."""
    b = log_plan.shape[0]
    flat = log_plan.reshape(-1)
    tiny = torch.finfo(flat.dtype).tiny
    u = torch.rand((b, flat.shape[0]), generator=generator,
                   dtype=flat.dtype, device=flat.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    choice = torch.argmax(flat[None, :] + gumbel, dim=1)
    return choice // b, choice % b


def host_ot_pair(x0: np.ndarray, x1: np.ndarray, rng: np.random.Generator):
    """Exact OT pairing on the host: the cost by ``sq_dist_matrix`` in
    float64, the assignment, then B rows resampled with replacement from
    ``rng``.  Returns numpy ``(idx0, idx1)``."""
    a = np.ascontiguousarray(x0.reshape(x0.shape[0], -1), np.float32)
    b = np.ascontiguousarray(x1.reshape(x1.shape[0], -1), np.float32)
    n = a.shape[0]
    cost = np.empty((n, n), np.float64)
    load_lap().sq_dist_matrix(n, a.shape[1], a.ctypes.data, b.ctypes.data,
                              cost.ctypes.data)
    sigma = _host_assignment(cost)
    rows = rng.integers(0, n, size=n)
    return rows, sigma[rows]


def ot_pair_indices(x0: torch.Tensor, x1: torch.Tensor,
                    generator: torch.Generator, method: str = "exact",
                    reg: float = 0.05, iters: int = 100):
    """Pair noise x0 with data x1: ``(idx0, idx1)`` such that
    ``(x0[idx0], x1[idx1])`` are coupled samples."""
    b = x0.shape[0]
    if method == "indep":
        idx = torch.arange(b, device=x0.device)
        return idx, idx
    cost = pairwise_sq_dists(x0, x1)
    if method == "exact":
        sigma = exact_assignment(cost)
        rows = torch.randint(0, b, (b,), generator=generator,
                             device=x0.device)
        return rows, sigma[rows]
    if method == "sinkhorn":
        return sample_pairs_from_log_plan(
            sinkhorn_plan(cost, reg=reg, iters=iters), generator)
    raise ValueError(f"Unknown OT coupling method: {method}")
