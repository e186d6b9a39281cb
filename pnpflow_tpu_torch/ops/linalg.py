"""Restarted GMRES for the ``ot_ode`` solver's generic branch.

A copy of what ``jax.scipy.sparse.linalg.gmres(A, b, maxiter=100,
solve_method="batched")`` computes with JAX's defaults (tol 1e-5, atol 0,
restart 20, x0 = 0, no preconditioner), written for torch tensors:

* the whole of ``b``, any shape (``ot_ode`` passes the (B, H, W, C) batch),
  is one vector, as JAX treats it: one system for the batch, not one per
  image;
* each restart builds up to ``restart`` Arnoldi vectors, orthogonalised by
  one classical Gram-Schmidt pass (JAX's ``max_iterations=2`` loop stops
  after its first pass), a new vector whose norm is at most float32's eps
  times its norm before the pass counting as a breakdown that ends the
  restart;
* the small least-squares problem is solved as JAX's ``_lstsq`` does,
  through the normal equations and a Cholesky factorisation, with the
  Hessenberg matrix's unused rows left as rows of the identity;
* restarts continue while the residual norm exceeds max(tol * |b|, atol),
  at most ``maxiter`` times.

The decisions that end a restart or the solve are read on the host, one
value each.
"""

from __future__ import annotations

import torch

__all__ = ["gmres"]


def _safe_normalize(x, thresh):
    """(x / |x|, |x|), or (0, 0) where |x| <= thresh."""
    norm = torch.linalg.vector_norm(x)
    use = norm > thresh
    return (torch.where(use, x / norm, torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _restart(A, b, x0, unit_residual, residual_norm, restart, eps):
    shape, n = b.shape, b.numel()
    V = unit_residual.new_zeros((n, restart + 1))
    V[:, 0] = unit_residual.reshape(n)
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    for k in range(restart):
        v = A(V[:, k].reshape(shape)).reshape(n)
        _, v_norm_0 = _safe_normalize(v, eps)
        h = V.T @ v
        v = v - V @ h
        unit_v, v_norm_1 = _safe_normalize(v, eps * v_norm_0)
        V[:, k + 1] = unit_v
        h[k + 1] = v_norm_1
        H[k] = h
        if v_norm_1.item() == 0.0:
            break
    beta = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
    beta[0] = residual_norm
    a = H.T
    y = torch.cholesky_solve((a.T @ beta)[:, None],
                             torch.linalg.cholesky_ex(a.T @ a).L)[:, 0]
    x = x0 + (V[:, :-1] @ y).reshape(shape)
    unit, norm = _safe_normalize(b - A(x), eps)
    return x, unit, norm


def gmres(A, b, *, tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
          maxiter: int | None = None):
    """Solve A x = b from x0 = 0 -> (x, restarts run).  ``A`` maps a tensor
    of b's shape to one of the same shape."""
    eps = torch.finfo(b.dtype).eps
    n = b.numel()
    maxiter = 10 * n if maxiter is None else maxiter
    restart = min(restart, n)
    b_norm = torch.linalg.vector_norm(b)
    atol = torch.clamp_min(tol * b_norm, atol).item()
    x = torch.zeros_like(b)
    unit, norm = _safe_normalize(b - A(x), eps)
    k = 0
    while k < maxiter and norm.item() > atol:
        x, unit, norm = _restart(A, b, x, unit, norm, restart, eps)
        k += 1
    return x, k
