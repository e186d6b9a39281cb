"""Likelihood (bits/dim) of a flow model by the instantaneous change of
variables (port of ``pnpflow_tpu/ops/likelihood.py``; the vendored
``image_generation/likelihood.py:27-195``).

The flow ODE runs backward from the data with an augmented log-determinant
state whose drift is -div v(x, t); the divergence is a Hutchinson estimate
with Rademacher probes, each a Jacobian-vector product through the model
(``torch.func.jvp``, forward mode: on the NCSN++ the FIR kernel's tangent
rule runs the ``upfirdn2d`` kernel on the tangent).

    log p1(x) = log p0(z0) - int_0^1 div v(x_t, t) dt
    bits/dim  = -log p1(x) / (D ln 2) + log2(255 / 2)  (data from uint8)

The solve is ``steps`` midpoint steps from t = 1 to 0.  JAX evaluates a
divergence at each step's start too and never uses it; the port computes
only the midpoint's, whose JVP also gives the midpoint velocity.  Probes
come from a ``torch.Generator`` or are injected (``probes``: one (n_probes,
*x.shape) stack per step), so a test can give both packages JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

f32 = np.float32


def rademacher(shape, generator=None, device=None):
    """+-1 with equal odds, float32."""
    return (torch.randint(0, 2, tuple(shape), generator=generator,
                          device=device) * 2 - 1).float()


def _value_and_divergence(model_fwd, x, t_vec, probes):
    """(v(x), the Hutchinson divergence averaged over ``probes``)."""
    def f(z):
        return model_fwd(z, t_vec)

    v, div = None, 0.0
    dims = tuple(range(1, x.ndim))
    for eps in probes:
        v, jv = torch.func.jvp(f, (x,), (eps.to(x),))
        div = div + (jv * eps.to(jv)).sum(dim=dims)
    return v, div / len(probes)


def _probes(n_probes, x, generator):
    return [rademacher(x.shape, generator, x.device) for _ in range(n_probes)]


@torch.no_grad()
def divergence_hutchinson(model_fwd, x, t_vec, generator=None,
                          n_probes: int = 1, probes=None):
    """Per-sample Hutchinson estimate of div v = tr(dv/dx): the mean over
    ``n_probes`` Rademacher probes (or the given ``probes``) of
    sum(eps * J eps)."""
    if probes is None:
        probes = _probes(n_probes, x, generator)
    return _value_and_divergence(model_fwd, x, t_vec, probes)[1]


@torch.no_grad()
def log_likelihood(model_fwd, x1, generator=None, steps: int = 100,
                   n_probes: int = 1, probes=None):
    """log p(x1) under the flow prior, in nats, and the latent z0.

    ``model_fwd(x, t_vec) -> v``.  Midpoint steps of dt = -1/steps on the
    augmented [x, logdet] system from t = 1 to 0; ``probes[i]`` are step
    i's midpoint probes."""
    b = x1.shape[0]
    d = math.prod(x1.shape[1:])
    dt = -1.0 / steps
    x = x1
    logdet = torch.zeros(b, device=x1.device)
    for i in range(steps):
        t = f32(1.0) + f32(i) * f32(dt)
        tm = t + f32(0.5 * dt)
        v1 = model_fwd(x, torch.full((b,), float(t), device=x.device))
        xm = x + 0.5 * dt * v1
        ps = (_probes(n_probes, x, generator) if probes is None else
              [torch.as_tensor(np.asarray(p), device=x.device)
               for p in probes[i]])
        v2, div2 = _value_and_divergence(
            model_fwd, xm, torch.full((b,), float(tm), device=x.device), ps)
        x = x + dt * v2
        logdet = logdet + dt * div2
    logp0 = (-0.5 * (x.reshape(b, -1) ** 2).sum(dim=1)
             - 0.5 * d * float(np.log(f32(2.0 * np.pi))))
    # logdet = sum dt * div with dt < 0, i.e. -int_0^1 div dt
    return logp0 + logdet, x


def bits_per_dim(model_fwd, x1, generator=None, steps: int = 100,
                 n_probes: int = 1, probes=None):
    """bits/dim of data in [-1, 1] scaled from uint8 (the vendored
    convention, ``likelihood.py:160-190``): x = 2u/255 - 1, so |dx/du| =
    (2/255)^D."""
    logp, _ = log_likelihood(model_fwd, x1, generator, steps, n_probes,
                             probes)
    d = math.prod(x1.shape[1:])
    return -logp / (d * math.log(2.0)) + math.log2(255.0 / 2.0)
