"""ODE integrators for the flow ODE dx/dt = v(x, t) (port of
``pnpflow_tpu/ops/ode.py``).

The reference integrates with ``torchdiffeq``: adaptive dopri5 at
rtol = atol = 1e-5 (d_flow.py:51-60) and fixed-step euler / midpoint
schemes (d_flow.py:41-49, sampling.py:69-109).  The JAX package writes them
as ``lax.scan`` / ``lax.while_loop`` programs; here they are host loops over
the device's tensors, with the JAX programs' float32 arithmetic: every time
and step size is a float32 value computed on the host as XLA computes it on
the device.

* :func:`odeint_euler`, :func:`odeint_midpoint`, :func:`odeint_heun`:
  fixed-step, differentiable through autograd;
* :func:`odeint_dopri5_stats`: adaptive Dormand-Prince 5(4) with the same
  tableau, error norm (RMS of err / (atol + rtol * max(|x0|, |x1|))) and
  step controller as JAX's ``_odeint_dopri5_stats``: factor
  clip(0.9 * ratio^(-1/5), 0.2, 10), the first step 1% of the interval,
  the last one clipped onto t1, ``max_steps`` attempted steps at most.
  (JAX's module docstring names a 0.7 / 0.4 PI controller; its code, which
  this copies, uses the plain ratio^(-1/5) factor.)  The accept decision is
  one read of the error ratio per attempted step; the controller's
  arithmetic then runs on the host in float32.  It returns the same
  function-evaluation count as JAX: 7 per attempted step.

:func:`odeint` dispatches on the method's name, as JAX's ``odeint`` does.

Every integrator takes ``f(x, t) -> dx/dt`` with ``t`` a Python float and
integrates from t0 to t1, in either direction.
"""

from __future__ import annotations

import numpy as np

__all__ = ["odeint", "odeint_euler", "odeint_midpoint", "odeint_heun",
           "odeint_dopri5", "odeint_dopri5_stats"]

f32 = np.float32


def _fixed_times(t0, t1, steps):
    """dt (a Python float, as JAX's) and each step's float32 t0 + i * dt."""
    dt = (t1 - t0) / steps
    return dt, [f32(t0) + f32(i) * f32(dt) for i in range(steps)]


def odeint_euler(f, x0, t0: float, t1: float, steps: int):
    dt, ts = _fixed_times(t0, t1, steps)
    x = x0
    for t in ts:
        x = x + float(f32(dt)) * f(x, float(t))
    return x


def odeint_midpoint(f, x0, t0: float, t1: float, steps: int):
    """Explicit midpoint, torchdiffeq's 'midpoint': 2 evaluations a step."""
    dt, ts = _fixed_times(t0, t1, steps)
    half = f32(0.5 * dt)
    x = x0
    for t in ts:
        k1 = f(x, float(t))
        k2 = f(x + float(half) * k1, float(t + half))
        x = x + float(f32(dt)) * k2
    return x


def odeint_heun(f, x0, t0: float, t1: float, steps: int):
    dt, ts = _fixed_times(t0, t1, steps)
    x = x0
    for t in ts:
        k1 = f(x, float(t))
        k2 = f(x + float(f32(dt)) * k1, float(t + f32(dt)))
        x = x + float(f32(0.5 * dt)) * (k1 + k2)
    return x


# Dormand-Prince 5(4), as float32 constants (JAX holds C, B5 and B4 as
# float32 arrays and multiplies each A entry into a float32 dt)
_DOPRI_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], f32)
_DOPRI_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DOPRI_B5 = np.array(
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0], f32)
_DOPRI_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
     187 / 2100, 1 / 40], f32)


def _dopri_step(f, x, t, dt):
    """One attempted step from float32 (t, dt): (x5, err)."""
    ks = [f(x, float(t))]
    for i in range(1, 7):
        xi = x
        for j, a in enumerate(_DOPRI_A[i]):
            xi = xi + float(dt * f32(a)) * ks[j]
        ks.append(f(xi, float(t + _DOPRI_C[i] * dt)))
    x5, err = x, None
    for i in range(7):
        x5 = x5 + float(dt * _DOPRI_B5[i]) * ks[i]
        e = float(dt * (_DOPRI_B5[i] - _DOPRI_B4[i])) * ks[i]
        err = e if err is None else err + e
    return x5, err


def _error_ratio(err, x0, x1, rtol, atol):
    tol = atol + rtol * x0.abs().maximum(x1.abs())
    return ((err / tol) ** 2).mean().sqrt()


def odeint_dopri5_stats(f, x0, t0: float, t1: float, rtol: float = 1e-5,
                        atol: float = 1e-5, max_steps: int = 10000):
    """Adaptive dopri5 from t0 to t1 -> (x, nfe).  ``max_steps`` bounds the
    attempted steps, rejected ones included; a field that exhausts it
    returns the state integrated so far, as JAX's while loop does."""
    t0, t1 = f32(t0), f32(t1)
    span = abs(t1 - t0)
    dt = np.sign(t1 - t0) * span * f32(0.01)
    t, x, nsteps = t0, x0, 0
    safety, ifactor, dfactor = f32(0.9), f32(10.0), f32(0.2)
    while abs(t - t0) < span and nsteps < max_steps:
        remaining = t1 - t
        if abs(dt) > abs(remaining):
            dt = remaining
        x_new, err = _dopri_step(f, x, t, dt)
        ratio = f32(_error_ratio(err, x, x_new, rtol, atol).item())
        factor = np.clip(
            safety * (f32(1.0) / max(ratio, f32(1e-10))) ** f32(0.2),
            dfactor, ifactor)
        if ratio <= 1.0:
            x, t = x_new, t + dt
        dt = dt * factor
        nsteps += 1
    return x, 7 * nsteps


def odeint_dopri5(f, x0, t0: float, t1: float, rtol: float = 1e-5,
                  atol: float = 1e-5, max_steps: int = 10000):
    return odeint_dopri5_stats(f, x0, t0, t1, rtol=rtol, atol=atol,
                               max_steps=max_steps)[0]


def odeint(f, x0, t0: float, t1: float, method: str = "dopri5",
           steps: int = 100, rtol: float = 1e-5, atol: float = 1e-5):
    """Integrate with ``method`` (euler, midpoint, heun: ``steps`` fixed
    steps; dopri5: adaptive at ``rtol`` / ``atol``)."""
    if method == "euler":
        return odeint_euler(f, x0, t0, t1, steps)
    if method == "midpoint":
        return odeint_midpoint(f, x0, t0, t1, steps)
    if method == "heun":
        return odeint_heun(f, x0, t0, t1, steps)
    if method == "dopri5":
        return odeint_dopri5(f, x0, t0, t1, rtol=rtol, atol=atol)
    raise ValueError("Unknown ODE method: {}".format(method))
