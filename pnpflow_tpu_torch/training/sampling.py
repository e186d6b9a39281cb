"""Rectified-flow sampling (port of ``pnpflow_tpu/training/sampling.py``).

``get_sampling_fn(config, model_fn, shape)`` dispatches on
``config.sampling.method`` ('rectified_flow', the only one of the trimmed
reference, ``sampling.py:36-161``), honours ``init_type``,
``init_noise_scale``, ``sigma_variance``, ``sample_N``, ``use_ode_sampler``
and ``ode_tol``, and returns ``sample(generator=None, z=None,
step_noise=None) -> (x, nfe)``: the samples and the number of velocity
evaluations.

* "euler": ``training/flow_matching.py:euler_sample_stochastic`` in
  ``sample_N`` steps over [eps, 1] (``sigma_variance`` turns the ODE into a
  diffusion with the same marginals); from an explicit ``z`` it integrates
  from ``z`` itself (JAX's ``_euler_from``);
* "rk45" / "ode": ``ops/ode.py:odeint_dopri5_stats`` from eps to 1 at rtol =
  atol = ``ode_tol``, whose nfe counts 7 evaluations an attempted step.

``model_fn(x, t)`` carries the model's own t convention (``rf_main`` folds
in the t * 999).  Draws come from ``generator`` (on the samples' device) or
are injected: ``z`` the start, ``step_noise`` Euler's per-step noise.
"""

from __future__ import annotations

import torch

from pnpflow_tpu_torch.ops.ode import odeint_dopri5_stats
from pnpflow_tpu_torch.training.flow_matching import (
    euler_sample_stochastic, euler_stochastic_from)

EPS = 1e-3  # sampling.py:90 / sde_lib ode eps


def get_rectified_flow_sampler(model_fn, shape, *, init_type: str = "gaussian",
                               init_noise_scale: float = 1.0,
                               sigma_variance: float = 0.0,
                               sample_N: int = 100,
                               use_ode_sampler: str = "rk45",
                               ode_tol: float = 1e-5,
                               inverse_scaler=lambda x: x, device=None):
    """-> ``sample(generator=None, z=None, step_noise=None) -> (x, nfe)``
    on ``device`` (reference ``sampling.py:62-161``)."""
    if init_type != "gaussian":
        raise NotImplementedError(
            "INITIALIZATION TYPE NOT IMPLEMENTED")  # sde_lib.py:103-107
    shape = tuple(shape)

    if use_ode_sampler == "euler":
        @torch.no_grad()
        def sample(generator=None, z=None, step_noise=None):
            if z is None:
                x = euler_sample_stochastic(
                    model_fn, shape, steps=sample_N, sigma_var=sigma_variance,
                    noise_scale=init_noise_scale, eps=EPS,
                    generator=generator, step_noise=step_noise, device=device)
            else:
                x = euler_stochastic_from(
                    model_fn, z, sample_N, sigma_variance, init_noise_scale,
                    EPS, generator, step_noise)
            return inverse_scaler(x), sample_N

        return sample

    if use_ode_sampler in ("rk45", "ode"):
        @torch.no_grad()
        def sample(generator=None, z=None, step_noise=None):
            x0 = z if z is not None else init_noise_scale * torch.randn(
                shape, generator=generator, device=device)

            def vfield(x, t):
                return model_fn(x, torch.full((shape[0],), t,
                                              device=x.device))

            x, nfe = odeint_dopri5_stats(vfield, x0, EPS, 1.0, rtol=ode_tol,
                                         atol=ode_tol)
            return inverse_scaler(x), int(nfe)

        return sample

    raise ValueError("Sampler {} unknown.".format(use_ode_sampler))


def get_sampling_fn(config, model_fn, shape, inverse_scaler=lambda x: x,
                    device=None):
    """The config's sampler (reference ``sampling.py:36-60``)."""
    method = config.sampling.method
    if method.lower() != "rectified_flow":
        raise ValueError("Sampler name {} unknown.".format(method))
    s = config.sampling
    return get_rectified_flow_sampler(
        model_fn, shape, init_type=s.get("init_type", "gaussian"),
        init_noise_scale=float(s.get("init_noise_scale", 1.0)),
        sigma_variance=float(s.get("sigma_variance", 0.0)),
        sample_N=int(s.get("sample_N", 100)),
        use_ode_sampler=s.get("use_ode_sampler", "rk45"),
        ode_tol=float(s.get("ode_tol", 1e-5)),
        inverse_scaler=inverse_scaler, device=device)
