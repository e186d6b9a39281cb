"""Serving / library API: configure once, restore many batches (port of
``pnpflow_tpu/serve.py``).

The CLI mirrors the reference's batch-evaluation protocol; a deployment
wants a ``Restorer`` built once (weights loaded, degradation and solver
made) and called on each incoming measurement batch, with no side effects
on the results directories:

    from pnpflow_tpu_torch.serve import Restorer

    r = Restorer(method="pnp_flow", problem="gaussian_deblurring_FFT",
                 dim_image=64, overrides={"steps_pnp": 50})
    restored = r.restore(noisy_batch)           # NHWC, [-1, 1] -> numpy

``seed`` keys each call's randomness (the solver's Monte-Carlo draws, and
the measurement noise of :meth:`Restorer.degrade`), so the same input and
seed give the same output, whatever was served before.  Intended divergence
from JAX: a ``pnp_gs`` request starts from ``args.alpha``, where JAX's
starts from the alpha that the deblurring backtracking of the requests
before it shrank, so that its output depends on what it served earlier.
Every method and problem of the CLI is valid; the config is the CLI's
three-tier YAML with ``overrides`` in place of ``--opts``.  It runs on ``cuda`` unless ``device`` says otherwise, with
TF32 off in float32 as the CLI runs.  There is one card: ``shard=True`` and
``n_devices`` raise (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pnpflow_tpu_torch.device import resolve_device, set_fp32_parity_mode
from pnpflow_tpu_torch.models.registry import build_model_bundle
from pnpflow_tpu_torch.ops.degradations import make_degradation
from pnpflow_tpu_torch.solvers.base import draw_noise
from pnpflow_tpu_torch.solvers.factory import build_solver
from pnpflow_tpu_torch.utils.config import load_full_config

# the shipped config/ tree, one level above the package
CONFIG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Restorer:
    """One configured (model, degradation, solver) pipeline.

    The parameters mirror the CLI keys: ``method`` (pnp_flow, ot_ode,
    d_flow, flow_priors, pnp_gs, pnp_diff), ``problem``, ``model`` family,
    image geometry and noise model.  The weights are resolved as the CLI
    resolves them under ``output_root`` (msgpack, then torch ``.pt``, else
    a seeded random init with a warning)."""

    def __init__(self, method: str = "pnp_flow",
                 problem: str = "gaussian_deblurring_FFT",
                 model: str = "ot", dim_image: int = 64,
                 num_channels: int = 3, noise_type: str = "gaussian",
                 sigma_noise: float | None = None, batch_size: int = 4,
                 overrides: dict | None = None, dtype=torch.float32,
                 device=None, shard: bool = False,
                 n_devices: int | None = None,
                 output_root: str | None = None):
        if shard or n_devices is not None:
            raise NotImplementedError(
                "sharded serving needs several cards; the port runs on one "
                "(ROADMAP queue 1, item 7)")
        self.device = resolve_device(device)
        opts = ["dataset", "synthetic", "model", model, "method", method,
                "problem", problem, "noise_type", noise_type,
                "batch_size_ip", str(batch_size), "root", CONFIG_ROOT,
                "save_results", "False", "compute_time", "False",
                "compute_memory", "False"]
        for k, v in (overrides or {}).items():
            opts += [str(k), str(v)]
        args = load_full_config(opts, root=CONFIG_ROOT)
        args.dim_image = dim_image
        args.num_channels = num_channels
        if output_root is not None:
            # weights come from this root only, not from whatever ./model/
            # the process runs beside
            args.output_root = os.path.join(str(output_root), "")
        if dtype == torch.float32:
            set_fp32_parity_mode()
        self.args = args
        self.bundle = build_model_bundle(args, dtype=dtype,
                                         device=self.device)
        self.degradation, default_sigma = make_degradation(
            args, batch_size=batch_size, device=self.device)
        self.sigma_noise = float(sigma_noise if sigma_noise is not None
                                 else default_sigma)
        self.solver = build_solver(self.bundle, args)

    def degrade(self, clean, seed: int = 0):
        """y = H(clean) + sigma * noise, the noise (gaussian or laplace)
        from a generator seeded ``seed`` on the device."""
        clean = torch.as_tensor(clean, dtype=torch.float32,
                                device=self.device)
        y = self.degradation.H(clean)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return y + self.sigma_noise * draw_noise(
            y.shape, self.args.noise_type, gen, y.device, y.dtype)

    def restore(self, noisy, seed: int = 0):
        """Restore one NHWC measurement batch -> numpy array; ``seed`` keys
        the solver's randomness, as the batch index does in the CLI."""
        noisy = torch.as_tensor(noisy, dtype=torch.float32,
                                device=self.device)
        if self.args.method == "pnp_gs":
            # each request starts from args.alpha, not from the alpha that
            # an earlier request's backtracking shrank
            self.solver._alpha_carry = float(self.args.alpha)
        with self.solver.grad_mode():
            out, _ = self.solver.solve_batch(
                noisy, noisy, self.degradation, self.sigma_noise, int(seed))
        return out.float().cpu().numpy()

    def warmup(self, batch_size: int | None = None):
        """One restoration of zeros, before traffic."""
        bs = batch_size or int(self.args.batch_size_ip)
        self.restore(np.zeros((bs, self.args.dim_image, self.args.dim_image,
                               self.args.num_channels), np.float32))
        return self
