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
TF32 off in float32 as the CLI runs.

``shard=True`` fans each request batch out over ``n_devices`` cards (all
visible by default; ``devices`` names them, as a test names ``["cpu",
"cpu"]``); the batch must divide over them, and ``n_devices`` may not pass
the visible count.  How depends on whether the restoration couples the
images of a batch (:func:`batch_coupling`):

* **Independent** restorations get a copy of the model, the operator and
  the solver on each device, the batch split into equal shards that run at
  the same time, one thread each (``parallel/mesh.py:fan_out``).  The
  shards draw the solver's noise for the whole batch and keep their own
  images' (``solvers/base.py:draw_rows``), so a sharded restoration equals
  the unsharded one.  ``flow_priors`` shards run one after the other from
  this thread (their JVPs' forward-mode levels are process-wide state); on
  several cards their launches still overlap as far as the host runs
  ahead.
* **Coupled** ones, ``d_flow`` (its dopri5 step sizes and LBFGS line
  search), ``pnp_gs`` with ``algo hqs`` on ``gaussian_deblurring_FFT`` (its
  step-size backtracking) and ``ot_ode`` on ``superresolution_bicubic``
  (GMRES over the whole batch), keep one solver and the whole-batch
  operator on the first device; only the network is fanned out, each
  forward's batch split over the devices (``mesh.ShardedModel``), as
  JAX's ``jit`` keeps the solver's decisions global when it shards the
  batch.  The restoration is the unsharded one, up to the float rounding
  of the network at a smaller batch, which d_flow's adaptive inversion and
  line search can amplify as they amplify any change of rounding.  The
  backward runs in the calling thread.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from pnpflow_tpu_torch.device import resolve_device, set_fp32_parity_mode
from pnpflow_tpu_torch.models.registry import build_model_bundle
from pnpflow_tpu_torch.ops.degradations import (
    degradation_on, make_degradation)
from pnpflow_tpu_torch.parallel import mesh
from pnpflow_tpu_torch.solvers.base import ModelBundle, draw_noise
from pnpflow_tpu_torch.solvers.factory import build_solver
from pnpflow_tpu_torch.utils.config import load_full_config

# the shipped config/ tree, one level above the package
CONFIG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def batch_coupling(args):
    """Why ``args``' restoration couples the images of a batch, or None:
    the selector between the two ways ``shard=True`` fans a request out
    (the module notes)."""
    if args.method == "d_flow":
        return ("d_flow's dopri5 steps and LBFGS line search run over the "
                "whole batch")
    if (args.method == "pnp_gs" and args.algo == "hqs"
            and args.problem == "gaussian_deblurring_FFT"):
        return ("pnp_gs hqs deblurring backtracks its step size on the "
                "whole batch")
    if args.method == "ot_ode" and args.problem == "superresolution_bicubic":
        return "ot_ode's GMRES on bicubic SR runs over the whole batch"
    return None


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
                 output_root: str | None = None, devices=None):
        if not shard and (n_devices is not None or devices is not None):
            raise ValueError("n_devices and devices need shard=True")
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
        # where restore runs the one solver and its operator: here, or for
        # a coupled sharded restoration on the first device
        self.home, self.home_degradation = self.device, self.degradation
        self.shards = self.devices = None
        if shard:
            self._shard(batch_size, n_devices, devices)

    def _shard(self, batch_size, n_devices, devices):
        """One (solver, operator) per device, the first on this device; for
        a coupled restoration one solver and operator on the first device,
        its model the replicas behind a ``ShardedModel``."""
        devs = ([mesh.rank_device(d) for d in devices] if devices is not None
                else mesh.devices(n_devices, self.device))
        self.devices = devs
        models = mesh.replicate(self.bundle.model, devs)
        rows = mesh.batch_rows(batch_size, len(devs))
        if batch_coupling(self.args) is not None:
            b = ModelBundle(model=mesh.ShardedModel(models, devs,
                                                    self.bundle.remat),
                            device=devs[0], kind=self.bundle.kind,
                            remat=self.bundle.remat)
            self.solver = build_solver(b, self.args)
            self.home = devs[0]
            self.home_degradation = degradation_on(self.degradation, devs[0])
            return
        self.shards = []
        # a per-image mask is cut by the configured batch's shards
        for d, m, r in zip(devs, models, rows):
            b = ModelBundle(model=m, device=d, kind=self.bundle.kind,
                            remat=self.bundle.remat)
            self.shards.append((build_solver(b, self.args),
                                degradation_on(self.degradation, d, r)))

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
        the solver's randomness, as the batch index does in the CLI.
        Sharded, the batch is split over the devices (for a coupled
        restoration, each forward's batch inside the one solver)."""
        if self.shards is None:
            noisy = torch.as_tensor(noisy, dtype=torch.float32,
                                    device=self.home)
            # coupled and sharded: the backward runs in this thread, since
            # the autograd engine's per-card threads would recompute one
            # checkpoint (a d_flow step) from two threads at once
            with (torch.autograd.set_multithreading_enabled(False)
                  if self.devices is not None else contextlib.nullcontext()):
                return self._solve(self.solver, self.home_degradation,
                                   noisy, seed).numpy()
        noisy = torch.as_tensor(noisy, dtype=torch.float32)
        total = noisy.shape[0]
        rows = mesh.batch_rows(total, len(self.devices))
        parts = mesh.shard_batch(noisy, self.devices)

        def run(k, part):
            solver, deg = self.shards[k]
            solver.rows = (*rows[k], total)
            with mesh.on(self.devices[k]):
                return self._solve(solver, deg, part, seed)

        # flow_priors takes JVPs: its shards run one after the other
        return torch.cat(mesh.fan_out(
            run, parts, threads=self.args.method != "flow_priors")).numpy()

    def _solve(self, solver, degradation, noisy, seed):
        if self.args.method == "pnp_gs":
            # each request starts from args.alpha, not from the alpha that
            # an earlier request's backtracking shrank
            solver._alpha_carry = float(self.args.alpha)
        with solver.grad_mode():
            out, _ = solver.solve_batch(
                noisy, noisy, degradation, self.sigma_noise, int(seed))
        return out.float().cpu()

    def warmup(self, batch_size: int | None = None):
        """One restoration of zeros, before traffic."""
        bs = batch_size or int(self.args.batch_size_ip)
        self.restore(np.zeros((bs, self.args.dim_image, self.args.dim_image,
                               self.args.num_channels), np.float32))
        return self
