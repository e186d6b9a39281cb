#!/usr/bin/env python3
"""How far d_flow's restoration moves under float rounding, unsharded and
sharded, on the card or the CPU.

    python3 scripts/torch_d_flow_spread.py [--device cpu] [--dim 64]
        [--problem gaussian_deblurring_FFT] [--lbfgs-iter 1]
        [--steps-euler 3] [--scale 1.0]

The flagship U-Net (``fused_norm`` True) with every parameter random
(weights ~ ``scale`` / sqrt(fan_in)), 4 images, fp32, cuDNN deterministic,
``max_iter 1``.  Each spread is a max-abs difference relative to the max of
what it compares; e is a standard normal draw:

* ``inversion_spread``: the dopri5 inversion of H_adj(y) against the same
  inversion of H_adj(y (1 + 1e-7 e)), and its evaluations;
* ``restore_spread``: the unsharded restore of y (1 + 1e-7 e) against that
  of y;
* ``lbfgs_spread``: LBFGS and the flow from the unsharded run's latent
  times (1 + 1e-7 e) against the unsharded restore;
* ``sharded``: ``Restorer(shard=True)`` with two shards on the first device
  against the unsharded ``Restorer`` (the whole restore), and from the
  unsharded run's latent (``sharded_from_one_latent``).

Prints the card's name and power limit (on the card), then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def randomize(torch, module, scale, seed=41):
    """GroupNorm scales near 1, biases small, weights ~ scale/sqrt(fan_in):
    at scale 1 and seed 41 the weights of ``chip_smoke.py``'s coupled
    phase (``randomized_unet``)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1 and ("norm" in name or name.startswith(
                    "end_conv.0")) and name.endswith("weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(scale * torch.randn(p.shape, generator=g)
                        / p[0].numel() ** 0.5)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--problem", default="gaussian_deblurring_FFT")
    ap.add_argument("--lbfgs-iter", type=int, default=1)
    ap.add_argument("--steps-euler", type=int, default=3)
    ap.add_argument("--scale", type=float, default=1.0)
    a = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from pnpflow_tpu_torch.models.registry import (
        checkpoint_paths, model_fingerprint, save_params_file)
    from pnpflow_tpu_torch.ops.ode import odeint_dopri5_stats
    from pnpflow_tpu_torch.parallel.mesh import devices
    from pnpflow_tpu_torch.serve import Restorer
    from pnpflow_tpu_torch.solvers import d_flow
    from pnpflow_tpu_torch.utils.jax_params import flax_from_state_dict

    if torch.device(a.device).type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    torch.backends.cudnn.deterministic = True
    kw = dict(method="d_flow", problem=a.problem, dim_image=a.dim,
              batch_size=4, device=a.device,
              overrides={"max_iter": 1, "LBFGS_iter": a.lbfgs_iter,
                         "steps_euler": a.steps_euler})
    g = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory() as root:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the random-init warning
            plain = Restorer(**kw, output_root=root)
        m = plain.bundle.model
        randomize(torch, m, a.scale)
        save_params_file(flax_from_state_dict(m.state_dict()),
                         checkpoint_paths(plain.args)["msgpack"],
                         fingerprint=model_fingerprint(m, plain.args))
        dev = devices(1, a.device)[0]
        sharded = Restorer(**kw, output_root=root, shard=True,
                           devices=[dev, dev])
        clean = torch.from_numpy(np.tanh(np.random.default_rng(7).normal(
            size=(4, a.dim, a.dim, 3))).astype(np.float32))
        y = plain.degrade(clean, seed=4)

        def wiggle(x):
            return x * (1.0 + 1e-7 * torch.randn(x.shape, generator=g)
                        .to(x.device))

        starts, solve = [], d_flow.lbfgs_solve

        def record(loss_fn, z, **kw):
            starts.append(z.detach().clone())
            return solve(loss_fn, z, **kw)

        d_flow.lbfgs_solve = record
        want = torch.from_numpy(plain.restore(y, seed=5))
        d_flow.lbfgs_solve = solve
        top = float(want.abs().max())

        def rel(x):
            return float((x.float().cpu() - want).abs().max()) / top

        def field(z, t):
            return m(z, torch.full((z.shape[0],), t, device=z.device))

        out = {"device": str(dev), "dim": a.dim, "problem": a.problem,
               "lbfgs_iter": a.lbfgs_iter, "steps_euler": a.steps_euler,
               "scale": a.scale}
        with torch.no_grad():
            z0, nfe = odeint_dopri5_stats(field, plain.degradation.H_adj(y),
                                          1.0, 0.0, rtol=1e-5, atol=1e-5)
            z1, _ = odeint_dopri5_stats(field, plain.degradation.H_adj(
                wiggle(y)), 1.0, 0.0, rtol=1e-5, atol=1e-5)
        out["inversion_nfe"] = nfe
        out["inversion_spread"] = float((z1 - z0).abs().max()
                                        / z0.abs().max())

        def from_latent(r, z):
            with r.solver.grad_mode(), \
                    torch.autograd.set_multithreading_enabled(False):
                return r.solver.solve_batch(None, y, r.home_degradation,
                                            r.sigma_noise, 5, z_init=z)[0]

        out["restore_spread"] = rel(torch.from_numpy(
            plain.restore(wiggle(y), seed=5)))
        out["lbfgs_spread"] = rel(from_latent(plain, wiggle(starts[0])))
        out["sharded"] = rel(torch.from_numpy(sharded.restore(y, seed=5)))
        out["sharded_wrapper_forwards"] = sharded.solver.model.model.forwards
        out["sharded_from_one_latent"] = rel(from_latent(sharded, starts[0]))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
