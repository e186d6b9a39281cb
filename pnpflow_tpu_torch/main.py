"""CLI entry point (port of the repository's ``main.py``, eval path).

``python -m pnpflow_tpu_torch --opts key value ...`` solves an inverse
problem with the reference's 3-tier config, ``--opts`` overrides and
``results/{dataset}/{model}/{problem}/{method}/{split}`` layout.  It runs on
``cuda`` unless ``--opts device cpu`` is given.  ``--opts model rectified``
runs the NCSN++ (its FIR resampling through the ``upfirdn2d`` kernel);
``--opts bf16 True`` runs the model in bfloat16; the default float32 mode
turns TF32 off.

Training (``train True``) and ``compute_metrics True`` are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from pnpflow_tpu_torch.data import DataLoaders
from pnpflow_tpu_torch.device import resolve_device, set_fp32_parity_mode
from pnpflow_tpu_torch.models.registry import build_model_bundle
from pnpflow_tpu_torch.ops.degradations import make_degradation
from pnpflow_tpu_torch.solvers.factory import build_solver
from pnpflow_tpu_torch.utils.config import load_full_config


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Main")
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    cli = parser.parse_args(argv)
    return load_full_config(cli.opts)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(getattr(args, "device", None))

    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)

    if args.train:
        raise NotImplementedError(
            "training is not ported yet (ROADMAP queue 1, item 7)")
    if not args.eval:
        return

    bf16 = bool(getattr(args, "bf16", False))
    if not bf16:
        print("fp32 parity mode:", set_fp32_parity_mode())
    dtype = torch.bfloat16 if bf16 else torch.float32
    bundle = build_model_bundle(args, dtype=dtype, device=device)

    if args.compute_metrics:
        raise NotImplementedError(
            "compute_metrics is not ported yet (ROADMAP queue 1, item 12)")

    degradation, sigma_noise = make_degradation(args, device=device)
    print("Solving the {} inverse problem with the method {}...".format(
        args.problem, args.method))
    print("sigma_noise", sigma_noise)
    data_loaders = DataLoaders(
        args.dataset, args.batch_size_ip, args.batch_size_ip,
        root=os.path.join(args.root, "data"), dim_image=args.dim_image,
        num_channels=args.num_channels,
    ).load_data()

    results_dir = "results_laplace" if args.noise_type == "laplace" else "results"
    args.save_path = os.path.join(
        args.output_root, results_dir, args.dataset, args.model,
        args.problem, args.method, args.eval_split,
    )
    os.makedirs(args.save_path, exist_ok=True)

    method = build_solver(bundle, args)
    method.run_method(data_loaders, degradation, sigma_noise)
    return args


if __name__ == "__main__":
    main()
