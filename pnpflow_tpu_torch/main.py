"""CLI entry point (port of the repository's ``main.py``).

``python -m pnpflow_tpu_torch --opts key value ...`` trains a prior
(``train True``: the flow-matching velocity field for ``model ot`` or
``indep``, the gradient-step denoiser for ``model gradient_step``) and
solves an inverse problem (``eval True``) with any of the six methods
(``pnp_flow``, ``ot_ode``, ``flow_priors``, ``d_flow``, ``pnp_gs``,
``pnp_diff``), with the reference's 3-tier config, ``--opts`` overrides and
``results/{dataset}/{model}/{problem}/{method}/{split}`` layout, in that
order, as the JAX CLI does: a run with both restores with the
``model_final.msgpack`` it has just written.  It runs on ``cuda`` unless
``--opts device cpu`` is given.  Training is float32 with TF32 off, with
``fused_norm True`` by default; ``method pnp_gs`` restores with ``model
gradient_step`` and ``fused_norm True`` by default (its denoiser is a VJP of
the U-Net); ``--opts model rectified`` restores with the NCSN++ (its FIR
resampling through the ``upfirdn2d`` kernel) and ``model diffusion`` with
the DiffUNet (``method pnp_diff``, float32 always); ``--opts bf16 True``
restores in bfloat16, and the default float32 restoration turns TF32 off.
``compute_metrics True`` scores the prior before the restoration, as the
JAX CLI does: FID, KID, IS, Vendi and SW of ``metric_n`` (default 5000)
samples of the flow ODE (``metric_sampler``, default dopri5; ``metric_steps``
for the fixed-step samplers, default 100) against as many test images, on
the Inception features of ``{output_root}/model/inception_fid.npz`` or,
without that file, on 32x32 pixels (``metrics/generative.py``); with
``train True`` the trainer also writes the FID-5k curve.

``--opts data_backend grain`` reads the image-file datasets through
worker processes (``data/grain_loader.py``); ``ckpt_backend orbax`` keeps the
trainer's resume state in versioned step directories
(``training/checkpoint.py``); ``jax_profile <dir>`` writes a
``torch.profiler`` trace of the restoration run into ``<dir>``
(``solvers/base.py``).  Under ``torchrun --nproc_per_node N -m
pnpflow_tpu_torch --opts train True ...`` the trainers run data-parallel,
one card per rank (``parallel/mesh.py``); rank 0 alone writes, and alone
runs what follows training (``eval True``).
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from pnpflow_tpu_torch.data import DataLoaders
from pnpflow_tpu_torch.device import resolve_device, set_fp32_parity_mode
from pnpflow_tpu_torch.metrics.generative import ComputeMetric
from pnpflow_tpu_torch.models.registry import build_model_bundle
from pnpflow_tpu_torch.ops.degradations import make_degradation
from pnpflow_tpu_torch.parallel import mesh
from pnpflow_tpu_torch.solvers.factory import build_solver
from pnpflow_tpu_torch.training.denoiser import GradientStepTrainer
from pnpflow_tpu_torch.training.flow_matching import FlowMatchingTrainer
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
        train(args, device)
    if not args.eval or not mesh.is_writer():
        return args

    bf16 = bool(getattr(args, "bf16", False))
    if not bf16:
        print("fp32 parity mode:", set_fp32_parity_mode())
    dtype = torch.bfloat16 if bf16 else torch.float32
    bundle = build_model_bundle(args, dtype=dtype, device=device)

    if args.compute_metrics:
        print("Computing metrics...")
        # n = 5000 is the reference protocol (compute_metric.py:30)
        n_metric = int(getattr(args, "metric_n", 5000) or 5000)
        metric_steps = int(getattr(args, "metric_steps", 100) or 100)
        metric_loaders = DataLoaders(
            args.dataset, min(n_metric, 500), min(n_metric, 500),
            root=os.path.join(args.root, "data"), dim_image=args.dim_image,
            num_channels=args.num_channels, test_n=n_metric,
        ).load_data()
        args.metrics = ComputeMetric(metric_loaders, bundle, args)\
            .compute_metrics(n_metric, steps=metric_steps)
        print("Computing metrics done!")

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


def train(args, device):
    """Train the velocity field of ``model ot|indep``, or the gradient-step
    denoiser of ``model gradient_step``, in float32 on ``device`` (one card
    per rank where ``torchrun`` launched the process);
    ``args.train_stats`` gets what the trainer measured."""
    args.batch_size = args.batch_size_train
    if args.model not in ("ot", "indep", "gradient_step"):
        raise ValueError("Model not implemented yet: choose 'ot' or "
                         "'gradient_step'")
    if mesh.init_distributed(device):
        print("data parallel: rank {} of {}".format(mesh.rank(),
                                                    mesh.world_size()))
    device = mesh.rank_device(device)
    print("fp32 parity mode:", set_fp32_parity_mode())
    print("Training...")
    data_loaders = DataLoaders(
        args.dataset, args.batch_size_train, args.batch_size_train,
        root=os.path.join(args.root, "data"), dim_image=args.dim_image,
        num_channels=args.num_channels,
        backend=getattr(args, "data_backend", "thread"),
    ).load_data()
    trainer = (GradientStepTrainer if args.model == "gradient_step"
               else FlowMatchingTrainer)(args, device=device)
    trainer.train(data_loaders)
    args.train_stats = trainer.stats
    print("Training done!")


if __name__ == "__main__":
    main()
