"""Scripted demo (port of the repository's ``demo/demo.py``, itself the
counterpart of the reference's ``demo/demo.ipynb``): train a small
flow-matching U-Net on synthetic images, sample it, then restore a
box-inpainting measurement with PnP-Flow, end to end with no external data
or checkpoints.

Run: ``python -m pnpflow_tpu_torch.demos.demo [--device cpu] [--epochs N]
[--steps-per-epoch N] [--pnp-steps N] [--out DIR]``; writes
``demo_restoration.png`` (with
matplotlib).  It runs on ``cuda`` unless ``--device`` says otherwise.  The
U-Net (32x32, ch 32, mult 1,2, two blocks, attention at 16) trains with
``fused_norm True``: every GroupNorm through the ``groupnorm_swish``
kernel on the card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pnpflow_tpu_torch.data import DataLoaders
from pnpflow_tpu_torch.device import resolve_device, set_fp32_parity_mode
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.ops.degradations import BoxInpainting
from pnpflow_tpu_torch.solvers.pnp_flow import make_pnp_flow_solver
from pnpflow_tpu_torch.training.flow_matching import (
    euler_sample, make_fm_train_step, new_state)

DIM = 32


def small_unet(channels: int = 3, dim: int = DIM, fused_norm=True):
    return VelocityUNet(input_channels=channels, input_height=dim, ch=32,
                        ch_mult=(1, 2), num_res_blocks=2,
                        attn_resolutions=(16,), fused_norm=fused_norm)


def psnr(a, b) -> float:
    mse = float((((a + 1) / 2 - (b + 1) / 2) ** 2).mean())
    return 10 * float(np.log10(1.0 / mse))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--steps-per-epoch", type=int, default=0,
                        help="0: the whole synthetic split (8 steps)")
    parser.add_argument("--pnp-steps", type=int, default=100)
    parser.add_argument("--out", default=".")
    cli = parser.parse_args(argv)
    dev = resolve_device(cli.device)
    set_fp32_parity_mode()

    print("1) building a small velocity U-Net ...")
    model = init_weights(small_unet(), 0).to(dev)

    print("2) flow-matching training on synthetic images ...")
    state = new_state(model, 2e-4)
    step = make_fm_train_step(coupling="ot", ot_method="sinkhorn")
    loaders = DataLoaders("synthetic", 32, 8, dim_image=DIM,
                          num_channels=3).load_data()
    gen = torch.Generator(device=dev).manual_seed(1)
    loss = float("nan")
    for epoch in range(cli.epochs):
        for i, (x1, _) in enumerate(loaders["train"]):
            if cli.steps_per_epoch and i >= cli.steps_per_epoch:
                break
            loss = step(state, torch.as_tensor(x1, device=dev), gen)
        print("   epoch", epoch, "loss", float(loss))

    print("3) sampling from the learned flow ...")
    model.load_state_dict(state.ema)
    model.eval()
    samples = euler_sample(model, (4, DIM, DIM, 3), steps=50,
                           generator=torch.Generator(device=dev)
                           .manual_seed(2), device=dev)
    print("   samples:", tuple(samples.shape))

    print("4) PnP-Flow restoration of a box-inpainting measurement ...")
    op = BoxInpainting(8, DIM, device=dev)
    clean, _ = next(iter(loaders["test"]))
    clean = torch.as_tensor(clean[:4], device=dev)
    noise_gen = torch.Generator(device=dev).manual_seed(3)
    y = op.H(clean) + 0.05 * torch.randn(clean.shape, generator=noise_gen,
                                         device=dev)
    solve = make_pnp_flow_solver(
        model, op.H, op.H_adj, steps=cli.pnp_steps, num_samples=3,
        lr_pnp=1.0, gamma_style="constant", alpha=1.0,
        noise_type="gaussian", sigma_noise=0.05)
    with torch.inference_mode():
        x = solve(y, op.H_adj(torch.ones_like(y)),
                  torch.Generator(device=dev).manual_seed(4), 0,
                  cli.pnp_steps)
    print("   PSNR noisy    {:.2f} dB".format(psnr(y, clean)))
    print("   PSNR restored {:.2f} dB".format(psnr(x, clean)))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("   matplotlib is not installed: no picture written")
        return x
    os.makedirs(cli.out, exist_ok=True)
    fig, axes = plt.subplots(3, 4, figsize=(10, 8))
    for col in range(4):
        for row, (img, title) in enumerate(
                [(clean, "clean"), (y, "masked+noise"), (x, "pnp_flow")]):
            axes[row][col].imshow(
                np.clip((img[col].float().cpu().numpy() + 1) / 2, 0, 1))
            axes[row][col].axis("off")
            if col == 0:
                axes[row][col].set_title(title, loc="left")
    fig.savefig(os.path.join(cli.out, "demo_restoration.png"), dpi=110)
    plt.close(fig)
    print("   wrote demo_restoration.png")
    return x


if __name__ == "__main__":
    main()
