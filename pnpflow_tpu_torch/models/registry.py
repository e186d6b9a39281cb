"""Model factory + checkpoint resolution (port of
``pnpflow_tpu/models/registry.py``).

``define_model(args)`` builds the velocity U-Net for the ``ot`` / ``indep`` /
``gradient_step`` models; ``build_model_bundle(args)`` also resolves its
weights: a reference torch ``model_final.pt``, else a seeded random init
with a warning.

The GroupNorm path comes from ``--opts fused_norm ...`` and defaults to
``"conv"`` here (the JAX package defaults to ``False``): ``False`` runs no
kernel of this repository on the card, while ``"conv"`` sends every
ResidualBlock through the fused ``conv3x3_gn`` kernel.
"""

from __future__ import annotations

import os
import warnings

import torch

from pnpflow_tpu_torch.device import resolve_device
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.solvers.base import ModelBundle


def define_model(args, dtype=torch.float32) -> VelocityUNet:
    if args.model not in ("ot", "indep", "gradient_step"):
        raise NotImplementedError(
            f"model {args.model!r} is not ported yet (ROADMAP queue 1, "
            "items 10-14)")
    if args.dim_image % 8 == 0:
        ch_mult, attn = (1, 2, 4, 8), (16, 8)
    else:
        # e.g. MNIST 28x28 (28 % 8 != 0): drop the deepest level
        ch_mult, attn = (1, 2, 4), (14, 7)
    return VelocityUNet(
        input_channels=args.num_channels, input_height=args.dim_image,
        ch=32, ch_mult=ch_mult, num_res_blocks=6, attn_resolutions=attn,
        dtype=dtype, fused_norm=getattr(args, "fused_norm", "conv"),
    )


def checkpoint_paths(args):
    base = os.path.join(args.output_root, "model", args.dataset, args.model)
    return {
        "msgpack": os.path.join(base, "model_final.msgpack"),
        "torch": os.path.join(base, "model_final.pt"),
    }


def load_params(module, args):
    """Resolve weights in place: native msgpack (not ported: raises) >
    torch ``.pt`` (reference layout) > seeded random init."""
    paths = checkpoint_paths(args)
    if os.path.exists(paths["msgpack"]):
        raise NotImplementedError(
            f"{paths['msgpack']}: reading the JAX msgpack checkpoint is not "
            "ported yet (ROADMAP queue 1, item 2); convert it to a .pt "
            "state_dict or move it aside")
    if os.path.exists(paths["torch"]):
        sd = torch.load(paths["torch"], map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model_state_dict" in sd:
            sd = sd["model_state_dict"]
        module.load_state_dict(sd)
        return module
    warnings.warn(
        "No checkpoint found for {}/{} — using random init".format(
            args.dataset, args.model))
    return init_weights(module, seed=int(getattr(args, "seed", 0) or 0))


def build_model_bundle(args, dtype=torch.float32, device=None) -> ModelBundle:
    """U-Net with resolved weights on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    module = load_params(define_model(args, dtype=dtype), args)
    return ModelBundle(model=module.to(dev).eval(), device=dev)
