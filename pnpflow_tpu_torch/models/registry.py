"""Model factory + checkpoint resolution (port of
``pnpflow_tpu/models/registry.py``).

``define_model(args)`` builds the velocity U-Net for the ``ot`` / ``indep`` /
``gradient_step`` models and the NCSN++ for ``rectified``;
``build_model_bundle(args)`` also resolves its weights, in the JAX order:
a native ``model_final.msgpack`` (written by the JAX package), then a
reference torch ``model_final.pt``, else a seeded random init with a
warning.

The GroupNorm path of the U-Net comes from ``--opts fused_norm ...`` and
defaults to ``"conv"`` here (the JAX package defaults to ``False``):
``False`` runs no kernel of this repository on the card, while ``"conv"``
sends every ResidualBlock through the fused ``conv3x3_gn`` kernel.

The msgpack reader decodes flax's format with the ``msgpack`` module alone:
arrays are ext type 1, packing ``(shape, dtype name, C-order bytes)``.  Any
other ext type, and flax's chunked large arrays, raise rather than guess.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn as nn

from pnpflow_tpu_torch.device import resolve_device
from pnpflow_tpu_torch.models.ncsnpp import NCSNpp, init_ncsnpp, make_ncsnpp
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.utils.jax_params import (
    ncsnpp_state_dict_from_flax, state_dict_from_flax)

ARCH_KEY = "__pnpflow_arch__"
_EXT_NDARRAY = 1


def define_model(args, dtype=torch.float32) -> nn.Module:
    if args.model == "rectified":
        return make_ncsnpp(args, dtype=dtype)
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


def model_fingerprint(module, args) -> dict:
    """The architecture a checkpoint belongs to: {model, dim_image,
    num_channels} plus the fields the module exposes, as the JAX
    ``model_fingerprint`` computes it."""
    fp = {"model": str(args.model), "dim_image": int(args.dim_image),
          "num_channels": int(args.num_channels)}
    for field in ("ch", "nf", "ch_mult", "num_res_blocks",
                  "attn_resolutions"):
        if hasattr(module, field):
            v = getattr(module, field)
            fp[field] = ([int(e) for e in v] if isinstance(v, (tuple, list))
                         else int(v))
    return fp


def _normalize_fp(fp: dict) -> dict:
    return {k: ([int(e) for e in v] if isinstance(v, (tuple, list)) else v)
            for k, v in fp.items()}


def _ext_hook(code, data):
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raw = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return raw.float().numpy().reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _check_unchunked(tree, path="params"):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError(f"{path}: chunked msgpack arrays are not read")
        for k, v in tree.items():
            _check_unchunked(v, f"{path}/{k}")


def read_msgpack(path: str) -> tuple:
    """A flax msgpack checkpoint -> ``(tree, fingerprint or None)``.

    Accepts the envelope ``{ARCH_KEY: fingerprint, "params": state}`` that
    the JAX ``save_params_file`` writes and the legacy raw tree that its
    converter CLIs write.  Raises ``ValueError`` on what it cannot decode."""
    import msgpack

    with open(path, "rb") as f:
        blob = f.read()
    try:
        raw = msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False)
    except (msgpack.UnpackException, ValueError) as exc:
        raise ValueError(f"{path}: not a readable flax msgpack file "
                         f"({exc})") from exc
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: expected a parameter tree, got "
                         f"{type(raw).__name__}")
    _check_unchunked(raw)
    if ARCH_KEY in raw:
        return raw["params"], raw[ARCH_KEY]
    return raw, None


def _checked_state_dict(module, sd: dict) -> dict:
    """Raise ``ValueError`` unless ``sd`` has exactly the module's keys and
    shapes (so a failed load leaves the module untouched)."""
    want = module.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint keys differ: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(sd[k].shape)} "
                             f"vs model {tuple(v.shape)}")
    return sd


def _state_dict_from_tree(module, tree) -> dict:
    if isinstance(module, NCSNpp):
        return ncsnpp_state_dict_from_flax(tree, module.sigmas)
    return state_dict_from_flax(tree)


def _torch_state_dict(path: str) -> dict:
    """A ``.pt``/``.pth`` state_dict: the U-Net's own, a
    ``{"model_state_dict": ...}`` wrapper, or a RectifiedFlow
    ``{model, ema, optimizer, step}`` checkpoint (``module.`` stripped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    elif isinstance(sd, dict) and "model" in sd and "step" in sd:
        sd = sd["model"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def checkpoint_paths(args):
    base = os.path.join(args.output_root, "model", args.dataset, args.model)
    return {
        "msgpack": os.path.join(base, "model_final.msgpack"),
        "torch": os.path.join(base, "model_final.pt"),
    }


def _init(module, args):
    seed = int(getattr(args, "seed", 0) or 0)
    if isinstance(module, NCSNpp):
        return init_ncsnpp(module, seed=seed)
    return init_weights(module, seed=seed)


def load_params(module, args, require: bool = False):
    """Resolve weights in place: native msgpack > torch ``.pt`` > seeded
    random init.  A msgpack that does not fit the model, or whose stored
    fingerprint differs, raises with ``require`` and is otherwise skipped
    with a warning, as in the JAX ``load_params``."""
    paths = checkpoint_paths(args)
    if os.path.exists(paths["msgpack"]):
        tree, stored_fp = read_msgpack(paths["msgpack"])
        try:
            sd = _checked_state_dict(module,
                                     _state_dict_from_tree(module, tree))
        except (KeyError, ValueError) as exc:
            if require:
                raise
            warnings.warn(f"Checkpoint at {paths['msgpack']} does not match "
                          f"the current model configuration ({exc}) — "
                          "ignoring it.")
            sd = None
        if sd is not None:
            expected = _normalize_fp(model_fingerprint(module, args))
            if stored_fp is not None and _normalize_fp(stored_fp) != expected:
                msg = (f"Checkpoint at {paths['msgpack']} was saved for a "
                       f"different architecture: stored {stored_fp} vs "
                       f"expected {expected}.")
                if require:
                    raise ValueError(msg)
                warnings.warn(msg + " Ignoring it.")
            else:
                module.load_state_dict(sd)
                return module
    if os.path.exists(paths["torch"]):
        module.load_state_dict(_torch_state_dict(paths["torch"]))
        return module
    if require:
        raise FileNotFoundError(
            f"No checkpoint at {paths['msgpack']} or {paths['torch']}")
    warnings.warn(
        "No checkpoint found for {}/{} — using random init".format(
            args.dataset, args.model))
    return _init(module, args)


class RectifiedAdapter(nn.Module):
    """NCSN++ fed ``max(t, 1e-3) * 999``: the reference scales t by 999,
    and the floor (its own RF integration epsilon) keeps pnp_flow's first
    step, at t = 0, away from log(0) in the Fourier embedding and 0/0 in
    scale_by_sigma."""

    def __init__(self, model: NCSNpp):
        super().__init__()
        self.model = model

    def forward(self, x, t):
        return self.model(x, torch.clamp_min(t.float(), 1e-3) * 999.0)


def build_model_bundle(args, dtype=torch.float32, device=None) -> ModelBundle:
    """The model with resolved weights on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    module = load_params(define_model(args, dtype=dtype), args)
    if args.model == "rectified":
        module = RectifiedAdapter(module)
    return ModelBundle(model=module.to(dev).eval(), device=dev,
                       kind=args.model)
