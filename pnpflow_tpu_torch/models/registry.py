"""Model factory + checkpoint resolution (port of
``pnpflow_tpu/models/registry.py``).

``define_model(args)`` builds the velocity U-Net for the ``ot`` / ``indep``
models and for ``gradient_step`` (the gradient-step denoiser's network,
evaluated at t = sigma), the NCSN++ for ``rectified`` and the guided-diffusion
DiffUNet for ``diffusion`` (float32 whatever the dtype, as in JAX; it takes
the raw integer timestep, with no adapter); ``build_model_bundle(args)``
also resolves its weights, in the JAX order: a native ``model_final.msgpack``
(written by the JAX package or the port's trainers), then a reference torch
``model_final.pt``, else a seeded random init with a warning.  A ``.pt``
under ``model diffusion`` raises: JAX converts any ``.pt`` as a U-Net, which
gives the DiffUNet a wrong tree.

The GroupNorm path of the U-Net comes from ``--opts fused_norm ...``.  For
restoration it defaults to ``"conv"`` here (the JAX package defaults to
``False``): ``False`` runs no kernel of this repository on the card, while
``"conv"`` sends every ResidualBlock through the fused ``conv3x3_gn``
kernel.  ``"conv"`` is forward-only, so a model built for training
(``define_model(args, train=True)``, both trainers) or for a method that
differentiates through the model (``ot_ode``, ``flow_priors``, ``d_flow``,
and ``pnp_gs``, whose denoiser is a VJP of the U-Net) defaults to ``True``,
the ``groupnorm_swish`` kernel with its autograd backward and forward-mode
rule, and refuses ``"conv"``.  A ``train True eval True`` pnp_flow run
without ``fused_norm`` therefore trains with ``True`` and restores with
``"conv"``.

The msgpack reader and writer speak flax's format with the ``msgpack``
module alone: arrays are ext type 1 and numpy scalars ext type 3, each
packing ``(shape, dtype name, C-order bytes)``.  Any other ext type, and
flax's chunked large arrays, raise rather than guess.
:func:`save_params_file` writes what the JAX ``load_params`` reads: the
envelope ``{ARCH_KEY: fingerprint, "params": tree}``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn as nn

from pnpflow_tpu_torch.device import resolve_device
from pnpflow_tpu_torch.models.diffunet import (
    DiffUNet, init_diffunet, make_diffunet)
from pnpflow_tpu_torch.models.ncsnpp import NCSNpp, init_ncsnpp, make_ncsnpp
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.utils.jax_params import (
    diffunet_state_dict_from_flax, ncsnpp_state_dict_from_flax,
    state_dict_from_flax)

ARCH_KEY = "__pnpflow_arch__"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
MAX_LEAF_BYTES = 2 ** 30    # flax chunks larger arrays; the port does not
# the solvers that differentiate through the velocity model
DIFFERENTIATED_METHODS = ("ot_ode", "flow_priors", "d_flow", "pnp_gs")


def define_model(args, dtype=torch.float32, train: bool = False) -> nn.Module:
    """The model of ``args.model``.  ``train``, or a restoration ``method``
    of :data:`DIFFERENTIATED_METHODS`, selects the U-Net's default
    ``fused_norm True`` and refuses the forward-only ``"conv"``."""
    if args.model == "rectified":
        if train:
            raise NotImplementedError(
                "the CLI does not train the NCSN++: its trainer is "
                "python -m pnpflow_tpu_torch.rf_main --mode train")
        return make_ncsnpp(args, dtype=dtype)
    if args.model == "diffusion":
        if train:
            raise ValueError("the DiffUNet has no trainer: train 'ot', "
                             "'indep' or 'gradient_step'")
        return make_diffunet(args)
    if args.model not in ("ot", "indep", "gradient_step"):
        raise ValueError("Unknown model: {}".format(args.model))
    if args.dim_image % 8 == 0:
        ch_mult, attn = (1, 2, 4, 8), (16, 8)
    else:
        # e.g. MNIST 28x28 (28 % 8 != 0): drop the deepest level
        ch_mult, attn = (1, 2, 4), (14, 7)
    method = getattr(args, "method", None)
    differentiated = not train and method in DIFFERENTIATED_METHODS
    fused = getattr(args, "fused_norm",
                    True if train or differentiated else "conv")
    if train and fused == "conv":
        raise ValueError(
            'fused_norm "conv" is forward-only and cannot train: use False, '
            'True or "bm"')
    if differentiated and fused == "conv":
        raise ValueError(
            f'fused_norm "conv" is forward-only and method {method!r} '
            'differentiates through the model: use False, True or "bm"')
    return VelocityUNet(
        input_channels=args.num_channels, input_height=args.dim_image,
        ch=32, ch_mult=ch_mult, num_res_blocks=6, attn_resolutions=attn,
        dtype=dtype, fused_norm=fused,
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

    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    try:
        shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
        name = dtype_name.decode()
    except (TypeError, ValueError, AttributeError) as exc:
        raise ValueError(f"cannot decode msgpack ext type {code}: "
                         f"{exc}") from exc
    if name == "bfloat16":
        raw = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        arr = raw.float().numpy().reshape(shape)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape,
                                                               order="C")
    return arr[()] if code == _EXT_NPSCALAR else arr


def _ext_pack(obj):
    """flax's encoding of a numpy array (ext 1) or numpy scalar (ext 3)."""
    import msgpack

    if isinstance(obj, np.generic):
        code, arr = _EXT_NPSCALAR, np.asarray(obj)
    elif isinstance(obj, np.ndarray):
        code, arr = _EXT_NDARRAY, obj
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"an array of {arr.nbytes} bytes needs flax's "
                         "chunked encoding, which the port does not write")
    return msgpack.ExtType(code, msgpack.packb(
        (list(arr.shape), arr.dtype.name, arr.tobytes("C")),
        use_bin_type=True))


def write_msgpack(tree, path: str):
    """Write a tree of dicts, lists, Python scalars and numpy arrays in
    flax's msgpack format, atomically (a temporary file, then a rename)."""
    import msgpack

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blob = msgpack.packb(tree, default=_ext_pack, strict_types=True,
                         use_bin_type=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def save_params_file(params, path: str, fingerprint: dict | None = None):
    """Write a flax parameter tree (``{"params": ...}`` of numpy arrays) as
    the JAX ``save_params_file`` does: with ``fingerprint``, the envelope
    ``{ARCH_KEY: fingerprint, "params": tree}`` that the JAX and the port's
    ``load_params`` check against the model; without it, the raw tree."""
    payload = (params if fingerprint is None else
               {ARCH_KEY: _normalize_fp(fingerprint), "params": params})
    write_msgpack(payload, path)


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


def checked_state_dict(module, sd: dict) -> dict:
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
    if isinstance(module, DiffUNet):
        return diffunet_state_dict_from_flax(tree)
    return state_dict_from_flax(tree)


def _torch_state_dict(path: str) -> dict:
    """A ``.pt``/``.pth`` state_dict: the U-Net's own, a
    ``{"model_state_dict": ...}`` wrapper, or a RectifiedFlow
    ``{model, ema, optimizer, step}`` checkpoint (``module.`` stripped).
    Its ``model`` weights only: for the EMA weights convert it with
    ``python -m pnpflow_tpu_torch.utils.ncsnpp_convert --ema`` into
    ``model_final.msgpack``."""
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
    if isinstance(module, DiffUNet):
        return init_diffunet(module, seed=seed)
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
            sd = checked_state_dict(module,
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
        if isinstance(module, DiffUNet):
            # JAX converts any .pt with the U-Net's key map, which gives
            # the DiffUNet a wrong tree; the port refuses instead
            raise ValueError(
                f"{paths['torch']}: a torch checkpoint cannot be read for "
                "model diffusion; convert it to the JAX DiffUNet's tree and "
                f"save it as {paths['msgpack']}")
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
    """The model with resolved weights on ``device`` (default ``cuda``);
    ``--opts remat True`` sets the bundle's ``remat``."""
    dev = resolve_device(device)
    module = load_params(define_model(args, dtype=dtype), args)
    if args.model == "rectified":
        module = RectifiedAdapter(module)
    return ModelBundle(model=module.to(dev).eval(), device=dev,
                       kind=args.model,
                       remat=bool(getattr(args, "remat", False)))
