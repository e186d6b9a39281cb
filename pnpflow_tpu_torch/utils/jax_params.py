"""Carry a JAX ``VelocityUNet`` or ``NCSNpp`` parameter tree into the port.

:func:`state_dict_from_flax` is the inverse of
``pnpflow_tpu/utils/torch_convert.py:convert_unet_state_dict``, and
:func:`ncsnpp_state_dict_from_flax` that of
``pnpflow_tpu/utils/ncsnpp_convert.py:convert_ncsnpp_state_dict``: a flax
tree (``{"params": ...}`` of numpy arrays) becomes a ``state_dict`` in the
reference torch layout that the port's modules use.

  flax Conv kernel (kH, kW, I, O) -> torch Conv2d weight (O, I, kH, kW)
  flax Dense kernel (in, out)     -> torch Linear weight (out, in)
  flax GroupNorm scale / bias     -> torch GroupNorm weight / bias
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _leaf(name: str, value) -> tuple:
    v = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        return "weight", v
    if name == "scale":
        return "weight", v
    if name == "bias":
        return "bias", v
    raise KeyError(f"unknown parameter leaf {name!r}")


def _module_prefix(name: str, num_levels: int) -> str:
    """flax module name -> torch module path (without the leaf)."""
    fixed = {
        "begin_conv": "begin_conv", "end_norm": "end_conv.0",
        "end_conv": "end_conv.2", "mid_block_0": "mid_modules.0",
        "mid_attn": "mid_modules.1", "mid_block_1": "mid_modules.2",
    }
    if name in fixed:
        return fixed[name]
    m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", name)
    if m:
        side, lev, kind, blk = m.groups()
        idx = lev if side == "down" else str(num_levels - 1 - int(lev))
        tag = "a_block" if kind == "block" else "b_attn"
        return f"{side}_modules.{idx}.{lev}a_{blk}{tag}"
    m = re.fullmatch(r"down_(\d+)_downsample", name)
    if m:
        lev = m.group(1)
        return f"down_modules.{lev}.{lev}b_downsample"
    m = re.fullmatch(r"up_(\d+)_upsample", name)
    if m:
        lev = m.group(1)
        return f"up_modules.{num_levels - 1 - int(lev)}.{lev}b_upsample.up_conv"
    raise KeyError(f"unrecognized flax module {name!r}")


def state_dict_from_flax(params) -> dict:
    """flax ``{"params": tree}`` (or the bare tree) -> torch ``state_dict``
    of float32 CPU tensors.  Raises on any unrecognized name."""
    tree = params.get("params", params)
    levels = [int(m.group(1)) for k in tree
              for m in [re.match(r"down_(\d+)_", k)] if m]
    num_levels = max(levels) + 1 if levels else 0
    out = {}
    for mod, sub in tree.items():
        if mod == "temb_net":
            for dense, idx in (("dense_0", "0"), ("dense_1", "2")):
                for leaf, value in sub[dense].items():
                    key, v = _leaf(leaf, value)
                    out[f"temb_net.main.{idx}.{key}"] = v
            continue
        prefix = _module_prefix(mod, num_levels)
        for name, value in sub.items():
            if isinstance(value, dict):  # a child module (conv, norm1, ...)
                child = "" if mod.endswith(("downsample", "upsample")) else (
                    name + ".")
                for leaf, v in value.items():
                    key, arr = _leaf(leaf, v)
                    out[f"{prefix}.{child}{key}"] = arr
            else:
                key, arr = _leaf(name, value)
                out[f"{prefix}.{key}"] = arr
    # np.array copies: leaves from JAX are read-only views
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _ncsnpp_leaf(name: str, value) -> tuple:
    """flax NCSN++ leaf -> (torch suffix, array): the inverse of
    ``pnpflow_tpu/utils/ncsnpp_convert.py:_translate_leaf``."""
    v = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        return "weight", v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
    if name == "scale":
        return "weight", v
    if name == "bias":
        return "bias", v
    if name == "Conv2d_0_weight":
        return "Conv2d_0.weight", v.transpose(3, 2, 0, 1)
    if name == "Conv2d_0_bias":
        return "Conv2d_0.bias", v
    if name in ("W", "b"):
        return name, v
    raise KeyError(f"unknown NCSN++ parameter leaf {name!r}")


def ncsnpp_state_dict_from_flax(params, sigmas=None) -> dict:
    """flax NCSN++ ``{"params": tree}`` (or the bare tree) -> torch
    ``state_dict`` in the reference layout (``all_modules.{i}.<path>``).

    Module ``m{i}`` becomes ``all_modules.{i}``; nested flax module names
    (``GroupNorm_0``, ``NIN_3``, ...) are kept.  The flax tree has no
    ``sigmas`` table; pass the module's (``model.sigmas``) to include it, so
    the result loads with ``load_state_dict(strict=True)``."""
    tree = params.get("params", params)
    out = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, dict):
                walk(child, path + (name,))
                continue
            if not path or not re.fullmatch(r"m\d+", path[0]):
                raise KeyError(f"unrecognized NCSN++ module {path + (name,)}")
            suffix, arr = _ncsnpp_leaf(name, child)
            key = ".".join(("all_modules", path[0][1:]) + path[1:] + (suffix,))
            out[key] = torch.from_numpy(np.array(arr))

    walk(tree, ())
    if sigmas is not None:
        out["sigmas"] = torch.as_tensor(sigmas, dtype=torch.float32).cpu()
    return out
