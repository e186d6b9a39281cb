"""Carry ``VelocityUNet`` / ``NCSNpp`` parameters and Adam state between
the JAX package's flax trees and the port's ``state_dict`` layout.

:func:`state_dict_from_flax` is the inverse of
``pnpflow_tpu/utils/torch_convert.py:convert_unet_state_dict``, and
:func:`ncsnpp_state_dict_from_flax` that of
``pnpflow_tpu/utils/ncsnpp_convert.py:convert_ncsnpp_state_dict``: a flax
tree (``{"params": ...}`` of numpy arrays) becomes a ``state_dict`` in the
reference torch layout that the port's modules use.
:func:`flax_from_state_dict` goes the other way for the U-Net (the port's
own copy of ``convert_unet_state_dict``'s mapping), and
:func:`flax_adam_state` / :func:`adam_state_dict_from_flax` carry
``torch.optim.Adam``'s moments to optax's ``adam`` state and back.
:func:`flax_from_ncsnpp_state_dict` is the NCSN++'s way back (the
``state.msgpack`` of ``rf_main``).
:func:`diffunet_state_dict_from_flax` and :func:`flax_from_diffunet_state_dict`
carry the DiffUNet both ways, and :func:`ncsnv2_state_dict_from_flax` and
:func:`flax_from_ncsnv2_state_dict` the NCSN family (which JAX has no
converter for): their torch names are the flax module paths joined by dots,
so only the leaves change.

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



def flax_from_ncsnpp_state_dict(sd) -> dict:
    """The inverse of :func:`ncsnpp_state_dict_from_flax`: the port's
    NCSN++ ``state_dict`` (``all_modules.{i}.<path>``) -> the JAX
    ``NCSNpp``'s ``{"params": tree}`` of C-contiguous float32 numpy arrays,
    module ``all_modules.{i}`` becoming ``m{i}``.  The ``sigmas`` buffer has
    no flax counterpart and is left out.  Raises on any other key."""
    tree: dict = {}
    for key, value in sd.items():
        if key == "sigmas":
            continue
        parts = key.split(".")
        if parts[0] != "all_modules" or not parts[1].isdigit():
            raise KeyError(f"unrecognized NCSN++ parameter {key!r}")
        v = value.detach().float().cpu().numpy()
        path, leaf = ["m" + parts[1]] + parts[2:-1], parts[-1]
        if path[-1] == "Conv2d_0":    # a FIR resampler's own conv leaves
            path, leaf = path[:-1], "Conv2d_0_" + leaf
            v = v.transpose(2, 3, 1, 0) if leaf.endswith("weight") else v
        elif leaf not in ("W", "b"):
            leaf, v = _flax_leaf(leaf, v)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v)
    return {"params": tree}


# NCSN-family leaves that keep their flax name and layout
_NCSN_PLAIN = ("alpha", "gamma", "beta", "embed")


def ncsnv2_state_dict_from_flax(params) -> dict:
    """A JAX ``NCSN`` / ``NCSNv2*`` ``{"params": tree}`` (or the bare tree)
    -> the port's ``state_dict``: the port's modules carry the flax names,
    so a path becomes dotted; a conv ``kernel`` (kH, kW, I, O) becomes an
    (O, I, kH, kW) ``weight``, a GroupNorm ``scale`` its weight; the norms'
    ``alpha`` / ``gamma`` / ``beta`` and class tables ``embed`` carry over
    as they are.  The ``sigmas`` buffer is the module's own."""
    tree = params.get("params", params)
    out = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, dict):
                walk(child, path + (name,))
                continue
            if name in _NCSN_PLAIN:
                key, arr = name, np.asarray(child, dtype=np.float32)
            else:
                key, arr = _leaf(name, child)
            out[".".join(path + (key,))] = torch.from_numpy(np.array(arr))

    walk(tree, ())
    return out


def flax_from_ncsnv2_state_dict(sd) -> dict:
    """The inverse of :func:`ncsnv2_state_dict_from_flax` (``sigmas`` left
    out)."""
    tree: dict = {}
    for key, value in sd.items():
        if key == "sigmas":
            continue
        prefix, leaf = key.rsplit(".", 1)
        v = value.detach().float().cpu().numpy()
        name, arr = (leaf, v) if leaf in _NCSN_PLAIN else _flax_leaf(leaf, v)
        node = tree
        for p in prefix.split("."):
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": tree}

def diffunet_state_dict_from_flax(params) -> dict:
    """flax DiffUNet ``{"params": tree}`` (or the bare tree) -> the port's
    ``state_dict``: ``down_0_res_0/in_conv/kernel`` becomes
    ``down_0_res_0.in_conv.weight`` (OIHW), a Dense ``(in, out)`` kernel a
    Linear ``(out, in)`` weight, a GroupNorm ``scale`` its weight."""
    tree = params.get("params", params)
    out = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, dict):
                walk(child, path + (name,))
                continue
            if not path:
                raise KeyError(f"DiffUNet leaf {name!r} outside a module")
            key, arr = _leaf(name, child)
            out[".".join(path + (key,))] = torch.from_numpy(np.array(arr))

    walk(tree, ())
    return out


def flax_from_diffunet_state_dict(sd) -> dict:
    """The inverse of :func:`diffunet_state_dict_from_flax`: the JAX
    DiffUNet's ``{"params": tree}`` of C-contiguous float32 numpy arrays."""
    tree: dict = {}
    for key, value in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        name, arr = _flax_leaf(leaf, value.detach().float().cpu().numpy())
        node = tree
        for p in prefix.split("."):
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": tree}


# ---------------------------------------------------------- port -> flax
_FIXED_TO_FLAX = {
    "begin_conv": ("begin_conv",), "end_conv.0": ("end_norm",),
    "end_conv.2": ("end_conv",), "temb_net.main.0": ("temb_net", "dense_0"),
    "temb_net.main.2": ("temb_net", "dense_1"),
}
_MID = {"0": "mid_block_0", "1": "mid_attn", "2": "mid_block_1"}


def _flax_path(key: str) -> tuple:
    """A U-Net ``state_dict`` key -> the flax module path of its leaf's
    module (the leaf name is added by :func:`_flax_leaf`)."""
    prefix, leaf = key.rsplit(".", 1)
    if prefix in _FIXED_TO_FLAX:
        return _FIXED_TO_FLAX[prefix], leaf
    parts = prefix.split(".")
    if parts[0] == "mid_modules" and len(parts) == 3:
        return (_MID[parts[1]], parts[2]), leaf
    if parts[0] in ("down_modules", "up_modules"):
        side = parts[0][:-len("_modules")]
        m = re.fullmatch(r"(\d+)a_(\d+)(a_block|b_attn)", parts[2])
        if m and len(parts) == 4:
            kind = "block" if m.group(3) == "a_block" else "attn"
            return (f"{side}_{m.group(1)}_{kind}_{m.group(2)}",
                    parts[3]), leaf
        m = re.fullmatch(r"(\d+)b_(downsample|upsample)", parts[2])
        if m and parts[3:] == (["up_conv"] if side == "up" else []):
            return (f"{side}_{m.group(1)}_{m.group(2)}", "conv"), leaf
    raise KeyError(f"unrecognized U-Net parameter {key!r}")


def _flax_leaf(leaf: str, v: np.ndarray) -> tuple:
    if leaf == "bias":
        return "bias", v
    if leaf != "weight":
        raise KeyError(f"unknown parameter leaf {leaf!r}")
    if v.ndim == 4:
        return "kernel", v.transpose(2, 3, 1, 0)
    if v.ndim == 2:
        return "kernel", v.T
    return "scale", v


def flax_from_state_dict(sd) -> dict:
    """The port's U-Net ``state_dict`` (or any tree of tensors with its keys,
    such as Adam's moments) -> the JAX ``VelocityUNet``'s ``{"params":
    tree}`` of C-contiguous float32 numpy arrays.  Raises on any
    unrecognized key."""
    tree: dict = {}
    for key, value in sd.items():
        path, leaf = _flax_path(key)
        name, arr = _flax_leaf(leaf, value.detach().float().cpu().numpy())
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if name in node:
            raise KeyError(f"two parameters map to {path + (name,)}")
        node[name] = np.ascontiguousarray(arr)
    return {"params": tree}


# ------------------------------------------------------------ Adam state
def flax_adam_state(optimizer: torch.optim.Adam, names) -> dict:
    """``torch.optim.Adam``'s state for parameters ``names`` (in the order of
    its one parameter group) -> the state dict of optax's ``adam`` state
    ``(ScaleByAdamState(count, mu, nu), EmptyState())``:
    ``{"0": {"count", "mu", "nu"}, "1": {}}``, with ``mu`` / ``nu`` in the
    params' flax layout.  Before the first step: count 0, zero moments."""
    (group,) = optimizer.param_groups
    if len(group["params"]) != len(names):
        raise ValueError(f"{len(names)} names for "
                         f"{len(group['params'])} parameters")
    mu, nu, counts = {}, {}, set()
    for name, p in zip(names, group["params"]):
        st = optimizer.state.get(p, {})
        counts.add(int(st["step"]) if st else 0)
        mu[name] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
    if len(counts) != 1:
        raise ValueError(f"parameters at different Adam steps: {counts}")
    return {"0": {"count": np.array(counts.pop(), np.int32),
                  "mu": flax_from_state_dict(mu),
                  "nu": flax_from_state_dict(nu)},
            "1": {}}


def adam_state_dict_from_flax(tree: dict, optimizer: torch.optim.Adam,
                              names) -> dict:
    """The inverse of :func:`flax_adam_state`: a ``state_dict`` for
    ``optimizer.load_state_dict``.  Raises ``KeyError`` / ``ValueError`` on
    a tree that does not fit the optimizer's parameters."""
    if set(tree) != {"0", "1"} or tree["1"] or set(tree["0"]) != {
            "count", "mu", "nu"}:
        raise ValueError("not an optax adam state: keys "
                         f"{sorted(tree)}")
    adam = tree["0"]
    mu, nu = state_dict_from_flax(adam["mu"]), state_dict_from_flax(adam["nu"])
    step = float(np.asarray(adam["count"]))
    sd = optimizer.state_dict()
    (group,) = sd["param_groups"]
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError("Adam moments do not name the model's parameters")
    params = optimizer.param_groups[0]["params"]
    state = {}
    for idx, name, p in zip(group["params"], names, params):
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"{name}: moment shape {tuple(mu[name].shape)} "
                             f"vs parameter {tuple(p.shape)}")
        state[idx] = {"step": torch.tensor(step, dtype=torch.float32),
                      "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    return {"state": state, "param_groups": sd["param_groups"]}
