"""Converter: pytorch-fid InceptionV3 weights -> ``inception_fid.npz``
(port of ``pnpflow_tpu/utils/inception_convert.py``; both packages read the
file it writes).

The reference downloads the ``pt_inception-2015-12-05`` checkpoint
(pnpflow/models.py:501).  Run this where that file is available:

    python -m pnpflow_tpu_torch.utils.inception_convert pt_inception.pth [out]

or, with no checkpoint at hand, write the deterministic random-init
weights of :func:`synthetic_state_dict` (the same arrays as the JAX
package's for the same seed):

    python -m pnpflow_tpu_torch.utils.inception_convert --synthetic [out]

Output: flat npz with ``block/.../leaf`` keys that
``models/inception.load_inception_params`` re-nests, and a ``provenance``
string.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# our block name -> torch module prefix
_TOP = {
    "c1": "Conv2d_1a_3x3", "c2": "Conv2d_2a_3x3", "c3": "Conv2d_2b_3x3",
    "c4": "Conv2d_3b_1x1", "c5": "Conv2d_4a_3x3",
    "a1": "Mixed_5b", "a2": "Mixed_5c", "a3": "Mixed_5d",
    "b": "Mixed_6a",
    "c_1": "Mixed_6b", "c_2": "Mixed_6c", "c_3": "Mixed_6d", "c_4": "Mixed_6e",
    "d": "Mixed_7a",
    "e1": "Mixed_7b", "e2": "Mixed_7c",
}

# our sub-conv name -> torch branch name, per block family
_SUBS = {
    "a": {
        "b1x1": "branch1x1", "b5_1": "branch5x5_1", "b5_2": "branch5x5_2",
        "b3_1": "branch3x3dbl_1", "b3_2": "branch3x3dbl_2",
        "b3_3": "branch3x3dbl_3", "bpool": "branch_pool",
    },
    "b": {
        "b3": "branch3x3", "bd_1": "branch3x3dbl_1",
        "bd_2": "branch3x3dbl_2", "bd_3": "branch3x3dbl_3",
    },
    "c": {
        "b1x1": "branch1x1", "b7_1": "branch7x7_1", "b7_2": "branch7x7_2",
        "b7_3": "branch7x7_3", "bd_1": "branch7x7dbl_1",
        "bd_2": "branch7x7dbl_2", "bd_3": "branch7x7dbl_3",
        "bd_4": "branch7x7dbl_4", "bd_5": "branch7x7dbl_5",
        "bpool": "branch_pool",
    },
    "d": {
        "b3_1": "branch3x3_1", "b3_2": "branch3x3_2",
        "b7_1": "branch7x7x3_1", "b7_2": "branch7x7x3_2",
        "b7_3": "branch7x7x3_3", "b7_4": "branch7x7x3_4",
    },
    "e": {
        "b1x1": "branch1x1", "b3_1": "branch3x3_1", "b3_2a": "branch3x3_2a",
        "b3_2b": "branch3x3_2b", "bd_1": "branch3x3dbl_1",
        "bd_2": "branch3x3dbl_2", "bd_3a": "branch3x3dbl_3a",
        "bd_3b": "branch3x3dbl_3b", "bpool": "branch_pool",
    },
}


def _family(block: str) -> str | None:
    if block.startswith("a"):
        return "a"
    if block == "b":
        return "b"
    if block.startswith("c_"):
        return "c"
    if block == "d":
        return "d"
    if block.startswith("e"):
        return "e"
    return None  # stem conv


def _conv_bn(sd, prefix):
    w = np.asarray(sd[prefix + ".conv.weight"], np.float32)
    return {
        "w": np.transpose(w, (2, 3, 1, 0)),
        "gamma": np.asarray(sd[prefix + ".bn.weight"], np.float32),
        "beta": np.asarray(sd[prefix + ".bn.bias"], np.float32),
        "mean": np.asarray(sd[prefix + ".bn.running_mean"], np.float32),
        "var": np.asarray(sd[prefix + ".bn.running_var"], np.float32),
    }


def convert_inception_state_dict(sd) -> dict:
    """Return flat {block/sub/leaf: array} ready for np.savez."""
    flat = {}
    for block, torch_top in _TOP.items():
        fam = _family(block)
        if fam is None:
            for leaf, val in _conv_bn(sd, torch_top).items():
                flat["{}/{}".format(block, leaf)] = val
        else:
            for sub, torch_branch in _SUBS[fam].items():
                prefix = "{}.{}".format(torch_top, torch_branch)
                for leaf, val in _conv_bn(sd, prefix).items():
                    flat["{}/{}/{}".format(block, sub, leaf)] = val
    # 1008-way classifier head (present in pt_inception-2015-12-05;
    # powers Inception Score — models/inception.inception_logits)
    if "fc.weight" in sd:
        flat["fc/w"] = np.transpose(
            np.asarray(sd["fc.weight"], np.float32), (1, 0)
        )
        flat["fc/b"] = np.asarray(sd["fc.bias"], np.float32)
    return flat


# ---------------------------------------------------------------------------
# Zero-egress fallback: deterministic random-init weights with the exact
# pt_inception architecture shapes.
#
# (prefix, in_ch, out_ch, (kh, kw)) for every conv in the FID InceptionV3
# (reference pnpflow/models.py:501-821: torchvision trunk + FID heads), in
# the order the synthetic weights draw them.


def _add(convs, prefix, cin, cout, k):
    convs.append((prefix, cin, cout, k if isinstance(k, tuple) else (k, k)))


def _table_block_a(convs, name, cin, pool):
    _add(convs, f"{name}.branch1x1", cin, 64, 1)
    _add(convs, f"{name}.branch5x5_1", cin, 48, 1)
    _add(convs, f"{name}.branch5x5_2", 48, 64, 5)
    _add(convs, f"{name}.branch3x3dbl_1", cin, 64, 1)
    _add(convs, f"{name}.branch3x3dbl_2", 64, 96, 3)
    _add(convs, f"{name}.branch3x3dbl_3", 96, 96, 3)
    _add(convs, f"{name}.branch_pool", cin, pool, 1)
    return 64 + 64 + 96 + pool


def _table_block_c(convs, name, cin, c7):
    _add(convs, f"{name}.branch1x1", cin, 192, 1)
    _add(convs, f"{name}.branch7x7_1", cin, c7, 1)
    _add(convs, f"{name}.branch7x7_2", c7, c7, (1, 7))
    _add(convs, f"{name}.branch7x7_3", c7, 192, (7, 1))
    _add(convs, f"{name}.branch7x7dbl_1", cin, c7, 1)
    _add(convs, f"{name}.branch7x7dbl_2", c7, c7, (7, 1))
    _add(convs, f"{name}.branch7x7dbl_3", c7, c7, (1, 7))
    _add(convs, f"{name}.branch7x7dbl_4", c7, c7, (7, 1))
    _add(convs, f"{name}.branch7x7dbl_5", c7, 192, (1, 7))
    _add(convs, f"{name}.branch_pool", cin, 192, 1)
    return 768


def _table_block_e(convs, name, cin):
    _add(convs, f"{name}.branch1x1", cin, 320, 1)
    _add(convs, f"{name}.branch3x3_1", cin, 384, 1)
    _add(convs, f"{name}.branch3x3_2a", 384, 384, (1, 3))
    _add(convs, f"{name}.branch3x3_2b", 384, 384, (3, 1))
    _add(convs, f"{name}.branch3x3dbl_1", cin, 448, 1)
    _add(convs, f"{name}.branch3x3dbl_2", 448, 384, 3)
    _add(convs, f"{name}.branch3x3dbl_3a", 384, 384, (1, 3))
    _add(convs, f"{name}.branch3x3dbl_3b", 384, 384, (3, 1))
    _add(convs, f"{name}.branch_pool", cin, 192, 1)
    return 2048


def _build_table() -> list:
    convs: list = []
    _add(convs, "Conv2d_1a_3x3", 3, 32, 3)
    _add(convs, "Conv2d_2a_3x3", 32, 32, 3)
    _add(convs, "Conv2d_2b_3x3", 32, 64, 3)
    _add(convs, "Conv2d_3b_1x1", 64, 80, 1)
    _add(convs, "Conv2d_4a_3x3", 80, 192, 3)
    c = _table_block_a(convs, "Mixed_5b", 192, 32)   # 256
    c = _table_block_a(convs, "Mixed_5c", c, 64)     # 288
    c = _table_block_a(convs, "Mixed_5d", c, 64)     # 288
    _add(convs, "Mixed_6a.branch3x3", c, 384, 3)
    _add(convs, "Mixed_6a.branch3x3dbl_1", c, 64, 1)
    _add(convs, "Mixed_6a.branch3x3dbl_2", 64, 96, 3)
    _add(convs, "Mixed_6a.branch3x3dbl_3", 96, 96, 3)
    c = 384 + 96 + c                           # 768
    c = _table_block_c(convs, "Mixed_6b", c, 128)
    c = _table_block_c(convs, "Mixed_6c", c, 160)
    c = _table_block_c(convs, "Mixed_6d", c, 160)
    c = _table_block_c(convs, "Mixed_6e", c, 192)
    _add(convs, "Mixed_7a.branch3x3_1", c, 192, 1)
    _add(convs, "Mixed_7a.branch3x3_2", 192, 320, 3)
    _add(convs, "Mixed_7a.branch7x7x3_1", c, 192, 1)
    _add(convs, "Mixed_7a.branch7x7x3_2", 192, 192, (1, 7))
    _add(convs, "Mixed_7a.branch7x7x3_3", 192, 192, (7, 1))
    _add(convs, "Mixed_7a.branch7x7x3_4", 192, 192, 3)
    c = 320 + 192 + c                          # 1280
    c = _table_block_e(convs, "Mixed_7b", c)
    c = _table_block_e(convs, "Mixed_7c", c)
    if c != 2048:
        raise AssertionError(f"the table ends at {c} channels, not 2048")
    return convs


def synthetic_state_dict(seed: int = 0) -> dict:
    """Deterministic random-init torch-layout state dict with the exact
    ``pt_inception-2015-12-05`` architecture shapes (incl. the 1008-way fc
    head).

    Used where the published checkpoint is unreachable (zero-egress
    environments): FID/KID/IS computed against these weights exercise the
    full metric protocol (resize, forward, statistics, estimators) with a
    fixed deterministic feature map, so values are self-consistent and
    reproducible across runs — but NOT comparable to published
    Inception-feature scores.  The npz records ``provenance`` so downstream
    readers can tell which weights produced a metrics line.
    """
    rng = np.random.default_rng(seed)
    sd = {}
    for prefix, cin, cout, (kh, kw) in _build_table():
        sd[prefix + ".conv.weight"] = (
            rng.normal(size=(cout, cin, kh, kw)).astype(np.float32) * 0.05
        )
        sd[prefix + ".bn.weight"] = np.ones(cout, np.float32)
        sd[prefix + ".bn.bias"] = np.zeros(cout, np.float32)
        sd[prefix + ".bn.running_mean"] = np.zeros(cout, np.float32)
        sd[prefix + ".bn.running_var"] = np.ones(cout, np.float32)
    sd["fc.weight"] = rng.normal(size=(1008, 2048)).astype(np.float32) * 0.02
    sd["fc.bias"] = np.zeros(1008, np.float32)
    return sd


def main(path, out="model/inception_fid.npz"):
    """Write ``out`` from the checkpoint at ``path``, or the synthetic
    weights when ``path`` is ``--synthetic``."""
    if path == "--synthetic":
        flat = convert_inception_state_dict(synthetic_state_dict())
        # compact token (no spaces): rides inside metrics.txt lines.
        # Meaning: published pt_inception unreachable (zero egress), weights
        # are the deterministic random init from synthetic_state_dict(0).
        flat["provenance"] = np.array("synthetic_random_init_seed0")
        np.savez(out, **flat)
        print("wrote", out, "(synthetic deterministic weights)")
        return
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    flat = convert_inception_state_dict(sd)
    flat["provenance"] = np.array("converted:" + os.path.basename(path))
    np.savez(out, **flat)
    print("wrote", out)


if __name__ == "__main__":
    main(sys.argv[1], *(sys.argv[2:3] or []))
