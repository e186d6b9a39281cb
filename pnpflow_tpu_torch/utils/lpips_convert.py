"""Converter: torch ``lpips`` package weights -> ``lpips_alex.npz`` (port of
``pnpflow_tpu/utils/lpips_convert.py``; the file both packages read).

The reference scores LPIPS with ``lpips.LPIPS(net='alex')``
(pnpflow/utils.py:677-724).  Run this where the ``lpips`` package (or its
checkpoint files) is available:

    python -m pnpflow_tpu_torch.utils.lpips_convert [out.npz]

Where no LPIPS checkpoint is at hand (no network), ``--synthetic [out.npz]``
writes seeded random weights of the same shapes (:func:`synthetic_weights`):
the distance then exercises the whole LPIPS path, but its values are not
comparable to published LPIPS scores.

Layout: ``conv{i}_w`` (kh, kw, in, out), ``conv{i}_b`` (out,), ``lin{i}_w``
(C,): the LPIPS heads are non-negative 1x1 convs, stored as dense vectors.
"""

from __future__ import annotations

import sys

import numpy as np


def convert_from_lpips_module(out_path: str = "model/lpips_alex.npz"):
    import lpips as lpips_pkg  # only needed for this conversion

    net = lpips_pkg.LPIPS(net="alex")
    weights = {}
    convs = [m for s in (net.net.slice1, net.net.slice2, net.net.slice3,
                         net.net.slice4, net.net.slice5) for m in s]
    conv_idx = 0
    for m in convs:
        if m.__class__.__name__ == "Conv2d":
            w = m.weight.detach().cpu().numpy()
            weights[f"conv{conv_idx}_w"] = np.transpose(w, (2, 3, 1, 0))
            weights[f"conv{conv_idx}_b"] = m.bias.detach().cpu().numpy()
            conv_idx += 1
    for i, lin in enumerate(net.lins):
        w = lin.model[-1].weight.detach().cpu().numpy()  # (1, C, 1, 1)
        weights[f"lin{i}_w"] = w.reshape(-1)
    np.savez(out_path, **weights)
    print("wrote", out_path, "({} conv layers)".format(conv_idx))


def convert_from_state_dicts(alexnet_sd, lpips_sd,
                             out_path: str = "model/lpips_alex.npz"):
    """Convert from raw state dicts (torchvision ``alexnet.features.*`` and
    the lpips ``lin{i}.model.1.weight`` heads) without the lpips package."""
    weights = {}
    conv_keys = sorted(
        {k.rsplit(".", 1)[0] for k in alexnet_sd
         if k.startswith("features") and k.endswith(".weight")},
        key=lambda s: int(s.split(".")[1]),
    )
    for i, base in enumerate(conv_keys):
        w = np.asarray(alexnet_sd[base + ".weight"], np.float32)
        weights[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0))
        weights[f"conv{i}_b"] = np.asarray(alexnet_sd[base + ".bias"],
                                           np.float32)
    for i in range(5):
        weights[f"lin{i}_w"] = np.asarray(
            lpips_sd[f"lin{i}.model.1.weight"], np.float32).reshape(-1)
    np.savez(out_path, **weights)


def synthetic_weights(seed: int = 0) -> dict:
    """Seeded random LPIPS weights in the npz layout: He-scaled convs,
    small biases, non-negative heads drawn from U[0, 1)."""
    rng = np.random.default_rng(seed)
    weights, cin = {}, 3
    for i, (cout, k) in enumerate(((64, 11), (192, 5), (384, 3), (256, 3),
                                   (256, 3))):
        fan_in = cin * k * k
        weights[f"conv{i}_w"] = (rng.normal(size=(k, k, cin, cout))
                                 * np.sqrt(2.0 / fan_in)).astype(np.float32)
        weights[f"conv{i}_b"] = (0.01 * rng.normal(size=cout)).astype(
            np.float32)
        weights[f"lin{i}_w"] = rng.uniform(size=cout).astype(np.float32)
        cin = cout
    return weights


def main(argv):
    if argv and argv[0] == "--synthetic":
        out = argv[1] if len(argv) > 1 else "model/lpips_alex.npz"
        np.savez(out, **synthetic_weights(0))
        print("wrote", out, "(synthetic seeded weights)")
        return
    convert_from_lpips_module(argv[0] if argv else "model/lpips_alex.npz")


if __name__ == "__main__":
    main(sys.argv[1:])
