"""Convert a RectifiedFlow NCSN++ checkpoint to the msgpack both packages
read (port of ``pnpflow_tpu/utils/ncsnpp_convert.py``'s CLI).

    python -m pnpflow_tpu_torch.utils.ncsnpp_convert IN.pth OUT.msgpack \\
        [--ema] [--image-size 256] [--nf 128] ...

``IN.pth`` is the reference's ``{model, ema, optimizer, step}`` dict
(``image_generation/utils.py:7-23``) or a bare ``state_dict``; ``module.``
prefixes are dropped.  ``--ema`` takes the EMA's ``shadow_params``, which
list the trainable parameters in ``model.parameters()`` order: the
state-dict keys minus the ``sigmas`` buffer and the frozen Fourier
projection ``all_modules.0.W`` (reference ``models/ema.py:28-30``).  The
output is the raw flax tree ``{"params": ...}`` of the JAX ``NCSNpp``, as
the JAX converter writes it: ``rf_main``'s ``state.msgpack``, or a
``model_final.msgpack`` for ``--opts model rectified``.  The weights go
through the port's NCSN++ (``load_state_dict``, strict), so a checkpoint of
another architecture raises.
"""

from __future__ import annotations

import argparse

import torch


def _strip(sd: dict) -> dict:
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def checkpoint_state_dict(state, ema: bool = False) -> dict:
    """The NCSN++ ``state_dict`` of a loaded checkpoint: the model's, or
    with ``ema`` the model's keys filled from ``shadow_params``."""
    if not (isinstance(state, dict) and "model" in state):
        if ema:
            raise ValueError("--ema needs a {model, ema, ...} checkpoint")
        return _strip(state)
    sd = _strip(state["model"])
    if not ema:
        return sd
    if state.get("ema") is None:
        raise ValueError("--ema requested but the checkpoint's ema slot is "
                         "empty")
    names = [k for k in sd if k not in ("sigmas", "all_modules.0.W")]
    shadow = list(state["ema"]["shadow_params"])
    if len(names) != len(shadow):
        raise ValueError(f"{len(shadow)} EMA shadow parameters for "
                         f"{len(names)} trainable ones")
    return {**sd, **dict(zip(names, shadow))}


def main(argv=None):
    from pnpflow_tpu_torch.models.ncsnpp import NCSNpp
    from pnpflow_tpu_torch.models.registry import write_msgpack
    from pnpflow_tpu_torch.utils.jax_params import flax_from_ncsnpp_state_dict

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("pth_path", help="RectifiedFlow torch checkpoint (.pth)")
    p.add_argument("out", help="output msgpack path")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--num-channels", type=int, default=3)
    p.add_argument("--nf", type=int, default=128)
    p.add_argument("--ch-mult", type=int, nargs="+",
                   default=(1, 1, 2, 2, 2, 2, 2))
    p.add_argument("--num-res-blocks", type=int, default=2)
    p.add_argument("--attn-resolutions", type=int, nargs="+", default=(16,))
    p.add_argument("--ema", action="store_true",
                   help="convert the EMA shadow parameters instead of the "
                        "live weights")
    ns = p.parse_args(argv)

    state = torch.load(ns.pth_path, map_location="cpu", weights_only=True)
    sd = checkpoint_state_dict(state, ema=ns.ema)
    model = NCSNpp(image_size=ns.image_size, num_channels=ns.num_channels,
                   nf=ns.nf, ch_mult=tuple(ns.ch_mult),
                   num_res_blocks=ns.num_res_blocks,
                   attn_resolutions=tuple(ns.attn_resolutions))
    model.load_state_dict(sd)
    params = flax_from_ncsnpp_state_dict(model.state_dict())
    write_msgpack(params, ns.out)
    n = sum(v.numel() for k, v in model.state_dict().items()
            if k != "sigmas")
    print("wrote {} ({} parameters)".format(ns.out, n))


if __name__ == "__main__":
    main()
