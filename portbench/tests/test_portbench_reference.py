"""The frozen plain reference against the port's plain path, and the
comparison's power: at a small size on the CPU the port in float32 agrees
with the reference far inside each restore cell's limits, and the port in
bfloat16 (the precision below) falls outside them."""

import numpy as np
import pytest
import torch

from pnpflow_tpu_torch.models.ncsnpp import NCSNpp as PortNCSNpp
from pnpflow_tpu_torch.models.registry import RectifiedAdapter
from pnpflow_tpu_torch.models.unet import VelocityUNet
from portbench import inputs
from portbench.drivers.pnp_restore import gap, meta_model, reference
from portbench.reference.pnp_flow import FFTBlur, PnPFlow
from portbench.tests.conftest import tiny_run

CELLS = ("restore-unet128-deblur", "restore-ncsnpp256-deblur")


def setup(cell, dtype):
    run = tiny_run(cell)
    cfg, traffic = run.config, {**run.traffic, "steps_pnp": 10}
    weights = inputs.make_weights(meta_model(run), cfg, 5, "cpu")
    if cfg["arch"] == "unet":
        port = VelocityUNet(input_height=cfg["image_size"], dtype=dtype)
    else:
        port = PortNCSNpp(image_size=cfg["image_size"], dtype=dtype)
    port.load_state_dict(weights, strict=False)
    if cfg["arch"] == "ncsnpp":
        port = RectifiedAdapter(port)
    ref = reference(run, meta_model(run), 5, "cpu")
    return cfg, traffic, run.limits, port.eval(), ref


@pytest.mark.parametrize("cell", CELLS)
def test_port_forward_matches_reference(cell):
    cfg, _, _, port, ref = setup(cell, torch.float32)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, cfg["image_size"], cfg["image_size"], 3, generator=g)
    t = torch.tensor([0.3, 0.9])
    with torch.no_grad():
        assert gap(port(x, t), ref(x, t)) < 1e-5


@pytest.mark.parametrize("dtype,agrees", [(torch.float32, True),
                                          (torch.bfloat16, False)])
@pytest.mark.parametrize("cell", CELLS)
def test_pnp_steps_hold_float32_and_refuse_bfloat16(cell, dtype, agrees):
    cfg, tr, limits, port, ref = setup(cell, dtype)
    blur = FFTBlur(tr["sigma_blur"], tr["kernel_size"], cfg["image_size"],
                   "cpu")
    g = torch.Generator().manual_seed(2)
    y = blur.H(inputs.clean_images(g, 1, cfg["image_size"], 3, "cpu"))
    with torch.no_grad():
        ours = PnPFlow(ref, blur, tr)
        theirs = PnPFlow(lambda x, t: port(x, t).float(), blur, tr)
        # the driver's start check: the states after the first step and
        # after the second report point
        a, b = {0: None, 2: None}, {0: None, 2: None}
        ours.run(y, ours.start(y), 3, 0, 2, a)
        theirs.run(y, theirs.start(y), 3, 0, 2, b)
    worst = max(gap(b[i], a[i]) for i in a)
    assert (worst <= limits["start_gap"]) is agrees, worst
