"""One step of each trainer on one rank of a gloo process group: the
worker that ``tests/test_torch_parallel.py`` starts twice (``RANK`` 0 and 1,
``WORLD_SIZE`` 2).  It imports the port alone (no JAX), so it starts in
seconds.

    python tests/torch_dp_worker.py SPEC.npz OUT_PREFIX

``SPEC.npz`` holds the parameters (``p/<name>``), the global batch and the
draws; each rank writes ``OUT_PREFIX.<rank>.npz``.  :func:`run_steps` is
also what the test runs in one process on the whole batch.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from pnpflow_tpu_torch.models.unet import VelocityUNet  # noqa: E402
from pnpflow_tpu_torch.parallel import mesh  # noqa: E402
from pnpflow_tpu_torch.training import denoiser as td  # noqa: E402
from pnpflow_tpu_torch.training import flow_matching as fm  # noqa: E402
from pnpflow_tpu_torch.utils.config import CfgNode  # noqa: E402

TINY = dict(input_channels=1, input_height=16, ch=32, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,))
LR = 1e-4
SIGMA = 0.13
STEPS = ("fm_exact", "fm_sinkhorn", "gs")


def _model(spec):
    m = VelocityUNet(**TINY, fused_norm=True)
    m.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                       for k, v in spec.items() if k.startswith("p/")})
    return m


def _t(a):
    return torch.from_numpy(np.array(a))


def _result(name, loss, model, optimizer):
    out = {f"{name}/loss": np.float32(loss)}
    for n, p in model.named_parameters():
        out[f"{name}/p/{n}"] = p.detach().numpy().copy()
        out[f"{name}/mu/{n}"] = optimizer.state[p]["exp_avg"].numpy().copy()
    return out


def run_steps(spec, workdir) -> dict:
    """One step of each of :data:`STEPS` from the same parameters on the
    global batch of ``spec``: the flow-matching step on precoupled pairs,
    the one that couples by Sinkhorn inside it, and the gradient-step
    denoiser's.  Under a process group each rank trains on its rows."""
    out = {}
    x0, x1, t = _t(spec["x0"]), _t(spec["x1"]), _t(spec["t"])
    model = _model(spec)
    state = fm.new_state(model, LR)
    loss = fm.make_fm_train_step_precoupled()(state, x0, x1, t=t)
    out.update(_result("fm_exact", loss, model, state.optimizer))

    model = _model(spec)
    state = fm.new_state(model, LR)
    loss = fm.make_fm_train_step(coupling="ot", ot_method="sinkhorn")(
        state, x1, torch.Generator().manual_seed(int(spec["seed"])),
        x0=x0, t=t)
    out.update(_result("fm_sinkhorn", loss, model, state.optimizer))

    model = _model(spec)
    tr = td.GradientStepTrainer(CfgNode({
        "dataset": "synthetic", "model": "gradient_step", "dim_image": 16,
        "num_channels": 1, "lr": LR, "num_epoch": 1, "seed": 0,
        "output_root": workdir, "batch_size_train": x1.shape[0],
        "device": "cpu"}), model=model)
    st = tr.init_state()
    model.load_state_dict(_model(spec).state_dict())
    loss, _ = tr.train_step(st, x1, SIGMA, u=_t(spec["u"]))
    out.update(_result("gs", loss, model, st.optimizer))
    return out


def main(spec_path, out_prefix):
    torch.set_num_threads(1)
    assert mesh.init_distributed("cpu") and mesh.world_size() == 2
    with np.load(spec_path) as f:
        spec = dict(f)
    out = run_steps(spec, os.path.dirname(out_prefix))
    np.savez(f"{out_prefix}.{mesh.rank()}.npz", **out)
    mesh.barrier()


if __name__ == "__main__":
    main(*sys.argv[1:])
