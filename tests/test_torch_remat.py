"""``--opts remat True`` in restoration: each place a solver differentiates
the model recomputes the forward in the backward instead of keeping its
activations (JAX: ``jax.checkpoint`` around the apply,
``pnpflow_tpu/models/registry.py:240-246``).

For ot_ode, flow_priors, d_flow and pnp_gs at 32² (a small U-Net with
``fused_norm True``, so every GroupNorm goes through the kernel's autograd
function and its plain rules): the result with ``remat True`` equals the
one without within 1e-6 of its max, and a forward counter shows the
recomputation: each differentiated forward runs twice (d_flow: once more
than without, since its steps are checkpointed already).
"""

import numpy as np
import pytest
import torch

from pnpflow_tpu_torch.models.registry import build_model_bundle
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.ops import degradations as tdeg
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.solvers.d_flow import DFlow
from pnpflow_tpu_torch.solvers.flow_priors import FlowPriors
from pnpflow_tpu_torch.solvers.ot_ode import OTOde
from pnpflow_tpu_torch.solvers.pnp_gs import ProxPnP
from pnpflow_tpu_torch.utils.config import CfgNode

DIM, B = 32, 2
CFG = dict(input_channels=3, input_height=DIM, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,), fused_norm=True)
BASE = dict(noise_type="gaussian", save_results=False, compute_time=False,
            compute_memory=False, max_batch=1)
CASES = {
    "ot_ode": (OTOde, dict(problem="gaussian_deblurring_FFT", steps_ode=5,
                           start_time=0.2, gamma="constant")),
    "flow_priors": (FlowPriors, dict(problem="gaussian_deblurring_FFT", N=2,
                                     K=1, lmbda=1000.0, eta=0.01,
                                     start_time=0.0)),
    "d_flow": (DFlow, dict(problem="gaussian_deblurring_FFT", steps_euler=3,
                           start_time=0.0, max_iter=1, LBFGS_iter=1,
                           lmbda=0.001, alpha=0.1)),
    "pnp_gs": (ProxPnP, dict(problem="denoising", algo="pgd", max_iter=3,
                             lr_pnp=1.0, alpha=0.5, sigma_factor=1.0)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    m = init_weights(VelocityUNet(**CFG), seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return m.eval()


def _run(method, remat):
    cls, kw = CASES[method]
    model = _model()
    calls = []
    model.register_forward_pre_hook(
        lambda mod, inp: calls.append(torch.is_grad_enabled()))
    solver = cls(ModelBundle(model=model, device=torch.device("cpu"),
                             remat=remat),
                 CfgNode({**BASE, "method": method, **kw}))
    rng = np.random.default_rng(7)
    clean = torch.from_numpy(np.tanh(rng.normal(
        size=(B, DIM, DIM, 3))).astype(np.float32))
    op = (tdeg.Denoising() if kw["problem"] == "denoising"
          else tdeg.GaussianDeblurring(1.0, 9, 3, DIM, device="cpu"))
    noisy = op.H(clean) + 0.05 * torch.from_numpy(
        rng.normal(size=clean.shape).astype(np.float32))
    seam = torch.from_numpy(rng.normal(size=clean.shape).astype(np.float32))
    extra = {"ot_ode": {"x_init": seam}, "flow_priors": {"x_init": seam},
             "d_flow": {"z_init": seam}, "pnp_gs": {}}[method]
    with torch.no_grad():
        x, _ = solver.solve_batch(clean, noisy, op, 0.05, 0, **extra)
    return x, calls


@pytest.mark.parametrize("method", sorted(CASES))
def test_remat_matches_and_recomputes_the_forward(method):
    want, plain = _run(method, False)
    got, remat = _run(method, True)
    assert torch.isfinite(want).all()
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    differentiated = sum(plain)
    assert differentiated > 0
    if method == "d_flow":
        # each step is a checkpoint already: its forwards run in the
        # pass, in the step's recomputation and, under remat, once more
        # in the recomputation of each checkpointed forward
        assert len(remat) > len(plain)
    else:
        # every differentiated forward runs once more, in the backward
        assert len(remat) == len(plain) + differentiated
        assert sum(remat) == 2 * differentiated


def test_build_model_bundle_reads_remat(tmp_path):
    args = CfgNode(dict(model="ot", dim_image=16, num_channels=3,
                        dataset="synthetic", output_root=str(tmp_path),
                        method="ot_ode"))
    with pytest.warns(UserWarning, match="random init"):
        assert not build_model_bundle(args, device="cpu").remat
    args.remat = True
    with pytest.warns(UserWarning, match="random init"):
        assert build_model_bundle(args, device="cpu").remat
