"""Shared by the rectified-flow port tests: the tiny configurations of
``tests/test_rf_main.py:_tiny_opts`` (8x8, nf 16, one block, no attention,
batch 4) for both packages, and one NCSN++ on the same real-scale weights
in both (JAX's seeded tree carried to the port by
``ncsnpp_state_dict_from_flax``); ``fir=True`` takes the CelebA-HQ config
at 16x16 instead, whose resampling is the FIR."""

import jax
import numpy as np
import torch

from pnpflow_tpu import rf_main as jrf
from pnpflow_tpu.config import rf_configs as jcfg
from pnpflow_tpu_torch import rf_main as trf
from pnpflow_tpu_torch.config import rf_configs as tcfg
from pnpflow_tpu_torch.models import zoo as tzoo
from pnpflow_tpu_torch.utils.jax_params import ncsnpp_state_dict_from_flax

TINY = ["data.image_size", "8", "model.nf", "16", "model.num_res_blocks",
        "1", "model.attn_resolutions", "()", "training.batch_size", "4",
        "sampling.sample_N", "5", "sampling.use_ode_sampler", "euler",
        "optim.warmup", "2"]
FIR = ["data.image_size", "16", "model.nf", "16", "model.ch_mult", "(1, 2)",
       "model.num_res_blocks", "1", "model.attn_resolutions", "()",
       "training.batch_size", "4"]


def configs(fir=False, extra=()):
    name = ("celeba_hq_pytorch_rf_gaussian" if fir
            else "cifar10_rf_gaussian_ddpmpp")
    opts = (FIR if fir else TINY) + list(extra)
    return (jrf._apply_opts(jcfg.get_config(name), opts),
            trf._apply_opts(tcfg.get_config(name), opts))


def real_scale(tree, seed):
    """Every leaf at a real scale: the flax init leaves the output convs
    near zero, which would make a comparison vacuous."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if name.endswith("['kernel']") or name.endswith("_weight']") or (
                name.endswith("['W']") and len(shape) == 2):
            fan_in = max(int(np.prod(shape[:-1])), 1)
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name.endswith("['W']"):       # the Fourier projection
            v = 16.0 * rng.standard_normal(shape)
        elif name.endswith("['scale']"):
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def models(fir=False, seed=0, extra=()):
    """(jax cfg, port cfg, JAX apply(params, x, t) with t * 999, its
    params, the port's ``RFModel`` on the same weights)."""
    jc, tc = configs(fir, extra)
    jm, apply = jrf._model_and_apply(jc)
    d = jc.data
    x = np.zeros((1, d.image_size, d.image_size, d.num_channels), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                            np.ones((1,), np.float32)))
    params = real_scale(shapes, seed)
    rf = trf.RFModel(tzoo.create_model(tc)).eval()
    rf.model.load_state_dict(ncsnpp_state_dict_from_flax(
        params, rf.model.sigmas))
    return jc, tc, jax.jit(apply), params, rf


def close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-6), (err, scale)
