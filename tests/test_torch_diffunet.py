"""The port's DiffUNet (``pnpflow_tpu_torch/models/diffunet.py``) against the
JAX package's (``pnpflow_tpu/models/diffunet.py``).

- ``tests/test_solvers.py``'s tiny DiffUNet (model_channels 32, mult (1, 2),
  one block, attention at ds 2, 6 outputs) at 32x32 with every parameter
  drawn at a real scale (the zero-init output convs and attention
  projections would otherwise make the output 0): within 2e-5 of max|out|;
- the full-width DiffPIR configuration: the port's ``state_dict`` maps onto
  ``jax.eval_shape(DiffUNet().init, ...)``'s tree key for key and shape;
- checkpoints each package writes load in the other, bit for bit, with
  equal architecture fingerprints;
- a ``.pt`` under ``model diffusion`` is refused (JAX would convert it with
  the U-Net's key map).
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.models import registry as jreg
from pnpflow_tpu.models.diffunet import DiffUNet as JaxDiffUNet
from pnpflow_tpu.models.diffunet import timestep_embedding as jax_embedding
from pnpflow_tpu.utils.config import CfgNode as JaxCfg
from pnpflow_tpu_torch.models import registry as treg
from pnpflow_tpu_torch.models.diffunet import (
    DiffUNet, init_diffunet, timestep_embedding)
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import (
    diffunet_state_dict_from_flax, flax_from_diffunet_state_dict)

DIM, B = 32, 2
TINY = dict(in_channels=3, out_channels=6, model_channels=32,
            channel_mult=(1, 2), num_res_blocks=1, attention_ds=(2,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def real_scale(shapes, seed):
    """Every leaf drawn at a real scale: GroupNorm scales near 1, biases
    small, kernels ~ 1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif "bias" in name:
            v = 0.1 * rng.normal(size=leaf.shape)
        else:
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def tiny_params():
    shapes = jax.eval_shape(JaxDiffUNet(**TINY).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, DIM, DIM, 3)), jnp.zeros((1,)))
    return real_scale(shapes, 0)


def test_timestep_embedding_matches_jax():
    """Within 5e-5: the arguments reach 999 rad, where one float32 ulp is
    6.1e-5, so cos and sin may differ by about that much."""
    t = np.array([0.0, 1.0, 37.0, 999.0], np.float32)
    for dim in (32, 33, 128):
        want = np.asarray(jax_embedding(jnp.asarray(t), dim))
        got = timestep_embedding(torch.from_numpy(t), dim).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 5e-5


def test_tiny_forward_matches_jax():
    params = tiny_params()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, DIM, DIM, 3)).astype(np.float32)
    t = np.array([10.0, 733.0], np.float32)
    want = np.asarray(JaxDiffUNet(**TINY).apply(params, x, t))
    m = DiffUNet(**TINY)
    m.load_state_dict(diffunet_state_dict_from_flax(params))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    vmax = np.abs(want).max()
    assert got.shape == (B, DIM, DIM, 6) and vmax > 0.1
    assert np.abs(got - want).max() <= 2e-5 * vmax


def test_full_width_tree_round_trip():
    """The DiffPIR configuration: 94.35M parameters, 68 GroupNorms (30
    ResBlocks x 2, 7 attention norms, the output norm), every port key a
    leaf of JAX's tree with the flax shape, and back."""
    shapes = jax.eval_shape(JaxDiffUNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,)))
    m = DiffUNet()
    sd = m.state_dict()
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(isinstance(mod, torch.nn.GroupNorm)
               for mod in m.modules()) == 68
    tree = flax_from_diffunet_state_dict(
        {k: torch.zeros(v.shape) for k, v in sd.items()})
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(shapes)
    for got, want in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(shapes)):
        assert got.shape == want.shape
    back = diffunet_state_dict_from_flax(tree)
    assert {k: tuple(v.shape) for k, v in back.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


def test_fingerprints_agree():
    """JAX's ``model_fingerprint`` reads ch, nf, ch_mult, num_res_blocks and
    attn_resolutions where the module has them: the JAX DiffUNet has only
    num_res_blocks, and so does the port's."""
    args = {"model": "diffusion", "dim_image": 256, "num_channels": 3}
    want = jreg.model_fingerprint(JaxDiffUNet(), JaxCfg(args))
    got = treg.model_fingerprint(DiffUNet(), CfgNode(args))
    assert got == want == dict(args, num_res_blocks=1)


def test_checkpoints_read_both_ways(tmp_path):
    params = tiny_params()
    args = {"dataset": "synthetic", "model": "diffusion", "dim_image": DIM,
            "num_channels": 3}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jargs = JaxCfg(dict(args, output_root=jdir))
    jreg.save_params_file(params, jreg.checkpoint_paths(jargs)["msgpack"],
                          fingerprint=jreg.model_fingerprint(
                              JaxDiffUNet(**TINY), jargs))
    m = treg.load_params(DiffUNet(**TINY), CfgNode(dict(args,
                                                       output_root=jdir)),
                         require=True)
    for k, v in diffunet_state_dict_from_flax(params).items():
        assert torch.equal(m.state_dict()[k], v), k

    pargs = CfgNode(dict(args, output_root=pdir))
    mine = init_diffunet(DiffUNet(**TINY), seed=3)
    treg.save_params_file(
        flax_from_diffunet_state_dict(mine.state_dict()),
        treg.checkpoint_paths(pargs)["msgpack"],
        fingerprint=treg.model_fingerprint(mine, pargs))
    got = jreg.load_params(JaxDiffUNet(**TINY),
                           JaxCfg(dict(args, output_root=pdir)),
                           require=True)
    want = flax_from_diffunet_state_dict(mine.state_dict())
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), b)


def test_bundle_reads_a_jax_checkpoint_at_full_width(tmp_path):
    """``build_model_bundle`` for ``model diffusion`` loads a JAX-written
    ``model/{dataset}/diffusion/model_final.msgpack`` into the full-width
    DiffUNet, in float32 under ``bf16`` too, with no adapter."""
    shapes = jax.eval_shape(JaxDiffUNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1,)))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, np.float32) * 0.01, shapes)
    args = {"dataset": "synthetic", "model": "diffusion", "dim_image": 64,
            "num_channels": 3, "output_root": str(tmp_path), "seed": 0}
    jargs = JaxCfg(args)
    jreg.save_params_file(params, jreg.checkpoint_paths(jargs)["msgpack"],
                          fingerprint=jreg.model_fingerprint(JaxDiffUNet(),
                                                             jargs))
    bundle = treg.build_model_bundle(CfgNode(dict(args, device="cpu")),
                                     dtype=torch.bfloat16, device="cpu")
    assert isinstance(bundle.model, DiffUNet) and bundle.kind == "diffusion"
    w = bundle.model.mid_attn.qkv.weight
    assert w.dtype == torch.float32
    assert torch.equal(w, torch.from_numpy(
        params["params"]["mid_attn"]["qkv"]["kernel"].T.copy()))


def test_seeded_init_outputs_zero_as_jax_does():
    m = init_diffunet(DiffUNet(**TINY), seed=0)
    with torch.no_grad():
        out = m(torch.randn(1, DIM, DIM, 3), torch.tensor([500.0]))
    assert float(out.abs().max()) == 0.0
    w = m.down_0_res_0.in_conv.weight
    std = float(w.detach().std())
    # lecun normal: variance 1 / fan_in, truncated at two deviations
    assert abs(std - (1.0 / w[0].numel()) ** 0.5) < 0.1 * std
    assert float(w.detach().abs().max()) <= 2.0 * (1.0 / w[0].numel()) ** 0.5 \
        / .87962566103423978 + 1e-6


def test_torch_checkpoint_is_refused(tmp_path):
    args = CfgNode({"dataset": "synthetic", "model": "diffusion",
                    "dim_image": DIM, "num_channels": 3,
                    "output_root": str(tmp_path)})
    path = treg.checkpoint_paths(args)["torch"]
    os.makedirs(os.path.dirname(path))
    torch.save(DiffUNet(**TINY).state_dict(), path)
    with pytest.raises(ValueError, match="model diffusion"):
        treg.load_params(DiffUNet(**TINY), args)
