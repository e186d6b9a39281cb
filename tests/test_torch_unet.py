"""The port's velocity U-Net against the JAX ``VelocityUNet`` on the same
parameters (carried across with ``state_dict_from_flax``) and inputs.

Bounds: ``fused_norm`` False / True within atol 5e-5 (the bound the JAX
package holds its fused norm to); ``"conv"`` within 1e-4 relative to
max|v| (the JAX fused-conv bound); bf16 within 3e-2 relative (bf16 keeps
8 mantissa bits and the two frameworks round at different places).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.utils.torch_convert import convert_unet_state_dict
from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
from pnpflow_tpu_torch.utils.jax_params import state_dict_from_flax

SMALL = dict(input_channels=3, input_height=32, ch=32, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(16,))
FLAGSHIP = dict(input_channels=3, input_height=16, ch=32,
                ch_mult=(1, 2, 4, 8), num_res_blocks=6,
                attn_resolutions=(16, 8))


def _randomized(params, seed):
    """Every leaf random (no near-zero convs), so each path carries signal:
    GroupNorm scales near 1, biases small, weights ~ 1/sqrt(fan_in)."""
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

    return jax.tree_util.tree_map_with_path(draw, params)


def _case(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    dim = cfg["input_height"]
    x = rng.normal(size=(batch, dim, dim, 3)).astype(np.float32)
    t = rng.uniform(size=(batch,)).astype(np.float32)
    # the parameter tree's shapes only: no init forward is run
    shapes = jax.eval_shape(JaxUNet(**cfg).init, jax.random.PRNGKey(0), x, t)
    return _randomized(shapes, seed), x, t


_CACHE = {}


def _jax_forward(name, cfg, batch, fused, dtype=jnp.float32):
    key = (name, fused, dtype)
    if key not in _CACHE:
        if name not in _CACHE:
            _CACHE[name] = _case(cfg, batch, 0)
        params, x, t = _CACHE[name]
        jm = JaxUNet(**cfg, fused_norm=fused, dtype=dtype,
                     norm_dtype=dtype if dtype == jnp.bfloat16 else None)
        out = jax.jit(jm.apply)(params, x, t)
        _CACHE[key] = (params, x, t, np.asarray(out, np.float32))
    return _CACHE[key]


def _port(cfg, params, fused, dtype=torch.float32):
    m = VelocityUNet(**cfg, fused_norm=fused, dtype=dtype)
    m.load_state_dict(state_dict_from_flax(params))
    return m.eval()


@pytest.mark.parametrize("name,cfg,batch", [
    ("small", SMALL, 2), ("flagship", FLAGSHIP, 2)])
@pytest.mark.parametrize("fused", [False, True, "conv"])
def test_forward_matches_jax(name, cfg, batch, fused):
    params, x, t, want = _jax_forward(name, cfg, batch, fused)
    with torch.no_grad():
        got = _port(cfg, params, fused)(torch.from_numpy(x),
                                         torch.from_numpy(t)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if fused == "conv":
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 1e-4, rel
    else:
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_bf16_forward_matches_jax():
    params, x, t, want = _jax_forward("small", SMALL, 2, "conv",
                                      jnp.bfloat16)
    with torch.no_grad():
        got = _port(SMALL, params, "conv", torch.bfloat16)(
            torch.from_numpy(x), torch.from_numpy(t)).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 3e-2, rel


def test_state_dict_round_trips_through_jax_converter():
    params, _, _ = _case(SMALL, 1, 3)
    port = _port(SMALL, params, False)
    back = convert_unet_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    flat_a = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(str, flat_a)) == set(map(str, flat_b))
    by_name = {str(k): v for k, v in flat_b.items()}
    for k, v in flat_a.items():
        np.testing.assert_array_equal(np.asarray(v), by_name[str(k)])


def test_seeded_init_follows_vs_init():
    m = init_weights(VelocityUNet(**SMALL), seed=0)
    again = init_weights(VelocityUNet(**SMALL), seed=0)
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    w = m.begin_conv.weight.detach()
    lim = np.sqrt(3.0 / ((32 + 3) * 9 / 2.0))
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.5 * lim
    assert float(m.end_conv[2].weight.detach().abs().max()) < 1e-4
    assert float(m.end_conv[0].weight.detach().min()) == 1.0


def test_kernel_weight_cache_follows_load_state_dict():
    m = VelocityUNet(**SMALL)
    conv = m.begin_conv
    w0 = conv.kernel_weight(torch.float32)
    assert conv.kernel_weight(torch.float32) is w0
    sd = {k: v + 1.0 for k, v in m.state_dict().items()}
    m.load_state_dict(sd)
    w1 = conv.kernel_weight(torch.float32)
    torch.testing.assert_close(w1, conv.weight.permute(2, 3, 1, 0))
    assert not torch.equal(w1, w0)


@pytest.mark.parametrize("mode", ["bm", "dot", "bf16stats", "tview"])
def test_unported_norm_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VelocityUNet(**SMALL, fused_norm=mode)


def test_registry_resolves_pt_then_refuses_msgpack(tmp_path):
    from pnpflow_tpu_torch.models.registry import (
        checkpoint_paths, define_model, load_params)
    from pnpflow_tpu_torch.utils.config import CfgNode

    args = CfgNode(dict(model="ot", dim_image=16, num_channels=3,
                        dataset="synthetic", output_root=str(tmp_path),
                        seed=0))
    m = define_model(args)
    assert m.fused_norm == "conv" and m.ch_mult == (1, 2, 4, 8)
    with pytest.warns(UserWarning, match="random init"):
        ref = load_params(m, args)
    paths = checkpoint_paths(args)
    (tmp_path / "model" / "synthetic" / "ot").mkdir(parents=True)
    sd = {k: v + 0.5 for k, v in ref.state_dict().items()}
    torch.save(sd, paths["torch"])
    got = load_params(define_model(args), args)
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    open(paths["msgpack"], "wb").close()
    with pytest.raises(NotImplementedError, match="msgpack"):
        load_params(define_model(args), args)
