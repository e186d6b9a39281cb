"""The port's NCSN++ (``rectified``) against the JAX ``NCSNpp`` on the same
parameters (carried across with ``ncsnpp_state_dict_from_flax``) and
inputs, its checkpoint readers, and its registry entry.

Every parameter is drawn at a real scale: the seeded init leaves Conv_1,
NIN_3 and the output convs near zero, which would make a comparison vacuous.

Bounds: forward within 2e-5 of max|out| (float32 rounding through the
network's ~30 layers stays near 2e-6; a wrong tap, flip or layout is
O(1)); bf16 within 0.1 of the float32 output, the JAX package's own bf16
bound for this network.
"""

import os

import msgpack
import numpy as np
import jax
import pytest
import torch
from flax import serialization

from pnpflow_tpu.models import registry as jreg
from pnpflow_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from pnpflow_tpu.utils.ncsnpp_convert import convert_ncsnpp_state_dict
from pnpflow_tpu_torch.models import registry as treg
from pnpflow_tpu_torch.models.ncsnpp import NCSNpp, init_ncsnpp
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import ncsnpp_state_dict_from_flax

SMALL = dict(image_size=32, num_channels=3, nf=32, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(16,))
REL = 2e-5


def _randomized(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.2 * rng.standard_normal(leaf.shape, np.float32)
        elif "bias" in name or name.endswith("['b']"):
            v = 0.1 * rng.standard_normal(leaf.shape, np.float32)
        else:
            fan_in = max(int(np.prod(leaf.shape[:-1])), 1)
            v = rng.standard_normal(leaf.shape, np.float32) / np.float32(
                np.sqrt(fan_in))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _case(cfg, batch, seed, t=(123.0, 500.0)):
    rng = np.random.default_rng(seed)
    dim = cfg["image_size"]
    x = rng.normal(size=(batch, dim, dim, 3)).astype(np.float32)
    tt = np.asarray(t[:batch], np.float32)
    shapes = jax.eval_shape(JaxNCSNpp(**cfg).init, jax.random.PRNGKey(0), x,
                            tt)
    return _randomized(shapes, seed), x, tt


_CACHE = {}


def _small(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _CACHE:
        cfg = {**SMALL, **kw}
        params, x, t = _case(cfg, 2, 1)
        want = np.asarray(jax.jit(JaxNCSNpp(**cfg).apply)(params, x, t))
        _CACHE[key] = (cfg, params, x, t, want)
    return _CACHE[key]


def _port(cfg, params, dtype=torch.float32):
    m = NCSNpp(**cfg, dtype=dtype)
    m.load_state_dict(ncsnpp_state_dict_from_flax(params, m.sigmas))
    return m.eval()


def _run(m, x, t):
    with torch.no_grad():
        return m(torch.from_numpy(x), torch.from_numpy(t)).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("embedding_type", ["fourier", "positional"])
@pytest.mark.parametrize("resblock_type", ["biggan", "ddpm"])
def test_small_forward_matches_jax(resblock_type, embedding_type):
    cfg, params, x, t, want = _small(resblock_type=resblock_type,
                                     embedding_type=embedding_type)
    got = _run(_port(cfg, params), x, t)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    assert _rel(got, want) < REL


def test_full_width_forward_at_64():
    """The 256^2 configuration's widths (nf 128, seven levels, attention at
    16) at 64^2, batch 1."""
    cfg = dict(image_size=64)
    params, x, t = _case(cfg, 1, 2, t=(400.0,))
    want = np.asarray(jax.jit(JaxNCSNpp(**cfg).apply)(params, x, t))
    got = _run(_port(cfg, params), x, t)
    assert _rel(got, want) < REL


def test_bf16_forward_close_to_fp32():
    cfg, params, x, t, want = _small()
    got = _run(_port(cfg, params, torch.bfloat16), x, t)
    assert got.dtype == np.float32
    assert _rel(got, want) < 0.1


def test_state_dict_round_trips_through_jax_converter():
    cfg, params, _, _, _ = _small()
    port = _port(cfg, params)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_ncsnpp_state_dict(sd, params["params"])["params"]
    flat_a = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(params["params"])}
    flat_b = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(back)}
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        np.testing.assert_array_equal(np.asarray(v), flat_b[k])
    assert set(sd) == set(ncsnpp_state_dict_from_flax(params, port.sigmas))
    assert "sigmas" in sd and "all_modules.0.W" in sd


def test_seeded_init_follows_vs_init():
    m = init_ncsnpp(NCSNpp(**SMALL), seed=0).requires_grad_(False)
    again = init_ncsnpp(NCSNpp(**SMALL), seed=0)
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    blocks = [mod for mod in m.all_modules if hasattr(mod, "Conv_1")]
    assert blocks and all(float(b.Conv_1.weight.abs().max()) < 1e-4
                          for b in blocks)
    assert float(blocks[0].Conv_0.weight.abs().max()) > 1e-2
    assert 10.0 < float(m.all_modules[0].W.std()) < 22.0
    assert not NCSNpp(**SMALL).all_modules[0].W.requires_grad


def test_adapter_floors_t_before_scaling():
    cfg, params, x, _, _ = _small()
    model = treg.RectifiedAdapter(_port(cfg, params))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        at0 = model(tx, torch.zeros(2))
        at_floor = model(tx, torch.full((2,), 1e-3))
        direct = model.model(tx, torch.full((2,), 1e-3) * 999.0)
    assert torch.isfinite(at0).all()
    assert torch.equal(at0, at_floor) and torch.equal(at_floor, direct)


def _args(tmp_path, dim=32):
    return CfgNode(dict(model="rectified", dim_image=dim, num_channels=3,
                        dataset="synthetic", output_root=str(tmp_path),
                        seed=0))


def _ckpt_dir(tmp_path):
    d = tmp_path / "model" / "synthetic" / "rectified"
    d.mkdir(parents=True, exist_ok=True)
    return d


@pytest.mark.parametrize("form", ["envelope", "legacy"])
def test_msgpack_checkpoint_gives_jax_forward(tmp_path, form):
    cfg, params, x, t, want = _small()
    args = _args(tmp_path)
    path = str(_ckpt_dir(tmp_path) / "model_final.msgpack")
    if form == "envelope":
        jreg.save_params_file(params, path, fingerprint=jreg.model_fingerprint(
            JaxNCSNpp(**cfg), args))
    else:
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(params))
    m = treg.load_params(NCSNpp(**cfg), args, require=True)
    assert _rel(_run(m.eval(), x, t), want) < REL


def test_wrong_fingerprint_warns_or_raises(tmp_path):
    cfg, params, _, _, _ = _small()
    args = _args(tmp_path)
    path = str(_ckpt_dir(tmp_path) / "model_final.msgpack")
    fp = jreg.model_fingerprint(JaxNCSNpp(**cfg), _args(tmp_path, dim=64))
    jreg.save_params_file(params, path, fingerprint=fp)
    with pytest.raises(ValueError, match="different architecture"):
        treg.load_params(NCSNpp(**cfg), args, require=True)
    with pytest.warns(UserWarning, match="different architecture"):
        m = treg.load_params(NCSNpp(**cfg), args)
    assert not torch.equal(m.all_modules[1].weight,
                           torch.from_numpy(params["params"]["m1"]["kernel"].T))


def test_other_architecture_warns_or_raises(tmp_path):
    cfg, params, _, _, _ = _small()
    path = str(_ckpt_dir(tmp_path) / "model_final.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))
    other = NCSNpp(**{**SMALL, "nf": 16})
    with pytest.raises(ValueError, match="shape"):
        treg.load_params(other, _args(tmp_path), require=True)
    with pytest.warns(UserWarning, match="does not match"):
        treg.load_params(NCSNpp(**{**SMALL, "nf": 16}), _args(tmp_path))


def test_msgpack_reader_refuses_what_it_cannot_decode(tmp_path):
    path = tmp_path / "x.msgpack"
    chunked = {"params": {"m0": {"W": {"__msgpack_chunked_array__": True,
                                       "shape": [2]}}}}
    path.write_bytes(msgpack.packb(chunked))
    with pytest.raises(ValueError, match="chunked"):
        treg.read_msgpack(str(path))
    path.write_bytes(msgpack.packb({"params": {"m0": {
        "W": msgpack.ExtType(3, b"\x00")}}}))
    with pytest.raises(ValueError, match="ext type 3"):
        treg.read_msgpack(str(path))
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="msgpack"):
        treg.read_msgpack(str(path))


def test_rectifiedflow_pth_loads(tmp_path):
    """A RectifiedFlow {model, ema, optimizer, step} checkpoint whose keys
    carry DataParallel's ``module.`` prefix."""
    cfg, params, x, t, want = _small()
    sd = _port(cfg, params).state_dict()
    torch.save({"model": {"module." + k: v for k, v in sd.items()},
                "ema": {"decay": 0.999, "num_updates": 1,
                        "shadow_params": list(sd.values())[:2]},
                "optimizer": {"state": {}, "param_groups": []}, "step": 7},
               str(_ckpt_dir(tmp_path) / "model_final.pt"))
    m = treg.load_params(NCSNpp(**cfg), _args(tmp_path), require=True)
    assert _rel(_run(m.eval(), x, t), want) < REL


def test_registry_builds_the_rectified_bundle(tmp_path):
    args = _args(tmp_path, dim=64)
    m = treg.define_model(args)
    assert isinstance(m, NCSNpp)
    assert treg.model_fingerprint(m, args) == jreg._normalize_fp(
        jreg.model_fingerprint(jreg.define_model(args), args))
    with pytest.warns(UserWarning, match="random init"):
        bundle = treg.build_model_bundle(args, device="cpu")
    assert bundle.kind == "rectified"
    assert isinstance(bundle.model, treg.RectifiedAdapter)
    assert bundle.device.type == "cpu"
    assert not os.listdir(tmp_path)
