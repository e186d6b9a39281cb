"""The port's RectifiedFlow checkpoint converter against JAX's: a
synthetic ``{model, ema, optimizer, step}`` checkpoint of a small NCSN++
(``module.``-prefixed keys, as the reference saves them) converts, with and
without ``--ema``, to the tree JAX's converter builds, leaf for leaf and
bit for bit, in a msgpack both packages read."""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from pnpflow_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from pnpflow_tpu.utils.ncsnpp_convert import convert_ncsnpp_state_dict
from pnpflow_tpu_torch.models.ncsnpp import NCSNpp
from pnpflow_tpu_torch.models.registry import read_msgpack
from pnpflow_tpu_torch.utils import ncsnpp_convert

SMALL = dict(image_size=16, num_channels=3, nf=16, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(8,))
ARGS = ["--image-size", "16", "--nf", "16", "--ch-mult", "1", "2",
        "--num-res-blocks", "1", "--attn-resolutions", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    g = torch.Generator().manual_seed(0)
    model = NCSNpp(**SMALL)
    sd = {k: torch.randn(v.shape, generator=g) if k != "sigmas" else v
          for k, v in model.state_dict().items()}
    trainable = [k for k, v in model.named_parameters() if v.requires_grad]
    shadow = [torch.randn(sd[k].shape, generator=g) for k in trainable]
    state = {"model": {"module." + k: v for k, v in sd.items()},
             "ema": {"decay": 0.999, "num_updates": 7,
                     "shadow_params": shadow},
             "optimizer": {"state": {}, "param_groups": []}, "step": 7}
    path = tmp_path_factory.mktemp("ckpt") / "checkpoint.pth"
    torch.save(state, path)
    template = jax.eval_shape(lambda: JaxNCSNpp(**SMALL).init(
        jax.random.PRNGKey(0), np.zeros((1, 16, 16, 3), np.float32),
        np.full((1,), 500.0, np.float32)))["params"]
    return path, state, template


def _jax_tree(state, template, ema):
    """What JAX's converter CLI writes (its main's --ema mapping)."""
    sd = dict(state["model"])
    if ema:
        names = [k for k in sd if k.replace("module.", "", 1)
                 not in ("sigmas", "all_modules.0.W")]
        sd.update(zip(names, state["ema"]["shadow_params"]))
    return convert_ncsnpp_state_dict(sd, template)


@pytest.mark.parametrize("ema", [False, True])
def test_converter_matches_jax(ckpt, tmp_path, ema):
    path, state, template = ckpt
    out = tmp_path / "state.msgpack"
    ncsnpp_convert.main([str(path), str(out), *ARGS] +
                        (["--ema"] if ema else []))
    want = _jax_tree(state, template, ema)
    got, fp = read_msgpack(str(out))
    assert fp is None
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for kp, w in flat_w:
        assert np.array_equal(flat_g[kp], np.asarray(w)), kp
    restored = serialization.from_bytes(
        jax.tree_util.tree_map(np.zeros_like, want), out.read_bytes())
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_ema_checks(ckpt):
    _, state, _ = ckpt
    with pytest.raises(ValueError, match="ema slot is empty"):
        ncsnpp_convert.checkpoint_state_dict(dict(state, ema=None), ema=True)
    short = dict(state, ema=dict(state["ema"], shadow_params=state["ema"][
        "shadow_params"][:-1]))
    with pytest.raises(ValueError, match="shadow parameters"):
        ncsnpp_convert.checkpoint_state_dict(short, ema=True)
    bare = ncsnpp_convert.checkpoint_state_dict(state["model"])
    assert "all_modules.0.W" in bare and not any(
        k.startswith("module.") for k in bare)
