"""The port's FID InceptionV3 and its converter against the JAX package, on
the synthetic (seeded random) weights that both write.

Bounds: pool3 within 1e-4 of max|pool3| and the softmax probabilities
within 1e-5 of JAX's, 2 images at 64² (float32 rounding through 94 convs
at 299²); ``synthetic_state_dict`` and the converted npz equal to JAX's
array for array.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.models.inception import (
    inception_logits, inception_pool3, load_inception_params as jload)
from pnpflow_tpu.utils import inception_convert as jconv
from pnpflow_tpu_torch.models import inception as inc
from pnpflow_tpu_torch.utils import inception_convert as conv
from pnpflow_tpu_torch.utils.config import CfgNode


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """``model/inception_fid.npz`` written by the port's CLI."""
    root = tmp_path_factory.mktemp("inc")
    os.makedirs(root / "model")
    conv.main("--synthetic", str(root / "model" / "inception_fid.npz"))
    return root


def test_synthetic_state_dict_equals_jax():
    got, want = conv.synthetic_state_dict(0), jconv.synthetic_state_dict(0)
    assert list(got) == list(want) and len(got) == 472
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    flat, jflat = (m.convert_inception_state_dict(sd)
                   for m, sd in ((conv, got), (jconv, want)))
    assert sorted(flat) == sorted(jflat)
    assert all(np.array_equal(flat[k], jflat[k]) for k in flat)


def test_cli_npz_is_what_jax_reads(npz):
    path = str(npz / "model" / "inception_fid.npz")
    with np.load(path) as f:
        assert str(f["provenance"]) == "synthetic_random_init_seed0"
    mine, theirs = inc.load_inception_params(path), jload(path)
    assert sorted(mine) == sorted(theirs)
    assert np.array_equal(mine["e2"]["bpool"]["w"],
                          np.asarray(theirs["e2"]["bpool"]["w"]))
    assert np.array_equal(mine["fc"]["b"], np.asarray(theirs["fc"]["b"]))


def test_pool3_and_probabilities_match_jax(npz):
    path = str(npz / "model" / "inception_fid.npz")
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, jload(path))
    # jitted, as JAX's get_inception_fns runs it
    p3 = jax.jit(inception_pool3)(params, jnp.asarray(x))
    want_p3 = np.asarray(p3)
    want_pr = np.asarray(jax.nn.softmax(inception_logits(params, p3)))
    feature_fn, outputs_fn = inc.get_inception_fns(
        CfgNode(dict(output_root=str(npz))), device="cpu")
    got_p3, got_pr = (t.numpy() for t in outputs_fn(torch.from_numpy(x)))
    assert got_p3.shape == (2, 2048) and got_pr.shape == (2, 1008)
    scale = np.abs(want_p3).max()
    print(f"pool3 max {scale:.4f}, err {np.abs(got_p3 - want_p3).max():.3e}"
          f"; probs err {np.abs(got_pr - want_pr).max():.3e}")
    assert np.abs(got_p3 - want_p3).max() <= 1e-4 * scale
    assert np.abs(got_pr - want_pr).max() <= 1e-5
    assert np.abs(got_pr.sum(axis=1) - 1.0).max() <= 1e-5
    assert torch.equal(feature_fn(torch.from_numpy(x)),
                       torch.from_numpy(got_p3))


def test_grayscale_is_tiled_and_chunks_are_ragged(npz):
    """One channel is tiled to three after the resize; three images in
    sub-batches of 2 give what each gives alone."""
    feature_fn, _ = inc.get_inception_fns(
        CfgNode(dict(output_root=str(npz))), batch=2, device="cpu")
    g = np.random.default_rng(1).uniform(size=(3, 32, 32, 1)).astype(
        np.float32)
    gray = feature_fn(torch.from_numpy(g))
    rgb = feature_fn(torch.from_numpy(np.repeat(g, 3, axis=-1)))
    assert gray.shape == (3, 2048)
    assert (gray - rgb).abs().max() <= 1e-6 * rgb.abs().max()
    one = torch.cat([feature_fn(torch.from_numpy(g[i:i + 1]))
                     for i in range(3)])
    assert (gray - one).abs().max() <= 1e-5 * one.abs().max()


def test_images_on_another_device_raise(npz):
    """The network's device is asked for, never reached by copying."""
    feature_fn, outputs_fn = inc.get_inception_fns(
        CfgNode(dict(output_root=str(npz))), device="cpu")
    x = torch.empty(1, 32, 32, 3, device="meta")
    for fn in (feature_fn, outputs_fn):
        with pytest.raises(ValueError, match="on meta"):
            fn(x)


def test_cache_is_keyed_on_path_and_mtime(tmp_path):
    args = CfgNode(dict(output_root=str(tmp_path)))
    assert inc.get_inception_fns(args, device="cpu") is None
    os.makedirs(tmp_path / "model")
    path = tmp_path / "model" / "inception_fid.npz"
    flat = conv.convert_inception_state_dict(conv.synthetic_state_dict(0))
    np.savez(path, **flat)
    first = inc.get_inception_fns(args, device="cpu")
    assert inc.get_inception_fns(args, device="cpu") is first
    # the npz rewritten in place, without the fc head: new weights are read
    del flat["fc/w"], flat["fc/b"]
    np.savez(path, **flat)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    second = inc.get_inception_fns(args, device="cpu")
    assert second is not first and second[1] is None
    assert list(inc._CACHE.values()) == [second]   # one network is kept
