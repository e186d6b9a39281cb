"""The port's LPIPS, its converter and its reporting against the JAX
package.

Bounds: the distance within 1e-5 relative of JAX's ``lpips_distance`` on
the same npz at 64², 2 images (float32 rounding through five convs); the
converter's arrays equal JAX's; the reported ``lpips_*_batch0.txt`` values
within 1e-5 relative of JAX's ``compute_lpips``.
"""

import os
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pnpflow_tpu.metrics.lpips import lpips_distance as jax_lpips
from pnpflow_tpu.utils import lpips_convert as jconv
from pnpflow_tpu.utils import reporting as jrep
from pnpflow_tpu.utils.config import CfgNode as JaxCfg
from pnpflow_tpu_torch.main import main
from pnpflow_tpu_torch.metrics import lpips as lp
from pnpflow_tpu_torch.utils import lpips_convert as conv
from pnpflow_tpu_torch.utils import reporting
from pnpflow_tpu_torch.utils.config import CfgNode

LAYOUT = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
          (256, 256, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(n=2, dim=64, seed=5):
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.normal(size=(n, dim, dim, 3)) * 0.5).astype(np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=x.shape), -1, 1).astype(np.float32)
    return x, y


def test_lpips_matches_jax():
    w = conv.synthetic_weights(0)
    x, y = _pair()
    want = float(jax_lpips(w, jnp.asarray(x), jnp.asarray(y)))
    with torch.inference_mode():
        got = float(lp.LPIPS(w)(torch.from_numpy(x), torch.from_numpy(y)))
    assert want > 0
    assert abs(got - want) <= 1e-5 * abs(want)
    with torch.inference_mode():
        same = float(lp.LPIPS(w)(torch.from_numpy(x), torch.from_numpy(x)))
    assert same == 0.0


def test_converter_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    alexnet, heads = {}, {}
    for i, (fi, (o, c, k)) in enumerate(zip([0, 3, 6, 8, 10], LAYOUT)):
        alexnet[f"features.{fi}.weight"] = rng.normal(
            size=(o, c, k, k)).astype(np.float32)
        alexnet[f"features.{fi}.bias"] = rng.normal(size=o).astype(
            np.float32)
        heads[f"lin{i}.model.1.weight"] = rng.uniform(
            size=(1, o, 1, 1)).astype(np.float32)
    conv.convert_from_state_dicts(alexnet, heads, str(tmp_path / "p.npz"))
    jconv.convert_from_state_dicts(alexnet, heads, str(tmp_path / "j.npz"))
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            assert np.array_equal(p[k], j[k]), k
        # the module reads the converted layout: conv0 is features.0
        net = lp.LPIPS(dict(p))
    assert torch.equal(net.convs[0].weight,
                       torch.from_numpy(alexnet["features.0.weight"]))
    assert torch.equal(net.lin4, torch.from_numpy(
        heads["lin4.model.1.weight"].reshape(-1)))


def test_synthetic_cli_writes_the_npz(tmp_path):
    out = str(tmp_path / "lpips_alex.npz")
    conv.main(["--synthetic", out])
    with np.load(out) as f:
        w = conv.synthetic_weights(0)
        assert sorted(f.files) == sorted(w)
        assert all(np.array_equal(f[k], w[k]) for k in w)
        assert (f["lin2_w"] >= 0).all()


def test_get_lpips_fn_warns_once_and_caches(tmp_path):
    args = CfgNode(dict(output_root=str(tmp_path)))
    with pytest.warns(UserWarning, match="LPIPS weights not found"):
        assert lp.get_lpips_fn(args, "cpu") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert lp.get_lpips_fn(args, "cpu") is None
        os.makedirs(tmp_path / "model")
        np.savez(tmp_path / "model" / "lpips_alex.npz",
                 **conv.synthetic_weights(1))
        fn = lp.get_lpips_fn(args, "cpu")
        assert isinstance(fn, lp.LPIPS) and lp.get_lpips_fn(args, "cpu") is fn
    # one network is kept: another root's replaces it
    other = CfgNode(dict(output_root=str(tmp_path / "other")))
    os.makedirs(tmp_path / "other" / "model")
    np.savez(tmp_path / "other" / "model" / "lpips_alex.npz",
             **conv.synthetic_weights(2))
    assert lp.get_lpips_fn(other, "cpu") is not fn
    assert list(lp._CACHE.values()) == [lp.get_lpips_fn(other, "cpu")]


def test_reported_lpips_matches_jax(tmp_path):
    os.makedirs(tmp_path / "model")
    np.savez(tmp_path / "model" / "lpips_alex.npz",
             **conv.synthetic_weights(2))
    clean, noisy = _pair(seed=1)
    rec = (0.5 * (clean + noisy)).astype(np.float32)
    files = {}
    for name, rep, cfg, conv_in in (
            ("port", reporting, CfgNode, torch.from_numpy),
            ("jax", jrep, JaxCfg, jnp.asarray)):
        d = tmp_path / name
        d.mkdir()
        args = cfg(dict(output_root=str(tmp_path), save_path_ip=str(d),
                        batch=0, problem="denoising"))
        rep.compute_lpips(conv_in(clean), conv_in(noisy), conv_in(rec), args,
                          None, iter=3)
        files[name] = {w: (d / f"lpips_{w}_batch0.txt").read_text().split()
                       for w in ("rec", "noisy")}
    for w in ("rec", "noisy"):
        it_p, got = files["port"][w]
        it_j, want = files["jax"][w]
        assert it_p == it_j == "3"
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_restoration_writes_the_lpips_files(tmp_path):
    """With ``lpips_alex.npz`` present a CLI restoration reports LPIPS
    beside PSNR and SSIM, and averages it into ``final_lpips.txt``."""
    os.makedirs(tmp_path / "model")
    np.savez(tmp_path / "model" / "lpips_alex.npz",
             **conv.synthetic_weights(0))
    args = main(["--opts", "dataset", "synthetic", "dim_image", "32",
                 "eval", "True", "method", "pnp_flow", "problem",
                 "denoising", "steps_pnp", "1", "num_samples", "1",
                 "batch_size_ip", "1", "max_batch", "1", "output_root",
                 str(tmp_path), "device", "cpu"])
    for f in ("lpips_rec_batch0.txt", "lpips_noisy_batch0.txt",
              "lpips_rec_average.txt"):
        assert os.path.exists(os.path.join(args.save_path_ip, f)), f
    with open(os.path.join(args.save_path, "final_lpips.txt")) as f:
        header, row = f.readline().split(), f.readline().split()
    assert header[:2] == ["lpips_rec", "lpips_noisy"]
    assert all(np.isfinite(float(v)) for v in row[:2])
