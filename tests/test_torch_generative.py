"""The port's generative metrics and ``ComputeMetric`` against the JAX
package, and the four places the port departs from it on purpose.

Bounds: FID, KID, IS and SW on the same features within 1e-5 relative of
JAX's, Vendi within 1e-4 (float64 ``eigvalsh`` here, float32 in JAX); the 32x32
pixel features within 1e-6 (antialiased bilinear at 64² and 128²); the
``metrics.txt`` line of an end-to-end ``ComputeMetric`` (the small U-Net
of the JAX tests at 32², n = 16, Euler in 2 steps, pixel features, with
JAX's x0 and SW projections injected) within 1e-4 relative, value by
value.

Divergences (``metrics/generative.py``, notes (a)-(d)): (a) the generated
chunk cache is keyed on the weights, (b) both caches keep the Inception
provenance and the test cache the split, (c) a cached chunk without
``probs`` is recomputed while IS is scored, (d) Vendi takes the first 2048
samples, (e) Vendi runs in float64.
"""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from pnpflow_tpu.metrics import generative as jgen
from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.solvers.base import ModelBundle as JaxBundle
from pnpflow_tpu.utils.config import CfgNode as JaxCfg
from pnpflow_tpu_torch.metrics import generative as gen
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.utils.config import CfgNode
from pnpflow_tpu_torch.utils.jax_params import state_dict_from_flax

CFG = dict(input_channels=1, input_height=32, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,))
KEYS = ("FID", "KID", "KID_std", "Vendi", "SW")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and for the BLAS under scipy's
    ``sqrtm`` (its Schur recursion gains nothing from more): the test
    runner runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def _features(n=96, m=80, d=24, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = (0.8 * rng.normal(size=(m, d)) + 0.3).astype(np.float32)
    return a, b


def test_fid_matches_jax():
    a, b = _features()
    want = jgen.fid_from_features(jnp.asarray(a), jnp.asarray(b))
    got = gen.fid_from_features(a, b)
    assert want > 1.0 and _rel(got, want) <= 1e-5
    assert abs(gen.fid_from_features(a, a)) <= 1e-3


@pytest.mark.parametrize("block", [1024, 32])
def test_kid_matches_jax(block):
    a, b = _features()
    want = jgen.kid_from_features(a, b, max_block_size=block)
    got = gen.kid_from_features(a, b, max_block_size=block)
    assert _rel(got[0], want[0]) <= 1e-5
    assert (got[1] == want[1] == 0.0) if block == 1024 else (
        _rel(got[1], want[1]) <= 1e-5)


def test_inception_score_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(57, 20)) * 2
    p = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    want = jgen.inception_score(p)
    got = gen.inception_score(p)
    assert _rel(got[0], want[0]) <= 1e-5 and _rel(got[1], want[1]) <= 1e-5


def test_vendi_matches_jax():
    a, _ = _features(n=200, d=64)
    want = float(jgen.vendi_score(jnp.asarray(a)))
    got = gen.vendi_score(a)
    assert 1.0 < want < 200 and _rel(got, want) <= 1e-4
    assert abs(gen.vendi_score(np.ones((5, 3), np.float32)) - 1.0) <= 1e-5


def _vendi64(f):
    x = np.asarray(f, np.float64)
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    eig = np.linalg.eigvalsh(x @ x.T / len(x))
    eig = eig[eig > 1e-12]
    return float(np.exp(-(eig * np.log(eig)).sum()))


def test_vendi_is_float64_on_nearly_collinear_features():
    """(e): the entropy of nearly collinear features lies in eigenvalues
    below float32's resolution; JAX's float32 score misses the float64
    one by 1e-5 here, the port's agrees to rounding."""
    rng = np.random.default_rng(0)
    f = (np.abs(rng.normal(size=64)) + 0.002 * rng.normal(
        size=(128, 64))).astype(np.float32)
    want = _vendi64(f)
    assert _rel(gen.vendi_score(f), want) <= 1e-9
    assert _rel(float(jgen.vendi_score(jnp.asarray(f))), want) >= 5e-6


def test_sliced_wasserstein_matches_jax_with_its_projections():
    a, b = _features(n=96, m=70)
    want = float(jgen.sliced_wasserstein(jnp.asarray(a), jnp.asarray(b),
                                         key=jax.random.PRNGKey(0)))
    proj = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (24, 128),
                                        jnp.float32))
    got = gen.sliced_wasserstein(a, b, proj=proj)
    assert _rel(got, want) <= 1e-5
    # the default projections are the port's own draw: same estimator,
    # other directions
    other = gen.sliced_wasserstein(a, b)
    assert other != got and _rel(other, want) < 0.2


@pytest.mark.parametrize("dim,c", [(64, 3), (128, 1)])
def test_pixel_features_match_jax_resize(dim, c):
    x = np.random.default_rng(dim).uniform(size=(2, dim, dim, c)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 32, 32, c),
                                       method="bilinear")).reshape(2, -1)
    got = gen.pixel_features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def _unet_params():
    rng = np.random.default_rng(11)
    shapes = jax.eval_shape(JaxUNet(**CFG).init, jax.random.PRNGKey(0),
                            np.zeros((1, 32, 32, 1), np.float32),
                            np.zeros((1,), np.float32))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif "bias" in name:
            v = 0.1 * rng.normal(size=leaf.shape)
        else:
            v = 0.5 * rng.normal(size=leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _metric_line(path):
    with open(os.path.join(path, "results", "synthetic", "ot",
                           "metrics.txt")) as f:
        tok = f.read().splitlines()[-1].split()
    return dict(zip(tok[0::2], tok[1::2]))


def test_compute_metric_matches_jax_end_to_end(tmp_path):
    n, steps = 16, 2
    params = _unet_params()
    rng = np.random.default_rng(3)
    # test images apart from the samples (KID is a difference of kernel
    # means near 1: between close sets it cancels to where float32
    # summation order alone moves it by 1e-3 relative, in JAX as here)
    test = [(np.clip(0.5 + 0.5 * np.tanh(rng.normal(size=(16, 32, 32, 1))),
                     -1, 1).astype(np.float32), np.zeros(16))]
    base = dict(dataset="synthetic", model="ot", eval_split="test", seed=0,
                dim_image=32, num_channels=1, metric_sampler="euler")

    jroot = str(tmp_path / "jax") + "/"
    jm = JaxUNet(**CFG)
    jcm = jgen.ComputeMetric(
        {"test": test}, JaxBundle(apply=jm.apply, params=params, kind="ot"),
        JaxCfg(dict(base, output_root=jroot)))
    with pytest.warns(UserWarning, match="pixel features"):
        jcm.compute_metrics(n, steps=steps)
    want = _metric_line(jroot)

    # JAX's per-chunk x0: the key split once per chunk
    def jax_x0(i, shape):
        key = jax.random.PRNGKey(0)
        for _ in range(i + 1):
            key, sub = jax.random.split(key)
        return np.asarray(jax.random.normal(sub, shape, jnp.float32))

    model = VelocityUNet(**CFG, fused_norm=True)
    model.load_state_dict(state_dict_from_flax(params))
    proj = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                        (32 * 32, 128), jnp.float32))
    troot = str(tmp_path / "port")
    cm = gen.ComputeMetric(
        {"test": test}, ModelBundle(model=model.eval()),
        CfgNode(dict(base, output_root=troot)), x0_fn=jax_x0, sw_proj=proj)
    with pytest.warns(UserWarning, match="pixel features"):
        out = cm.compute_metrics(n, steps=steps)
    got = _metric_line(troot)
    assert got["n"] == want["n"] == "16"
    assert got["features"] == want["features"] == "pixels_32"
    for k in KEYS:
        print(k, got[k], want[k])
        assert _rel(float(got[k]), float(want[k])) <= 1e-4, k
    assert got["peak_mem_src"] == "ru_maxrss" and float(got["wall_s"]) > 0
    assert out["fid"] == float(got["FID"])


class _Scaled(torch.nn.Module):
    """dx/dt = -s x: a field whose samples depend on its one parameter."""

    def __init__(self, s):
        super().__init__()
        self.s = torch.nn.Parameter(torch.tensor(float(s)))

    def forward(self, x, t):
        return -self.s * x


def _cm(tmp_path, s=1.0, **over):
    rng = np.random.default_rng(0)
    test = [(rng.uniform(-1, 1, size=(24, 8, 8, 1)).astype(np.float32),
             np.zeros(24))]
    args = CfgNode(dict(dict(dataset="synthetic", model="ot",
                             eval_split="test", seed=0, dim_image=8,
                             num_channels=1, output_root=str(tmp_path)),
                        **over))
    return gen.ComputeMetric({args.eval_split: test},
                             ModelBundle(model=_Scaled(s)), args)


@pytest.fixture
def cheap_fid(monkeypatch):
    """The Fréchet distance's 1024² sqrtm is what these cache tests would
    spend their time on: a distance between the feature means stands in."""
    monkeypatch.setattr(gen, "fid_from_features", lambda a, b: float(
        (torch.as_tensor(a).mean(0) - torch.as_tensor(b).mean(0)).norm()))


def _probs_outputs(x01):
    f = gen.pixel_features(x01)
    return f, torch.softmax(f[:, :10] * 5, dim=1)


def test_generated_cache_is_keyed_on_the_weights(tmp_path, cheap_fid):
    """(a): a FID curve over training must not read the first
    checkpoint's samples again."""
    with pytest.warns(UserWarning):
        first = _cm(tmp_path, 1.0).compute_metrics(24, steps=2,
                                                   sampler="euler")
        again = _cm(tmp_path, 1.0).compute_metrics(24, steps=2,
                                                   sampler="euler")
        other = _cm(tmp_path, 0.5).compute_metrics(24, steps=2,
                                                   sampler="euler")
    assert again["resumed_chunks"] == 1 and again["fid"] == first["fid"]
    assert other["resumed_chunks"] == 0 and other["fid"] != first["fid"]


def test_uncached_run_writes_no_chunk(tmp_path, cheap_fid):
    """``cache=False`` (the trainer's FID curve) scores the same samples
    without reading or writing a generated chunk; the test features stay
    cached."""
    with pytest.warns(UserWarning):
        cached = _cm(tmp_path).compute_metrics(24, steps=2, sampler="euler")
        bare = _cm(tmp_path).compute_metrics(24, steps=2, sampler="euler",
                                             cache=False)
    assert bare["resumed_chunks"] == 0 and bare["fid"] == cached["fid"]
    cache = os.path.join(str(tmp_path), "results", "synthetic", "ot",
                         "metric_cache")
    shutil.rmtree(os.path.join(cache, next(
        d for d in os.listdir(cache) if d.startswith("s2_"))))
    with pytest.warns(UserWarning):
        _cm(tmp_path).compute_metrics(24, steps=2, sampler="euler",
                                      cache=False)
    assert [d[:5] for d in os.listdir(cache)] == ["test_"]


def test_caches_keep_provenance_and_split(tmp_path, cheap_fid):
    """(b): new Inception weights or another split never read the old
    features."""
    names = []
    for prov, split in (("a", "test"), ("b", "test"), ("a", "val")):
        cm = _cm(tmp_path, eval_split=split)
        cm._feature_fn = lambda p=prov: (
            gen.pixel_features, None, f"inception_2048[{p}]")
        out = cm.compute_metrics(24, steps=2, sampler="euler")
        names.append(out["resumed_chunks"])
    cache = os.path.join(str(tmp_path), "results", "synthetic", "ot",
                         "metric_cache")
    dirs = sorted(os.listdir(cache))
    assert sum(d.startswith("test_") for d in dirs) == 3
    assert "test_inception_2048-a_val_d8" in dirs
    assert sum(d.startswith("s2_") for d in dirs) == 2
    assert names == [0, 0, 1]      # the split leaves the samples alike


def test_chunk_without_probs_is_recomputed(tmp_path, cheap_fid):
    """(c): IS is scored on all n samples, never on fewer."""
    cm = _cm(tmp_path)
    cm._feature_fn = lambda: (gen.pixel_features, _probs_outputs,
                              "inception_2048[x]")
    first = cm.compute_metrics(24, steps=2, sampler="euler")
    cache = os.path.join(str(tmp_path), "results", "synthetic", "ot",
                         "metric_cache")
    sub = next(d for d in os.listdir(cache) if d.startswith("s2_"))
    chunk = os.path.join(cache, sub, "chunk_00000.npz")
    with np.load(chunk) as f:
        feats = f["feats"]
    np.savez(chunk, feats=feats)           # a chunk that lost its probs
    second = cm.compute_metrics(24, steps=2, sampler="euler")
    assert second["resumed_chunks"] == 0
    assert second["is"] == first["is"] and second["fid"] == first["fid"]
    third = cm.compute_metrics(24, steps=2, sampler="euler")
    assert third["resumed_chunks"] == 1


def test_vendi_takes_the_first_2048_samples(tmp_path, monkeypatch):
    """(d): the cut is kept, and said in the module's docstring."""
    rows = []
    monkeypatch.setattr(gen, "vendi_score",
                        lambda f, device=None: rows.append(len(f)) or 1.0)
    monkeypatch.setattr(gen, "fid_from_features", lambda a, b: 0.0)
    rng = np.random.default_rng(0)
    cm = _cm(tmp_path)
    cm.loaders = {"test": [(rng.uniform(-1, 1, size=(2100, 8, 8, 1)).astype(
        np.float32), np.zeros(2100))]}
    with pytest.warns(UserWarning):
        cm.compute_metrics(2100, steps=1, sampler="euler")
    assert rows == [gen.VENDI_MAX] == [2048]
    assert "2048" in gen.__doc__


def test_cli_compute_metrics_runs_before_the_restoration(tmp_path):
    from pnpflow_tpu_torch.main import main

    with pytest.warns(UserWarning, match="pixel features"):
        args = main(["--opts", "dataset", "synthetic", "dim_image", "16",
                     "num_channels", "1", "eval", "True", "compute_metrics",
                     "True", "metric_n", "4", "metric_steps", "1",
                     "metric_sampler", "euler", "method", "pnp_flow",
                     "problem", "denoising", "steps_pnp", "1",
                     "num_samples", "1", "batch_size_ip", "1", "max_batch",
                     "1", "output_root", str(tmp_path), "device", "cpu"])
    line = _metric_line(str(tmp_path))
    assert line["n"] == "4" and line["features"] == "pixels_32"
    assert all(np.isfinite(float(line[k])) for k in KEYS)
    assert float(line["FID"]) == args.metrics["fid"]
    seconds = args.metrics["seconds"]
    assert set(seconds) == {"test_features", "samples_and_features", "fid",
                            "kid_is_vendi_sw"}
    assert all(v >= 0 for v in seconds.values())
    assert sum(seconds.values()) <= float(line["wall_s"]) + 0.01
    assert os.path.exists(os.path.join(args.save_path, "final_psnr.txt"))
