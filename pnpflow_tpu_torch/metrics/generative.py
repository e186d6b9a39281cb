"""Generative metrics: FID, KID, Inception Score, Vendi score, sliced
Wasserstein (port of ``pnpflow_tpu/metrics/generative.py``).

The reference computes FID only (pnpflow/fid_score.py:21-197,
compute_metric.py:17-45); the JAX package adds KID, IS, Vendi and SW, and
the port keeps all five.  The activation statistics, KID and SW run in
float32 in torch on the device the features are on, as JAX's run on its
device, and Vendi there in float64 (note (e)); the matrix square root of
the Fréchet distance runs on the host in float64 (scipy ``sqrtm``, as
fid_score.py:74-128), and the Inception Score in
numpy float64.

Intended divergences from the JAX module, each held by a test in
``tests/test_torch_generative.py``:

(a) the generated-chunk cache is keyed on a fingerprint of the model's
    parameters, so a FID curve over training, or a re-evaluation after
    retraining, never reads another model's features (JAX's key has no
    identity of the weights: ADVICE.md, generative.py:336-344);
(b) both cache keys keep the Inception weights' provenance token, and the
    test-feature key keeps ``eval_split`` (JAX strips both);
(c) a cached chunk without ``probs`` is a miss while the Inception Score is
    computed (JAX accepts it and scores IS on fewer than n samples);
(d) Vendi runs on the first 2048 generated samples, as in JAX: an n x n
    eigendecomposition at n = 5000 costs more than the rest, and the cut is
    said here rather than hidden;
(e) Vendi runs in float64 (JAX: float32).  On nearly collinear features, as
    random or collapsed weights give, most of its entropy lies in
    eigenvalues below float32's resolution of K's largest, so a float32
    score depends on the device's rounding; float64 agrees to rounding.

The default SW projections come from a ``torch.Generator`` seeded 0, not
from ``jax.random.normal(PRNGKey(0))``: the two draw different directions,
so SW values agree with JAX's only where the projections are passed in
(``proj``).
"""

from __future__ import annotations

import hashlib
import os
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from pnpflow_tpu_torch.ops.ode import odeint
from pnpflow_tpu_torch.parallel import mesh
from pnpflow_tpu_torch.solvers.base import peak_memory_info

VENDI_MAX = 2048


def _atomic_savez(path: str, **arrays) -> None:
    """np.savez to a temporary file, then a rename, so a killed process
    never leaves a truncated chunk that a resumed run would trust."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _tensor(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# FID


def activation_statistics(features):
    """(mu, sigma) of (N, D) features in float32 (fid_score.py:131-156)."""
    f = _tensor(features)
    mu = f.mean(dim=0)
    centered = f - mu
    sigma = centered.T @ centered / (f.shape[0] - 1)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Fréchet distance with the reference's sqrtm stabilisation
    (fid_score.py:74-128): on a singular product, retry with eps*I added;
    strip a small imaginary part, raise on a large one."""
    from scipy import linalg

    def host(a):
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else a
        return np.asarray(a, np.float64)

    mu1, mu2, sigma1, sigma2 = map(host, (mu1, mu2, sigma1, sigma2))
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError("Imaginary component {}".format(m))
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_features(feat1, feat2) -> float:
    return frechet_distance(*activation_statistics(feat1),
                            *activation_statistics(feat2))


# ---------------------------------------------------------------------------
# Inception Score and KID


def inception_score(probs, splits: int = 10):
    """(mean, std) Inception Score from (N, K) class probabilities, tfgan's
    estimator (image_generation/evaluation.py:25,120-145): ``splits``
    near-equal groups, exp(E_x KL(p(y|x) || p(y))) per group."""
    p = np.asarray(probs, np.float64)
    n = p.shape[0]
    scores = []
    for i in range(splits):
        part = p[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-16) - np.log(py + 1e-16)),
                    axis=1)
        scores.append(np.exp(np.mean(kl)))
    scores = np.asarray(scores)
    std = scores.std(ddof=1) if len(scores) > 1 else 0.0
    return float(scores.mean()), float(std)


def _mmd2_unbiased(fx, fy):
    """Unbiased MMD² with tfgan's kernel k(x, y) = (x·y/d + 1)³."""
    d = fx.shape[1]
    kxx = (fx @ fx.T / d + 1.0) ** 3
    kyy = (fy @ fy.T / d + 1.0) ** 3
    kxy = (fx @ fy.T / d + 1.0) ** 3
    m, n = fx.shape[0], fy.shape[0]
    sum_xx = (kxx.sum() - kxx.trace()) / (m * (m - 1))
    sum_yy = (kyy.sum() - kyy.trace()) / (n * (n - 1))
    return sum_xx + sum_yy - 2.0 * kxy.mean()


def kid_from_features(feat_real, feat_gen, max_block_size: int = 1024,
                      device=None):
    """(mean, std) of per-block unbiased MMD² estimates in float32, tfgan's
    blocked estimator: both sets split into ceil(n / max_block_size) (n the
    smaller set's size) near-equal blocks."""
    fx, fy = _tensor(feat_real, device), _tensor(feat_gen, device)
    n = min(fx.shape[0], fy.shape[0])
    n_blocks = max(1, -(-n // max_block_size))
    ests = torch.stack([
        _mmd2_unbiased(
            fx[i * fx.shape[0] // n_blocks:(i + 1) * fx.shape[0] // n_blocks],
            fy[i * fy.shape[0] // n_blocks:(i + 1) * fy.shape[0] // n_blocks])
        for i in range(n_blocks)])
    std = (float(ests.std(unbiased=True)) / np.sqrt(n_blocks)
           if n_blocks > 1 else 0.0)
    return float(ests.mean()), float(std)


# ---------------------------------------------------------------------------
# Vendi score (Friedman & Dieng 2022): exp of the von Neumann entropy of
# K/n, K the cosine-similarity kernel of the features.


def vendi_score(features, device=None) -> float:
    """exp of the entropy of the eigenvalues of K/n, in float64 (note
    (e))."""
    x = torch.as_tensor(features, dtype=torch.float64, device=device)
    x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    k = x @ x.T / x.shape[0]
    eig = torch.linalg.eigvalsh(k).clamp_min(0.0)
    safe = torch.where(eig > 1e-12, eig, torch.ones_like(eig))
    ent = -torch.where(eig > 1e-12, eig * torch.log(safe),
                       torch.zeros_like(eig)).sum()
    return float(torch.exp(ent))


# ---------------------------------------------------------------------------
# Sliced Wasserstein distance (SW2): random 1-D projections, sorted
# quantiles compared in L2.


def sliced_wasserstein(x, y, proj=None, n_projections: int = 128,
                       device=None) -> float:
    """SW2 between two point clouds along ``proj``'s (d, n_projections)
    directions, each normalised here; by default standard normal ones from
    a CPU generator seeded 0."""
    x = _tensor(x, device).reshape(x.shape[0], -1)
    y = _tensor(y, x.device).reshape(y.shape[0], -1)
    if proj is None:
        proj = torch.randn((x.shape[1], n_projections),
                           generator=torch.Generator().manual_seed(0))
    proj = _tensor(proj, x.device)
    proj = proj / proj.norm(dim=0, keepdim=True).clamp_min(1e-12)
    px = torch.sort(x @ proj, dim=0).values
    py = torch.sort(y @ proj, dim=0).values
    n = min(px.shape[0], py.shape[0])
    # equal-size quantiles: subsample the longer cloud's
    if px.shape[0] != n:
        px = px[np.linspace(0, px.shape[0] - 1, n).astype(np.int32)]
    if py.shape[0] != n:
        py = py[np.linspace(0, py.shape[0] - 1, n).astype(np.int32)]
    return float(((px - py) ** 2).mean().sqrt())


# ---------------------------------------------------------------------------
# ComputeMetric (reference compute_metric.py:17-45)


def pixel_features(x01):
    """The fallback features: NHWC images in [0, 1] resized to 32x32 by
    antialiased bilinear interpolation (``jax.image.resize``'s), flattened
    in NHWC order."""
    b = x01.shape[0]
    if x01.shape[1:3] != (32, 32):
        x01 = F.interpolate(x01.float().permute(0, 3, 1, 2), size=(32, 32),
                            mode="bilinear", align_corners=False,
                            antialias=True).permute(0, 2, 3, 1)
    return x01.reshape(b, -1)


def params_fingerprint(model) -> str:
    """A hash of the model's parameters and buffers, bit for bit."""
    h = hashlib.blake2b(digest_size=12)
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _safe(token: str) -> str:
    return token.replace("[", "-").replace("]", "").replace("/", "_")


class ComputeMetric:
    """FID, KID, IS, Vendi and SW of samples of the flow ODE against the
    test split.

    The reference protocol: Inception-2048 statistics of n test images
    against n samples of the flow from noise by adaptive dopri5 at rtol =
    atol = 1e-5 (``args.metric_sampler`` picks euler, midpoint or heun with
    ``steps`` fixed steps).  Without ``inception_fid.npz`` the features are
    the 32x32 pixels, with a warning, as in JAX.

    The sampling and feature batch is min(50, n).  Chunk i's x0 is the i-th
    draw of a ``torch.Generator`` seeded ``args.seed`` on the model's
    device, drawn whether or not the chunk is cached, so the sequence is
    the same for any n with the same batch.  ``devices`` (default: every
    visible card, the model's first, or its card alone under a process
    group; on the CPU the CPU) fans the work out
    as JAX shards it over its mesh: each chunk's x0 is split over a copy of
    the model on each device and the Inception network's sub-batches over a
    copy of it on each (``parallel/mesh.py``), so the samples and features
    are those of one device.  dopri5 samples on the model's device alone:
    its step-size controller takes the error over the whole chunk, so
    shards with steps of their own would be another sampler.  ``x0_fn(i, shape)`` replaces those draws and
    ``sw_proj`` the SW projections: the seams through which a test gives
    both packages the same inputs.  Test features and each generated
    chunk's features are cached under ``results/{dataset}/{model}/
    metric_cache``, so an interrupted run resumes; see the module's notes
    (a)-(c) on the keys.
    """

    def __init__(self, data_loaders, bundle, args, x0_fn=None, sw_proj=None,
                 devices=None):
        self.loaders = data_loaders
        self.bundle = bundle
        self.args = args
        self.device = dev = bundle.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if devices is None and mesh.is_distributed():
            # rank 0's FID curve: the other cards belong to other ranks
            devices = [dev]
        elif devices is None:
            devices = mesh.devices(None, dev)
            devices = [dev] + [d for d in devices if d != dev]
        self.devices = [torch.device(d) for d in devices]
        self.x0_fn = x0_fn
        self.sw_proj = sw_proj
        self._replicas = None

    def _feature_fn(self):
        """(feature_fn, outputs_fn or None, feature-space name)."""
        from pnpflow_tpu_torch.models.inception import (
            get_inception_fns, inception_path)

        fns = get_inception_fns(self.args, device=self.device,
                                devices=self.devices)
        if fns is not None:
            # the weights' provenance rides in the token, so a metrics.txt
            # line names the weights it was scored with
            name = "inception_2048"
            with np.load(inception_path(self.args)) as f:
                if "provenance" in f.files:
                    name += "[{}]".format(str(f["provenance"]))
            return fns[0], fns[1], name
        warnings.warn(
            "Inception FID weights unavailable — falling back to "
            "32x32-downsampled pixel features for relative comparison.")
        return pixel_features, None, "pixels_32"

    def _sample_batch(self, x0, steps: int, sampler: str):
        """One batch of samples of the flow ODE from x0, t = 0 to 1, its
        rows split over the devices (dopri5: on the model's device)."""
        def sample(model, x):
            def f(x, t):
                return model(x, torch.full((x.shape[0],), t,
                                           dtype=torch.float32,
                                           device=x.device))

            return odeint(f, x, 0.0, 1.0, method=sampler, steps=steps)

        if sampler == "dopri5" or len(self.devices) == 1:
            return sample(self.bundle.forward, x0)
        if self._replicas is None:
            self._replicas = mesh.replicate(self.bundle.model, self.devices)

        def run(k, part):
            with torch.inference_mode(), mesh.on(self.devices[k]):
                return sample(self._replicas[k], part)

        parts = [p.to(d) for p, d in zip(
            torch.tensor_split(x0, len(self.devices)), self.devices)
            if p.shape[0]]
        return mesh.gather(mesh.fan_out(run, parts), x0.device)

    def _test_features(self, feature_fn, feat_name, n, batch):
        args = self.args
        split = args.eval_split
        tdir = os.path.join(
            args.output_root, "results", args.dataset, args.model,
            "metric_cache", "test_{}_{}_d{}".format(
                _safe(feat_name), split, args.dim_image))
        os.makedirs(tdir, exist_ok=True)
        tpath = os.path.join(tdir, "feats_n{}.npz".format(n))
        if os.path.exists(tpath):
            with np.load(tpath) as tf:
                return tf["feats"]
        feats, count = [], 0
        for x, _ in self.loaders[split]:
            x = np.asarray(x, np.float32)[:n - count]
            for i in range(0, len(x), batch):
                chunk = torch.as_tensor(x[i:i + batch], device=self.device)
                feats.append(feature_fn((chunk + 1.0) / 2.0).cpu().numpy())
            count += len(x)
            if count >= n:
                break
        feats = np.concatenate(feats, axis=0)[:n]
        _atomic_savez(tpath, feats=feats)
        return feats

    @torch.inference_mode()
    def compute_metrics(self, n: int, steps: int = 100,
                        sampler: str | None = None, cache: bool = True):
        """Score n samples and append the ``metrics.txt`` line.  ``cache``
        False neither reads nor writes the generated chunks (the test
        features stay cached): the trainer's FID curve, whose every call
        scores new weights, so that a chunk written could never be read."""
        t0 = time.perf_counter()
        args = self.args
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        feature_fn, outputs_fn, feat_name = self._feature_fn()
        method = (sampler or getattr(args, "metric_sampler", "dopri5")
                  or "dopri5")
        batch = min(50, n)
        feat_test = self._test_features(feature_fn, feat_name, n, batch)
        t_test = time.perf_counter()

        seed = int(getattr(args, "seed", 0) or 0)
        cache_dir = None
        if cache:
            cache_dir = os.path.join(
                args.output_root, "results", args.dataset, args.model,
                "metric_cache", "s{}_{}_{}_b{}_seed{}_w{}".format(
                    steps, method, _safe(feat_name), batch, seed,
                    params_fingerprint(self.bundle.model)))
            os.makedirs(cache_dir, exist_ok=True)
        gen = torch.Generator(device=dev).manual_seed(seed)
        shape = (batch, args.dim_image, args.dim_image, args.num_channels)
        gen_feats, gen_probs = [], []
        resumed = 0
        n_chunks = (n + batch - 1) // batch
        for i in range(n_chunks):
            x0 = (_tensor(self.x0_fn(i, shape), dev)
                  if self.x0_fn is not None else
                  torch.randn(shape, generator=gen, device=dev))
            cpath = (os.path.join(cache_dir, "chunk_{:05d}.npz".format(i))
                     if cache else None)
            if cache and os.path.exists(cpath):
                with np.load(cpath) as cf:
                    # (c): without probs the chunk cannot serve IS
                    if outputs_fn is None or "probs" in cf.files:
                        gen_feats.append(cf["feats"])
                        if outputs_fn is not None:
                            gen_probs.append(cf["probs"])
                        resumed += 1
                        continue
            samples = self._sample_batch(x0, steps, method)
            s01 = ((samples.float() + 1.0) / 2.0).clamp(0.0, 1.0)
            if outputs_fn is not None:
                f, p = outputs_fn(s01)
                gen_feats.append(f.cpu().numpy())
                gen_probs.append(p.cpu().numpy())
                if cache:
                    _atomic_savez(cpath, feats=gen_feats[-1],
                                  probs=gen_probs[-1])
            else:
                gen_feats.append(feature_fn(s01).cpu().numpy())
                if cache:
                    _atomic_savez(cpath, feats=gen_feats[-1])
            if (i + 1) % 10 == 0 or i + 1 == n_chunks:
                print("  sampled {}/{} ({:.0f}s)".format(
                    min((i + 1) * batch, n), n, time.perf_counter() - t0),
                    flush=True)
        feat_gen = np.concatenate(gen_feats, axis=0)[:n]
        t_gen = time.perf_counter()

        fid = fid_from_features(_tensor(feat_test, dev),
                                _tensor(feat_gen, dev))
        t_fid = time.perf_counter()
        kid, kid_std = kid_from_features(feat_test, feat_gen, device=dev)
        is_mean = is_std = None
        if gen_probs:
            is_mean, is_std = inception_score(
                np.concatenate(gen_probs, axis=0)[:n])
        # (d): the first VENDI_MAX samples
        vendi = vendi_score(feat_gen[:VENDI_MAX], device=dev)
        # SW in the feature space of FID
        sw = sliced_wasserstein(feat_gen, feat_test, proj=self.sw_proj,
                                device=dev)

        wall_s = time.perf_counter() - t0
        peak_b, peak_src = peak_memory_info(dev)
        peak_mb = peak_b / 2 ** 20
        path = os.path.join(args.output_root, "results", args.dataset,
                            args.model)
        os.makedirs(path, exist_ok=True)
        line = "n {} features {} FID {} KID {} KID_std {} Vendi {} SW {}"\
            .format(n, feat_name, fid, kid, kid_std, vendi, sw)
        if is_mean is not None:
            line += " IS {} IS_std {}".format(is_mean, is_std)
        line += " wall_s {:.2f} peak_mem_MiB {:.1f} peak_mem_src {}".format(
            wall_s, peak_mb, peak_src)
        if resumed:
            # wall_s is this process's work; resumed_chunks says how many
            # chunks came from an earlier run's cache
            line += " resumed_chunks {}/{}".format(resumed, n_chunks)
        with open(os.path.join(path, "metrics.txt"), "a") as f:
            f.write(line + "\n")
        # host-clock seconds by part (each part ends in a device read)
        seconds = {"test_features": t_test - t0,
                   "samples_and_features": t_gen - t_test,
                   "fid": t_fid - t_gen,
                   "kid_is_vendi_sw": t0 + wall_s - t_fid}
        out = {"fid": fid, "kid": kid, "kid_std": kid_std, "vendi": vendi,
               "sw": sw, "wall_s": wall_s, "peak_mem_mib": peak_mb,
               "features": feat_name, "resumed_chunks": resumed,
               "seconds": seconds}
        if is_mean is not None:
            out["is"] = is_mean
            out["is_std"] = is_std
        return out
