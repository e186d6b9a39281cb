"""Result reporting in the reference's txt / result-dir layout.

Port of ``pnpflow_tpu/utils/reporting.py``: per-batch
``psnr_rec_batch{b}.txt`` rows of ``iter value`` (and ``ssim_*``,
``lpips_*``), per-metric ``*_average.txt``, and ``final_*.txt`` tables whose
header row names the method hyperparameters.  PSNR and SSIM run in float32
on host copies of the images, LPIPS in float32 on their device.  Image grids are PNGs written by a small numpy + zlib encoder;
per-image ``.eps`` files need matplotlib and are skipped with a warning
without it.
"""

from __future__ import annotations

import ast
import math
import os
import struct
import warnings
import zlib
from collections import defaultdict

import numpy as np
import torch

from pnpflow_tpu_torch.metrics import lpips as lpips_mod
from pnpflow_tpu_torch.metrics.image_quality import psnr as _psnr
from pnpflow_tpu_torch.metrics.image_quality import ssim as _ssim


_SR_PROBLEMS = ("superresolution", "superresolution_bicubic")


def _host(img):
    return img.detach().to("cpu", torch.float32)


def _noisy_view(noisy_img, args, H_adj):
    """The measurement as an image: super-resolution measurements are
    smaller than the image, so they are shown through ``H_adj``."""
    if getattr(args, "problem", None) in _SR_PROBLEMS:
        if H_adj is None:
            raise ValueError(f"{args.problem} reporting needs H_adj")
        return H_adj(noisy_img)
    return noisy_img


def _metric_pair(metric_fn, clean_img, noisy_img, rec_img):
    clean = (_host(clean_img) + 1.0) / 2.0
    rec = (_host(rec_img) + 1.0) / 2.0
    noisy = (_host(noisy_img) + 1.0) / 2.0
    return (float(metric_fn(rec, clean, data_range=1.0)),
            float(metric_fn(noisy, clean, data_range=1.0)))


def _append(path, line):
    with open(path, "a") as f:
        f.write(line + "\n")


def _report(name, metric_fn, clean_img, noisy_img, rec_img, args, H_adj,
            iter):
    rec, noisy = _metric_pair(metric_fn, clean_img,
                              _noisy_view(noisy_img, args, H_adj), rec_img)
    for word, value in (("rec", rec), ("noisy", noisy)):
        _append(
            os.path.join(args.save_path_ip,
                         f"{name}_{word}_batch{args.batch}.txt"),
            f"{iter} {value}",
        )
    return rec


def compute_psnr(clean_img, noisy_img, rec_img, args, H_adj=None,
                 iter="final"):
    return _report("psnr", _psnr, clean_img, noisy_img, rec_img, args, H_adj,
                   iter)


def compute_ssim(clean_img, noisy_img, rec_img, args, H_adj=None,
                 iter="final"):
    return _report("ssim", _ssim, clean_img, noisy_img, rec_img, args, H_adj,
                   iter)


def compute_lpips(clean_img, noisy_img, rec_img, args, H_adj=None,
                  iter="final"):
    """LPIPS (AlexNet) of the restored and of the measured image against
    the clean one, on the images' device, with the converted weights at
    ``{output_root}/model/lpips_alex.npz``; skipped with one warning when
    that file is absent."""
    fn = lpips_mod.get_lpips_fn(args, device=clean_img.device)
    if fn is None:
        return None
    noisy_img = _noisy_view(noisy_img, args, H_adj)
    with torch.inference_mode():
        # JAX's order of operations: to [0, 1], then back to [-1, 1]
        clean, noisy, rec = (2.0 * ((img.detach().float() + 1.0) / 2.0) - 1.0
                             for img in (clean_img, noisy_img, rec_img))
        values = {"rec": float(fn(clean, rec)),
                  "noisy": float(fn(clean, noisy))}
    for word, value in values.items():
        _append(os.path.join(args.save_path_ip,
                             f"lpips_{word}_batch{args.batch}.txt"),
                f"{iter} {value}")
    return values["rec"]


def _compute_average(metric_name, args):
    """Aggregate per-batch txt files into ``{metric}_{word}_average.txt`` and
    a ``final_{metric}.txt`` row keyed by the method hyperparameters."""
    finals = {}
    for word in ["rec", "noisy"]:
        by_iteration = defaultdict(list)
        for batch in range(args.max_batch):
            filename = os.path.join(
                args.save_path_ip, f"{metric_name}_{word}_batch{batch}.txt"
            )
            if not os.path.exists(filename):
                return  # metric never produced (e.g. lpips without weights)
            with open(filename) as f:
                for line in f:
                    iteration, value = line.strip().split()
                    by_iteration[int(float(iteration))].append(float(value))
        averages = {it: float(np.mean(v)) for it, v in by_iteration.items()}
        avg_filename = os.path.join(
            args.save_path_ip, f"{metric_name}_{word}_average.txt"
        )
        with open(avg_filename, "a") as f:
            for it, avg in sorted(averages.items()):
                f.write(f"{it} {avg:.4f}\n")
        with open(avg_filename) as f:
            finals[word] = float(f.readlines()[-1].split()[1])

    final_path = os.path.join(args.save_path, f"final_{metric_name}.txt")
    write_header = (
        not os.path.exists(final_path) or os.stat(final_path).st_size == 0
    )
    with open(final_path, "a") as f:
        if write_header:
            f.write(f"{metric_name}_rec ")
            f.write(f"{metric_name}_noisy ")
            for key in args.dict_cfg_method.keys():
                f.write(f"{key} ")
            f.write("\n")
        f.write(f"{finals['rec']} ")
        f.write(f"{finals['noisy']} ")
        for value in args.dict_cfg_method.values():
            f.write(f"{value} ")
        f.write("\n")


def compute_average_psnr(args):
    _compute_average("psnr", args)


def compute_average_ssim(args):
    _compute_average("ssim", args)


def compute_average_lpips(args):
    _compute_average("lpips", args)


def save_time_use(dict_time, args):
    _append(os.path.join(args.save_path_ip, "time_stats.txt"), str(dict_time))


def save_memory_use(dict_mem, args):
    _append(os.path.join(args.save_path_ip, "memory_stats.txt"), str(dict_mem))


def _average_stat(args, stats_file, value_key, out_file, label):
    values = np.zeros(args.max_batch)
    filename = os.path.join(args.save_path_ip, stats_file)
    with open(filename) as f:
        lines = [ast.literal_eval(line.strip()) for line in f]
    for batch in range(args.max_batch):
        for data in lines:
            if data["batch"] == batch:
                values[batch] = data[value_key]
                break
    _append(
        os.path.join(args.save_path_ip, out_file),
        f"{label}: {values.mean():.4f}",
    )


def compute_average_time(args):
    _average_stat(args, "time_stats.txt", "time_per_batch",
                  "time_average.txt", "average time")


def compute_average_memory(args):
    _average_stat(args, "memory_stats.txt", "max_allocated",
                  "max_memory_average.txt", "average mem")


def write_png(path, img: np.ndarray):
    """8-bit grayscale or RGB PNG of an (H, W, C) array in [0, 1]."""
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"PNG needs 1 or 3 channels, got {c}")
    px = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), px.reshape(h, w * c)], axis=1)

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def _grid(imgs: np.ndarray, pad: int = 2) -> np.ndarray:
    """Tile (B, H, W, C) into the reference's column-major grid."""
    b, h, w, c = imgs.shape
    cols = max(int(math.sqrt(b)), 1)
    rows = max(b // cols, 1)
    out = np.ones((rows * (h + pad) + pad, cols * (w + pad) + pad, c),
                  np.float32)
    for i in range(rows):
        for j in range(cols):
            idx = i + j * rows
            if idx < b:
                y0, x0 = pad + i * (h + pad), pad + j * (w + pad)
                out[y0:y0 + h, x0:x0 + w] = imgs[idx]
    return out


def _save_eps(args, clean, noisy, rec, iter):
    """Per-image .eps files of the first test batches (PSNR in the name)."""
    try:
        import matplotlib
    except ImportError:
        warnings.warn("matplotlib is not installed: per-image .eps files "
                      "are not written")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def psnr_of(a, b):
        mse = float(np.mean((a - b) ** 2))
        return 10.0 * math.log10(1.0 / max(mse, 1e-20))

    def save_one(img2d, fname):
        fig = plt.figure()
        shown = np.clip(img2d, 0, 1)
        if shown.shape[-1] == 1:
            plt.imshow(shown[..., 0], cmap="gray", vmin=0, vmax=1)
        else:
            plt.imshow(shown)
        plt.axis("off")
        fig.savefig(os.path.join(args.save_path_ip, fname),
                    bbox_inches="tight", pad_inches=0)
        plt.close(fig)

    p = args.problem
    for i in range(clean.shape[0]):
        if args.method == "pnp_flow":
            save_one(clean[i], f"{p}_clean_batch{args.batch}_im{i}.eps")
            save_one(noisy[i], "{}_noisy_batch{}_im{}_pnsr{:4.2f}.eps".format(
                p, args.batch, i, psnr_of(clean[i], noisy[i])))
        save_one(rec[i], "{}_{}_batch{}_im{}_iter{}_pnsr{:4.2f}.eps".format(
            p, args.method, args.batch, i, iter, psnr_of(clean[i], rec[i])))


def save_images(clean_img, noisy_img, rec_img, args, H_adj=None,
                iter="final"):
    """Final clean / noisy / restored grids as PNG, plus per-image .eps
    files for the first test batches (batch < 4, or < 8 for d_flow)."""
    clean = (_host(clean_img).numpy() + 1.0) / 2.0
    noisy = (_host(_noisy_view(noisy_img, args, H_adj)).numpy() + 1.0) / 2.0
    rec = (_host(rec_img).numpy() + 1.0) / 2.0
    first = args.batch < (8 if args.method == "d_flow" else 4)
    if getattr(args, "eval_split", None) == "test" and first:
        _save_eps(args, clean, noisy, rec, iter)
    for name, img in zip(["clean", "noisy", args.method], [clean, noisy, rec]):
        write_png(os.path.join(
            args.save_path_ip,
            f"{args.problem}_{name}_batch{args.batch}_{iter}.png"), _grid(img))
