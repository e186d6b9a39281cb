#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which exits non-zero on
failure (nothing is caught and passed over) and prints its seconds:

1. setup: card name and power limit, versions, TF32 flags, optional modules;
2. build: the CUDA kernels, from the sources in the checkout, one nvcc each;
3. sites: the shapes each kernel sees in one forward of the flagship U-Net
   (64x64, ch 32, mult 1,2,4,8, 6 blocks, attention at 16 and 8) and of the
   rectified NCSN++ (256x256, nf 128, mult 1,1,2,2,2,2,2, 2 blocks,
   attention at 16);
4. kernel parity: each kernel against its plain PyTorch version at every
   site, at the main-path batch of 20 images, in float32 and bf16, plus
   every epilogue combination of the conv kernel;
5. model parity: the random flagship U-Net with ``fused_norm`` True, "bm"
   and "conv" against False, and the random NCSN++ 256^2 on the card
   against the same weights on the CPU;
6. main path: the port's CLI, pnp_flow on synthetic images -- the U-Net at
   64x64 (FFT deblur; "conv" fp32 at 100 steps, "conv" bf16, True and "bm"
   at 10) and the rectified NCSN++ at 256x256 (FFT deblur fp32 at 100 steps,
   bf16 at 10, super-resolution at 10) -- with every launch counter set to
   0 before each run and read after;
7. timing: CUDA-event times of each kernel, its plain version and the
   PyTorch library call, per forward at the bench shapes (U-Net: 64x64, 64
   images x 5 Monte-Carlo samples; NCSN++: 256x256, 4 x 5), the forwards
   per mode, PnP steps and the peak memory of a rectified step, with a
   torch.profiler kernel breakdown of one float32 NCSN++ forward.

JSON lines precede the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12                     # H100 SXM HBM3 bytes/s
PEAK = {"float32": 67e12, "bfloat16": 989e12}   # FLOP/s, dense
FLAGSHIP = dict(input_channels=3, input_height=64, ch=32,
                ch_mult=(1, 2, 4, 8), num_res_blocks=6,
                attn_resolutions=(16, 8))
RECT_DIM = 256          # the NCSN++ 256^2 (CelebA-HQ / AFHQ-Cat) defaults
RECT_FIR_SITES = 36     # upfirdn2d calls per NCSN++ 256^2 forward
CLI_STEPS = 100         # main-path PnP steps: the CLI default
MAIN_BATCH = 4 * 5      # batch_size_ip x num_samples: images per forward
BENCH_BATCH = 64 * 5    # the bench protocol: 64 images x 5 MC samples
NCSNPP_REL_TOL = 1e-4   # NCSN++ card vs CPU, relative to max|out|, fp32
KERNELS = ("conv3x3_gn", "groupnorm_swish", "groupnorm_swish_bm",
           "upfirdn2d")


def fail(msg):
    print("chip_smoke FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        fail(msg)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    emit({"phase": name, "seconds": time.perf_counter() - t0})


def launch_counters():
    """name -> the wrapper whose ``.launches`` counts that kernel."""
    from pnpflow_tpu_torch.ops.fused_conv_gn import conv3x3_gn
    from pnpflow_tpu_torch.ops.gn_swish import groupnorm_swish_fwd
    from pnpflow_tpu_torch.ops.gn_swish_bm import groupnorm_swish_bm_fwd
    from pnpflow_tpu_torch.ops.upfirdn import upfirdn2d

    return {"conv3x3_gn": conv3x3_gn, "groupnorm_swish": groupnorm_swish_fwd,
            "groupnorm_swish_bm": groupnorm_swish_bm_fwd,
            "upfirdn2d": upfirdn2d}


def reset_counts():
    for fn in launch_counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in launch_counters().items()}


def only(**counts):
    return {k: counts.get(k, 0) for k in KERNELS}


# ---------------------------------------------------------------- 1. setup
def setup(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi failed: " + smi.stderr)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from pnpflow_tpu_torch.device import set_fp32_parity_mode

    flags = set_fp32_parity_mode()
    mods = {m: importlib.util.find_spec(m) is not None
            for m in ("yaml", "matplotlib", "PIL", "pandas", "msgpack",
                      "triton", "cv2")}
    emit({"setup": {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda, "python": sys.version.split()[0],
                    "tf32": flags, "importable": mods}})
    check(mods["triton"], "triton is not importable")
    return card


# ---------------------------------------------------------------- 2. build
def build():
    from pnpflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    for name, res in logs.items():
        print(f"--- nvcc {name} ({res['seconds']:.1f} s)")
        print(res["log"].strip())
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "built": sorted(logs)}})


# ---------------------------------------------------------------- 3. sites
def unet_sites(torch, dev):
    """Record, with forward hooks on a batch-1 plain forward, the shapes each
    kernel sees in one flagship forward: GroupNorm sites (hw, c, swish) and
    conv sites (hw, cin, cout, prologue, sample_bias, residual)."""
    from pnpflow_tpu_torch.models.unet import (
        ResidualBlock, SelfAttention, VelocityUNet)

    m = VelocityUNet(**FLAGSHIP).to(dev).eval()
    gn, conv = [], [(64, 3, 32, False, False, False)]

    def block_hook(mod, inp):
        _, h, _, cin = inp[0].shape
        cout = mod.conv1.out_channels
        gn.extend([(h, cin, True), (h, cout, True)])
        conv.extend([(h, cin, cout, True, True, False),
                     (h, cout, cout, True, False, True)])

    def attn_hook(mod, inp):
        gn.append((inp[0].shape[1], inp[0].shape[-1], False))

    for mod in m.modules():
        if isinstance(mod, ResidualBlock):
            mod.register_forward_pre_hook(block_hook)
        elif isinstance(mod, SelfAttention):
            mod.register_forward_pre_hook(attn_hook)
    with torch.no_grad():
        m(torch.zeros(1, 64, 64, 3, device=dev), torch.zeros(1, device=dev))
    gn.append((64, 32, True))  # end_norm
    check(len(gn) == 136 and len(conv) == 109,
          f"site count {len(gn)} / {len(conv)}")
    return gn, conv


def fir_sites(torch, dev):
    """Record every ``upfirdn2d`` call of one batch-1 NCSN++ 256^2 forward:
    (h, w, c, up, down, pad0, pad1, taps) with the taps as a tuple."""
    from pnpflow_tpu_torch.models.ncsnpp import NCSNpp
    from pnpflow_tpu_torch.ops import upfirdn as upfirdn_mod

    real, sites = upfirdn_mod.upfirdn2d, []

    def record(x, k, up=1, down=1, pad=(0, 0)):
        _, h, w, c = x.shape
        sites.append((h, w, c, up, down, int(pad[0]), int(pad[1]),
                      tuple(tuple(float(v) for v in row) for row in k)))
        return real(x, k, up, down, pad)

    # the wrapper counts through its module-level name, which is `record`
    # while it is patched in
    record.launches = 0
    m = NCSNpp(image_size=RECT_DIM).to(dev).eval()
    upfirdn_mod.upfirdn2d = record
    try:
        with torch.inference_mode():
            m(torch.zeros(1, RECT_DIM, RECT_DIM, 3, device=dev),
              torch.full((1,), 500.0, device=dev))
    finally:
        upfirdn_mod.upfirdn2d = real
    ups = sum(s[3] > 1 for s in sites)
    check(len(sites) == RECT_FIR_SITES and ups == RECT_FIR_SITES // 2,
          f"NCSN++ FIR sites {len(sites)} ({ups} up)")
    return sites


# ----------------------------------------------------- inputs for one site
def gn_inputs(torch, dev, n, h, c, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, h, h, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    scale = torch.randn(c, generator=g, device=dev) * 0.2 + 1.0
    bias = torch.randn(c, generator=g, device=dev) * 0.1
    return x, scale, bias


def conv_inputs(torch, dev, n, site, dtype, seed):
    from pnpflow_tpu_torch.ops.fused_conv_gn import channel_moments, gn_prologue

    h, cin, cout, pro, sb, res = site
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, h, h, cin, generator=g, device=dev) + 0.3).to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=g, device=dev)
         / (9 * cin) ** 0.5).to(dtype)
    b = torch.randn(cout, generator=g, device=dev) * 0.1
    kw = {}
    if pro:
        groups = 32 if cin % 32 == 0 else 1
        scale = torch.randn(cin, generator=g, device=dev) * 0.2 + 1.0
        bias = torch.randn(cin, generator=g, device=dev) * 0.1
        kw["prologue"] = gn_prologue(channel_moments(x), h * h, scale, bias,
                                     groups)
    if sb:
        kw["sample_bias"] = torch.randn(n, cout, generator=g, device=dev)
    if res:
        kw["residual"] = torch.randn(n, h, h, cout, generator=g,
                                     device=dev).to(dtype)
    return (x, w, b), kw


def fir_inputs(torch, dev, n, site, dtype, seed):
    import numpy as np

    h, w, c, up, down, p0, p1, taps = site
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g, device=dev).to(dtype)
    return x, np.asarray(taps, np.float32), dict(up=up, down=down,
                                                 pad=(p0, p1))


# -------------------------------------------------------- 4. kernel parity
def kernel_parity(torch, dev, gn_sites, conv_sites, firs):
    from pnpflow_tpu_torch.ops.fused_conv_gn import (
        conv3x3_gn, conv3x3_gn_reference)
    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_swish_reference, groupnorm_swish_fwd)
    from pnpflow_tpu_torch.ops.gn_swish_bm import groupnorm_swish_bm_fwd
    from pnpflow_tpu_torch.ops.upfirdn import upfirdn2d, upfirdn2d_reference

    n = MAIN_BATCH
    err = {k: 0.0 for k in KERNELS}
    for name, fn, ref in (
            ("groupnorm_swish", groupnorm_swish_fwd, gn_swish_reference),
            ("groupnorm_swish_bm", groupnorm_swish_bm_fwd,
             gn_swish_reference)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            for i, (h, c, swish) in enumerate(sorted(set(gn_sites))):
                x, s, b = gn_inputs(torch, dev, n, h, c, dtype, i)
                got = fn(x, s, b, 32, 1e-6, swish)
                torch.cuda.synchronize()
                want = ref(x, s, b, 32, 1e-6, swish)
                d = float((got.float() - want.float()).abs().max())
                check(got.dtype == dtype and d <= tol,
                      f"{name} {dtype} at {(h, c, swish)}: err {d}")
                if dtype == torch.float32:
                    err[name] = max(err[name], d)

    combos = [(32, 64, 64, p, s, r) for p in (False, True)
              for s in (False, True) for r in (False, True)]
    sites = sorted(set(conv_sites) | set(combos))
    for dtype, ytol, mtol in ((torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, 2e-2, 2e-2)):
        for i, site in enumerate(sites):
            args, kw = conv_inputs(torch, dev, n, site, dtype, 100 + i)
            for emit_m in ((True, False) if site in combos else (True,)):
                y, m = conv3x3_gn(*args, emit_moments=emit_m, **kw)
                torch.cuda.synchronize()
                y2, m2 = conv3x3_gn_reference(*args, emit_moments=emit_m,
                                              **kw)
                scale = float(y2.float().abs().max())
                d = float((y.float() - y2.float()).abs().max())
                check(y.dtype == dtype and d <= ytol * scale,
                      f"conv3x3_gn {dtype} at {site}: y err {d} "
                      f"(max|y| {scale})")
                if emit_m:
                    for k in range(2):
                        ref = float(m2[:, k].abs().max())
                        dm = float((m[:, k] - m2[:, k]).abs().max())
                        check(dm <= mtol * ref,
                              f"conv3x3_gn {dtype} at {site}: moment {k} "
                              f"err {dm} (max {ref})")
                else:
                    check(m is None, "moments returned when not asked")
                if dtype == torch.float32:
                    err["conv3x3_gn"] = max(err["conv3x3_gn"], d)

    # fp32: atol 1e-5 (16 fp32 products of O(1) values); bf16: one bf16
    # rounding of outputs below 4, where an ulp is 2^-6
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for i, site in enumerate(sorted(set(firs))):
            x, k, kw = fir_inputs(torch, dev, n, site, dtype, 200 + i)
            got = upfirdn2d(x, k, **kw)
            torch.cuda.synchronize()
            want = upfirdn2d_reference(x, k, **kw)
            d = float((got.float() - want.float()).abs().max())
            check(got.dtype == dtype and got.shape == want.shape
                  and d <= tol, f"upfirdn2d {dtype} at {site[:7]}: err {d}")
            if dtype == torch.float32:
                err["upfirdn2d"] = max(err["upfirdn2d"], d)
    emit({"kernel_parity": {"gn_sites": len(set(gn_sites)),
                            "conv_sites": len(sites),
                            "fir_sites": len(set(firs)), "batch": n,
                            "max_abs_err_fp32": err}})
    return err


# --------------------------------------------------------- 5. model parity
def randomized_unet(torch, dev, fused, seed=0, **over):
    """Flagship U-Net with every parameter random (no near-zero convs)."""
    from pnpflow_tpu_torch.models.unet import VelocityUNet

    m = VelocityUNet(**{**FLAGSHIP, **over}, fused_norm=fused)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() == 1 and ("norm" in name or name.startswith(
                    "end_conv.0")) and name.endswith("weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
    return m.to(dev).eval()


def randomized_ncsnpp_state(torch, seed=0):
    """A state_dict of the NCSN++ 256^2 with every parameter drawn at a real
    scale (the seeded init leaves Conv_1, NIN_3 and the output convs near
    zero, which would make any comparison vacuous): GroupNorm scales near
    1, biases small, weights ~ 1/sqrt(fan_in); the Fourier W and the sigmas
    table keep their init."""
    import torch.nn as nn
    from pnpflow_tpu_torch.models.ncsnpp import NCSNpp, init_ncsnpp

    m = init_ncsnpp(NCSNpp(image_size=RECT_DIM), seed)
    norms = {id(mod.weight) for mod in m.modules()
             if isinstance(mod, nn.GroupNorm)}
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name == "all_modules.0.W":
                continue
            if id(p) in norms:
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                fan_in = p.shape[0] if name.endswith(".W") else p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
    return m.state_dict()


def ncsnpp(torch, dev, state, dtype=None):
    from pnpflow_tpu_torch.models.ncsnpp import NCSNpp

    m = NCSNpp(image_size=RECT_DIM, dtype=dtype or torch.float32)
    m.load_state_dict(state)
    return m.to(dev).eval()


def model_parity(torch, dev, rect_state):
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(8, 64, 64, 3, generator=g, device=dev)
    t = torch.rand(8, generator=g, device=dev)
    base = randomized_unet(torch, dev, False)
    out = {}
    expects = {True: only(groupnorm_swish=136),
               "bm": only(groupnorm_swish_bm=136),
               "conv": only(conv3x3_gn=109)}
    with torch.inference_mode():
        want = base(x, t)
        vmax = float(want.abs().max())
        for fused, expect in expects.items():
            m = randomized_unet(torch, dev, fused)
            reset_counts()
            got = m(x, t)
            torch.cuda.synchronize()
            launches = read_counts()
            rel = float((got - want).abs().max()) / vmax
            out[str(fused)] = {"rel_err": rel, "launches": launches}
            check(torch.isfinite(got).all().item(), f"{fused}: not finite")
            check(rel <= 1e-4, f"U-Net fused_norm={fused}: rel err {rel}")
            check(launches == expect, f"{fused}: launches {launches}")
    emit({"model_parity": "unet", "batch": 8, "max_abs_v": vmax, **out})

    # NCSN++ 256^2 on the card (upfirdn2d kernel, cuDNN convs, TF32 off)
    # against the CPU (plain upfirdn2d), same weights and inputs, batch 1
    xg = torch.Generator().manual_seed(8)
    x = torch.randn(1, RECT_DIM, RECT_DIM, 3, generator=xg)
    t = torch.tensor([0.37 * 999.0])
    with torch.inference_mode():
        want = ncsnpp(torch, "cpu", rect_state)(x, t)
        reset_counts()
        got = ncsnpp(torch, dev, rect_state)(x.to(dev), t.to(dev))
        torch.cuda.synchronize()
        launches = read_counts()
    vmax = float(want.abs().max())
    rel = float((got.cpu() - want).abs().max()) / vmax
    emit({"model_parity": "ncsnpp_256", "batch": 1, "max_abs_v": vmax,
          "rel_err": rel, "rel_tol": NCSNPP_REL_TOL, "launches": launches})
    check(torch.isfinite(got).all().item() and vmax > 1e-3,
          f"NCSN++ output not finite or vanishing (max {vmax})")
    check(rel <= NCSNPP_REL_TOL, f"NCSN++ card vs CPU: rel err {rel}")
    check(launches == only(upfirdn2d=RECT_FIR_SITES),
          f"NCSN++ launches {launches}")


# ------------------------------------------------------------ 6. main path
def cli_run(torch, extra, steps, rect_ckpt=None):
    from pnpflow_tpu_torch.main import main

    with tempfile.TemporaryDirectory() as out:
        if rect_ckpt is not None:
            ck = os.path.join(out, "model", "synthetic", "rectified")
            os.makedirs(ck)
            os.symlink(rect_ckpt, os.path.join(ck, "model_final.pt"))
        opts = ["dataset", "synthetic", "model", "ot", "eval", "True",
                "method", "pnp_flow", "problem", "gaussian_deblurring_FFT",
                "num_samples", "5", "batch_size_ip", "4", "max_batch", "1",
                "save_results", "True", "compute_time", "True",
                "compute_memory", "True", "steps_pnp", str(steps),
                "output_root", out] + extra
        reset_counts()
        t0 = time.perf_counter()
        args = main(["--opts"] + opts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        ip = args.save_path_ip
        for f in ("psnr_rec_batch0.txt", "psnr_noisy_batch0.txt",
                  "ssim_rec_batch0.txt", "psnr_rec_average.txt",
                  "ssim_rec_average.txt", "time_stats.txt",
                  "time_average.txt", "memory_stats.txt",
                  "max_memory_average.txt"):
            check(os.path.exists(os.path.join(ip, f)), f"missing {f}")
        with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
            header, row = f.readline().split(), f.readline().split()
        check(header == ["psnr_rec", "psnr_noisy", "steps_pnp", "lr_pnp",
                         "gamma_style", "num_samples", "alpha"],
              f"final_psnr.txt header {header}")
        psnr = float(row[0])
        check(psnr == psnr and abs(psnr) != float("inf"),
              f"PSNR not finite: {psnr}")
        with open(os.path.join(ip, "time_stats.txt")) as f:
            tstat = f.readline().strip()
        with open(os.path.join(ip, "memory_stats.txt")) as f:
            mstat = f.readline().strip()
    return {"opts": extra, "steps": steps, "seconds": seconds,
            "final_psnr_rec": psnr, "final_psnr_noisy": float(row[1]),
            "launches": launches, "time_stats": tstat, "memory_stats": mstat}


def main_path(torch, rect_ckpt):
    """Every run is read right after it; returns each kernel's launches on
    the run that drives it."""
    rect = ["model", "rectified", "dim_image", str(RECT_DIM)]
    unet_runs = (
        ("conv_fp32", [], CLI_STEPS, only(conv3x3_gn=109 * CLI_STEPS)),
        ("conv_bf16", ["bf16", "True"], 10, only(conv3x3_gn=109 * 10)),
        ("gn_fp32", ["fused_norm", "True"], 10,
         only(groupnorm_swish=136 * 10)),
        ("bm_fp32", ["fused_norm", "bm"], 10,
         only(groupnorm_swish_bm=136 * 10)),
    )
    rect_runs = (
        ("rect_fp32", rect, CLI_STEPS,
         only(upfirdn2d=RECT_FIR_SITES * CLI_STEPS)),
        ("rect_bf16", rect + ["bf16", "True"], 10,
         only(upfirdn2d=RECT_FIR_SITES * 10)),
        ("rect_sr_fp32", rect + ["problem", "superresolution"], 10,
         only(upfirdn2d=RECT_FIR_SITES * 10)),
    )
    runs = {}
    for name, extra, steps, expect in unet_runs + rect_runs:
        with phase(f"main_path/{name}"):
            r = cli_run(torch, extra, steps,
                        rect_ckpt if extra[:2] == rect[:2] else None)
        check(r["launches"] == expect,
              f"{name}: launches {r['launches']}, expected {expect}")
        emit({"main_path": name, "sites_per_forward":
              RECT_FIR_SITES if name.startswith("rect") else None, **r})
        runs[name] = r
    return {"conv3x3_gn": runs["conv_fp32"]["launches"]["conv3x3_gn"],
            "groupnorm_swish": runs["gn_fp32"]["launches"]["groupnorm_swish"],
            "groupnorm_swish_bm":
                runs["bm_fp32"]["launches"]["groupnorm_swish_bm"],
            "upfirdn2d": runs["rect_fp32"]["launches"]["upfirdn2d"]}


# --------------------------------------------------------------- 7. timing
def cuda_ms(torch, fn, reps=5, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_gn(torch, dev, gn_sites, dtype, bm=False):
    import torch.nn.functional as F
    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_swish_reference, groupnorm_swish_fwd)
    from pnpflow_tpu_torch.ops.gn_swish_bm import groupnorm_swish_bm_fwd

    fwd = groupnorm_swish_bm_fwd if bm else groupnorm_swish_fwd
    n, item = BENCH_BATCH, torch.finfo(dtype).bits // 8
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0}
    for (h, c, swish), k in Counter(gn_sites).items():
        x, s, b = gn_inputs(torch, dev, n, h, c, dtype, 0)

        def lib():
            y = F.group_norm(x.permute(0, 3, 1, 2), 32, s.to(dtype),
                             b.to(dtype), 1e-6)
            return F.silu(y) if swish else y

        tot["ms"] += k * cuda_ms(torch, lambda: fwd(x, s, b, 32, 1e-6, swish))
        tot["plain_ms"] += k * cuda_ms(
            torch, lambda: gn_swish_reference(x, s, b, 32, 1e-6, swish), 2)
        tot["library_ms"] += k * cuda_ms(torch, lib)
        elems = n * h * h * c
        tot["bytes_ms"] += k * 1e3 * 2 * elems * item / MEM_BW
        tot["ops_ms"] += k * 1e3 * 10 * elems / PEAK["float32"]
    return tot


def time_gn_bm(torch, dev, gn_sites, dtype):
    return time_gn(torch, dev, gn_sites, dtype, bm=True)


def time_conv(torch, dev, conv_sites, dtype):
    import torch.nn.functional as F
    from pnpflow_tpu_torch.ops.fused_conv_gn import (
        conv3x3_gn, conv3x3_gn_reference)

    n, item = BENCH_BATCH, torch.finfo(dtype).bits // 8
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0}
    for site, k in Counter(conv_sites).items():
        h, cin, cout, pro, sb, res = site
        args, kw = conv_inputs(torch, dev, n, site, dtype, 0)
        x, w, b = args
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        b_lib = b.to(dtype)
        tot["ms"] += k * cuda_ms(torch, lambda: conv3x3_gn(*args, **kw), 3)
        tot["plain_ms"] += k * cuda_ms(
            torch, lambda: conv3x3_gn_reference(*args, **kw), 2)
        tot["library_ms"] += k * cuda_ms(
            torch, lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1))
        px = n * h * h
        nbytes = (px * cin + 9 * cin * cout + px * cout * (2 if res else 1)) \
            * item + 4 * (n * 2 * cout + (2 * n * cin if pro else 0)
                          + (n * cout if sb else 0) + cout)
        tot["bytes_ms"] += k * 1e3 * nbytes / MEM_BW
        tot["ops_ms"] += k * 1e3 * 2 * px * 9 * cin * cout / PEAK[str(dtype)[6:]]
    return tot


def fir_library(torch, x, k, up, down, pad):
    """The one PyTorch call computing the same upfirdn2d as the NCSN++
    sites: a stride-2 depthwise conv with the flipped taps (down), or a
    stride-2 depthwise transposed conv with the taps as they are (up)."""
    import torch.nn.functional as F

    c, kk = x.shape[-1], k.shape[0]
    xv = x.permute(0, 3, 1, 2)
    if up == 1 and pad[0] == pad[1]:
        w = torch.from_numpy(k[::-1, ::-1].copy()).to(x.device, x.dtype)
        w = w.expand(c, 1, kk, kk).contiguous()
        return lambda: F.conv2d(xv, w, stride=down, padding=pad[0], groups=c)
    if down == 1 and pad == ((kk - up + 1) // 2 + up - 1, (kk - up) // 2):
        w = torch.from_numpy(k.copy()).to(x.device, x.dtype)
        w = w.expand(c, 1, kk, kk).contiguous()
        p = (kk - up) // 2
        return lambda: F.conv_transpose2d(xv, w, stride=up, padding=p,
                                          groups=c)
    fail(f"no library call for upfirdn2d up={up} down={down} pad={pad}")


def time_fir(torch, dev, firs, dtype):
    from pnpflow_tpu_torch.ops.upfirdn import upfirdn2d, upfirdn2d_reference

    n, item = MAIN_BATCH, torch.finfo(dtype).bits // 8
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0}
    for site, cnt in Counter(firs).items():
        x, k, kw = fir_inputs(torch, dev, n, site, dtype, 0)
        lib = fir_library(torch, x, k, **kw)
        y = upfirdn2d(x, k, **kw)
        d = float((lib().permute(0, 2, 3, 1).float() - y.float())
                  .abs().max())
        check(d <= (1e-5 if dtype == torch.float32 else 5e-2),
              f"library call disagrees at {site[:7]}: {d}")
        tot["ms"] += cnt * cuda_ms(torch, lambda: upfirdn2d(x, k, **kw))
        tot["plain_ms"] += cnt * cuda_ms(
            torch, lambda: upfirdn2d_reference(x, k, **kw), 2)
        tot["library_ms"] += cnt * cuda_ms(torch, lib)
        # the multiply-adds this data needs: taps on inserted zeros skipped
        kk, up = k.shape[0], kw["up"]
        taps_used = (kk // up) ** 2
        tot["bytes_ms"] += cnt * 1e3 * (x.numel() + y.numel()) * item / MEM_BW
        tot["ops_ms"] += cnt * 1e3 * 2 * taps_used * y.numel() / PEAK["float32"]
    return tot


def kernel_rows(torch, dev, sites, launches, err):
    kernels = []
    for name, fn, key, route, src, repl, batch in (
        ("conv3x3_gn", time_conv, "conv", "cuda",
         "pnpflow_tpu_torch/ops/csrc/conv3x3_gn.cu",
         "pnpflow_tpu/ops/fused_conv_gn.py:87", BENCH_BATCH),
        ("groupnorm_swish", time_gn, "gn", "triton",
         "pnpflow_tpu_torch/ops/gn_swish.py",
         "pnpflow_tpu/ops/pallas_kernels.py:140", BENCH_BATCH),
        ("groupnorm_swish_bm", time_gn_bm, "gn", "triton",
         "pnpflow_tpu_torch/ops/gn_swish_bm.py",
         "pnpflow_tpu/ops/pallas_kernels.py:314", BENCH_BATCH),
        ("upfirdn2d", time_fir, "fir", "cuda",
         "pnpflow_tpu_torch/ops/csrc/upfirdn2d.cu",
         "pnpflow_tpu/ops/pallas_kernels.py:36", MAIN_BATCH),
    ):
        per = {}
        with phase(f"timing/{name}"):
            for dtype in (torch.float32, torch.bfloat16):
                with torch.inference_mode():
                    per[str(dtype)[6:]] = fn(torch, dev, sites[key], dtype)
        t = per["float32"]
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
            else "operations",
            "library_ms": t["library_ms"],
        })
        emit({"kernel_timing": name, "per_forward": True,
              "launches_per_forward": len(sites[key]), "batch": batch,
              **{dt: {k: v for k, v in d.items()} for dt, d in per.items()}})
    return kernels


def time_unet(torch, dev):
    from pnpflow_tpu_torch.ops.degradations import GaussianDeblurring

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(BENCH_BATCH, 64, 64, 3, generator=g, device=dev)
    t = torch.rand(BENCH_BATCH, generator=g, device=dev)
    fwd = {}
    for fused in (False, True, "bm", "conv"):
        for dtype in (torch.float32, torch.bfloat16):
            m = randomized_unet(torch, dev, fused, dtype=dtype)
            with torch.inference_mode():
                fwd[f"{fused}/{str(dtype)[6:]}"] = cuda_ms(
                    torch, lambda: m(x, t), reps=2)
            del m
    emit({"unet_forward_ms": fwd, "batch": BENCH_BATCH})

    model = randomized_unet(torch, dev, "conv")
    op = GaussianDeblurring(3.0, 61, 3, 64, device=dev)
    y = torch.randn(BENCH_BATCH // 5, 64, 64, 3, generator=g, device=dev)
    step_s = pnp_step_seconds(torch, dev, model, op, y)
    emit({"pnp_step": {"model": "ot", "fused_norm": "conv",
                       "dtype": "float32", "images": BENCH_BATCH // 5,
                       "mc_samples": 5, "seconds_per_step": step_s,
                       "img_per_s_at_100_steps":
                           (BENCH_BATCH // 5) / (100 * step_s)}})


def pnp_step_seconds(torch, dev, model, op, y, steps=3):
    from pnpflow_tpu_torch.solvers.pnp_flow import make_pnp_flow_solver

    solve = make_pnp_flow_solver(
        model, op.H, op.H_adj, steps=100, num_samples=5, lr_pnp=1.0,
        gamma_style="alpha_1_minus_t", alpha=1.0, noise_type="gaussian",
        sigma_noise=0.05)
    gen = torch.Generator(device=dev).manual_seed(1000)
    with torch.inference_mode():
        x0 = op.H_adj(torch.ones_like(y))
        solve(y, x0, gen, 0, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(y, x0, gen, 1, steps)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
    check(torch.isfinite(out).all().item(), "PnP steps not finite")
    return step_s


PROFILE_GROUPS = (    # kernel-name keyword -> group, first match wins
    ("upfirdn2d", "upfirdn2d"), ("group_norm", "group_norm"),
    ("GroupNorm", "group_norm"), ("conv", "conv"), ("cudnn", "conv"),
    ("xmma", "conv"), ("fft", "conv"), ("winograd", "conv"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("softmax", "softmax"),
    ("elementwise", "elementwise"), ("reduce", "reduce"), ("copy", "copy"),
)
# CUPTI's own buffer-management records, which key_averages lists beside
# the kernels
CUPTI_RECORDS = ("Buffer Flush", "Activity Buffer Request",
                 "Command Buffer Full")


def profile_ncsnpp(torch, dev, m, x, t):
    """Device time of one float32 NCSN++ forward by kernel, from
    torch.profiler's CUDA activity (kernel events only: an op's own device
    time repeats its kernels', and CUPTI's buffer records are not kernels):
    the top kernels, their groups, the kernel count, the device's busy
    share of the profiled wall time and the forward's peak memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        m(x, t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            m(x, t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    rows, skipped = [], {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if us <= 0 or ev.device_type != DeviceType.CUDA:
            continue
        if ev.key in CUPTI_RECORDS:
            skipped[ev.key] = us / 1e3
            continue
        rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    groups = Counter()
    for name, ms, _ in rows:
        groups[next((g for k, g in PROFILE_GROUPS if k in name),
                    "other")] += ms
    device_ms = sum(r[1] for r in rows)
    emit({"ncsnpp_profile": {
        "dtype": "float32", "batch": x.shape[0], "wall_ms": wall_ms,
        "device_ms": device_ms, "kernels": sum(r[2] for r in rows),
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "max_memory_allocated": peak, "groups_ms": dict(groups),
        "cupti_records_ms": skipped,
        "top": [[name[:90], ms, n] for name, ms, n in rows[:10]]}})


def time_rectified(torch, dev, rect_state):
    from pnpflow_tpu_torch.models.registry import RectifiedAdapter
    from pnpflow_tpu_torch.ops.degradations import GaussianDeblurring

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(MAIN_BATCH, RECT_DIM, RECT_DIM, 3, generator=g,
                    device=dev)
    t = torch.rand(MAIN_BATCH, generator=g, device=dev) * 999.0 + 1.0
    fwd = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = ncsnpp(torch, dev, rect_state, dtype)
        with torch.inference_mode():
            fwd[str(dtype)[6:]] = cuda_ms(torch, lambda: m(x, t), reps=2)
        del m
    emit({"ncsnpp_forward_ms": fwd, "batch": MAIN_BATCH,
          "image": RECT_DIM})
    profile_ncsnpp(torch, dev, ncsnpp(torch, dev, rect_state), x, t)

    model = RectifiedAdapter(ncsnpp(torch, dev, rect_state)).eval()
    op = GaussianDeblurring(3.0, 61, 3, RECT_DIM, device=dev)
    y = torch.randn(MAIN_BATCH // 5, RECT_DIM, RECT_DIM, 3, generator=g,
                    device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s = pnp_step_seconds(torch, dev, model, op, y)
    emit({"pnp_step": {"model": "rectified", "dtype": "float32",
                       "images": MAIN_BATCH // 5, "mc_samples": 5,
                       "seconds_per_step": step_s,
                       "img_per_s_at_100_steps":
                           (MAIN_BATCH // 5) / (100 * step_s),
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated(dev)}})


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "pnpflow_tpu_torch")):
        fail("pnpflow_tpu_torch/ not found beside this script: run it from "
             "a checkout of the repository")
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    with phase("setup"):
        card = setup(torch)
    with phase("build"):
        build()
    with phase("sites"):
        gn_sites, conv_sites = unet_sites(torch, dev)
        firs = fir_sites(torch, dev)
        rect_state = randomized_ncsnpp_state(torch)
    sites = {"gn": gn_sites, "conv": conv_sites, "fir": firs}
    with phase("kernel_parity"):
        err = kernel_parity(torch, dev, gn_sites, conv_sites, firs)
    with phase("model_parity"):
        model_parity(torch, dev, rect_state)
    with tempfile.TemporaryDirectory() as tmp:
        rect_ckpt = os.path.join(tmp, "rectified.pt")
        # a RectifiedFlow-layout checkpoint: {model, ema, optimizer, step}
        torch.save({"model": {"module." + k: v for k, v in rect_state.items()},
                    "ema": None, "optimizer": {}, "step": 0}, rect_ckpt)
        launches = main_path(torch, rect_ckpt)
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    kernels = kernel_rows(torch, dev, sites, launches, err)
    with phase("timing/unet"):
        time_unet(torch, dev)
    with phase("timing/rectified"):
        time_rectified(torch, dev, rect_state)
    emit({"kernels": kernels})
    emit({"seconds": time.perf_counter() - t_all})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
