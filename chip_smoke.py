#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which exits non-zero on
failure (nothing is caught and passed over):

1. setup: card name and power limit, versions, TF32 flags, optional modules;
2. build: the CUDA kernels, from the sources in the checkout;
3. kernel parity: each kernel against its plain PyTorch version at every
   site of the flagship U-Net (64x64, ch 32, mult 1,2,4,8, 6 blocks, attention
   at 16 and 8), in float32 and bf16, plus every epilogue combination;
4. model parity: the random-init flagship U-Net with ``fused_norm`` True and
   "conv" against False, and the launch count of one forward;
5. main path: the port's CLI, pnp_flow on FFT deblurring of synthetic 64x64
   images, with the counters set to 0 before each run and read after;
6. timing: CUDA-event times of each kernel, its plain version and the
   PyTorch library call, per U-Net forward at the bench shapes (64x64,
   64 images x 5 Monte-Carlo samples), the U-Net forward per mode and a few
   PnP steps.

JSON lines precede the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

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
CLI_STEPS = 100         # main-path PnP steps: the CLI default
MAIN_BATCH = 4 * 5      # batch_size_ip x num_samples: images per forward
BENCH_BATCH = 64 * 5    # the bench protocol: 64 images x 5 MC samples


def fail(msg):
    print("chip_smoke FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        fail(msg)


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
                      "triton")}
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


# ------------------------------------------------------- sites of the U-Net
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


# -------------------------------------------------------- 3. kernel parity
def kernel_parity(torch, dev, gn_sites, conv_sites):
    from pnpflow_tpu_torch.ops.fused_conv_gn import (
        conv3x3_gn, conv3x3_gn_reference)
    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_swish_reference, groupnorm_swish_fwd)

    n = MAIN_BATCH
    err = {"groupnorm_swish": 0.0, "conv3x3_gn": 0.0}
    t0 = time.perf_counter()
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        for i, (h, c, swish) in enumerate(sorted(set(gn_sites))):
            x, s, b = gn_inputs(torch, dev, n, h, c, dtype, i)
            got = groupnorm_swish_fwd(x, s, b, 32, 1e-6, swish)
            torch.cuda.synchronize()
            want = gn_swish_reference(x, s, b, 32, 1e-6, swish)
            d = float((got.float() - want.float()).abs().max())
            check(got.dtype == dtype and d <= tol,
                  f"groupnorm_swish {dtype} at {(h, c, swish)}: err {d}")
            if dtype == torch.float32:
                err["groupnorm_swish"] = max(err["groupnorm_swish"], d)

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
    emit({"kernel_parity": {"gn_sites": len(set(gn_sites)),
                            "conv_sites": len(sites), "batch": n,
                            "max_abs_err_fp32": err,
                            "seconds": time.perf_counter() - t0}})
    return err


# --------------------------------------------------------- 4. model parity
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


def model_parity(torch, dev):
    from pnpflow_tpu_torch.ops.fused_conv_gn import conv3x3_gn
    from pnpflow_tpu_torch.ops.gn_swish import groupnorm_swish_fwd

    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(8, 64, 64, 3, generator=g, device=dev)
    t = torch.rand(8, generator=g, device=dev)
    base = randomized_unet(torch, dev, False)
    out = {}
    with torch.inference_mode():
        want = base(x, t)
        vmax = float(want.abs().max())
        for fused in (True, "conv"):
            m = randomized_unet(torch, dev, fused)
            groupnorm_swish_fwd.launches = conv3x3_gn.launches = 0
            got = m(x, t)
            torch.cuda.synchronize()
            launches = {"groupnorm_swish": groupnorm_swish_fwd.launches,
                        "conv3x3_gn": conv3x3_gn.launches}
            rel = float((got - want).abs().max()) / vmax
            out[str(fused)] = {"rel_err": rel, "launches": launches}
            check(torch.isfinite(got).all().item(), f"{fused}: not finite")
            check(rel <= 1e-4, f"U-Net fused_norm={fused}: rel err {rel}")
            expect = ({"groupnorm_swish": 136, "conv3x3_gn": 0} if fused is True
                      else {"groupnorm_swish": 0, "conv3x3_gn": 109})
            check(launches == expect, f"{fused}: launches {launches}")
    emit({"model_parity": {"batch": 8, "max_abs_v": vmax, **out}})


# ------------------------------------------------------------ 5. main path
def cli_run(torch, extra, steps):
    from pnpflow_tpu_torch.main import main
    from pnpflow_tpu_torch.ops.fused_conv_gn import conv3x3_gn
    from pnpflow_tpu_torch.ops.gn_swish import groupnorm_swish_fwd

    with tempfile.TemporaryDirectory() as out:
        opts = ["dataset", "synthetic", "model", "ot", "eval", "True",
                "method", "pnp_flow", "problem", "gaussian_deblurring_FFT",
                "num_samples", "5", "batch_size_ip", "4", "max_batch", "1",
                "save_results", "True", "compute_time", "True",
                "compute_memory", "True", "steps_pnp", str(steps),
                "output_root", out] + extra
        groupnorm_swish_fwd.launches = conv3x3_gn.launches = 0
        t0 = time.perf_counter()
        args = main(["--opts"] + opts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"groupnorm_swish": groupnorm_swish_fwd.launches,
                    "conv3x3_gn": conv3x3_gn.launches}
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


def main_path(torch):
    runs = {}
    r = cli_run(torch, [], CLI_STEPS)
    check(r["launches"] == {"groupnorm_swish": 0,
                            "conv3x3_gn": 109 * CLI_STEPS},
          f"fp32 conv run launches {r['launches']}")
    runs["conv_fp32"] = r
    r = cli_run(torch, ["bf16", "True"], 10)
    check(r["launches"]["conv3x3_gn"] == 109 * 10,
          f"bf16 run launches {r['launches']}")
    runs["conv_bf16"] = r
    r = cli_run(torch, ["fused_norm", "True"], 10)
    check(r["launches"] == {"groupnorm_swish": 136 * 10, "conv3x3_gn": 0},
          f"fused_norm True run launches {r['launches']}")
    runs["gn_fp32"] = r
    for name, r in runs.items():
        emit({"main_path": name, **r})
    return {"conv3x3_gn": runs["conv_fp32"]["launches"]["conv3x3_gn"],
            "groupnorm_swish": runs["gn_fp32"]["launches"]["groupnorm_swish"]}


# --------------------------------------------------------------- 6. timing
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


def time_gn(torch, dev, gn_sites, dtype):
    import torch.nn.functional as F
    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_swish_reference, groupnorm_swish_fwd)

    n, item = BENCH_BATCH, torch.finfo(dtype).bits // 8
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0}
    for (h, c, swish), k in Counter(gn_sites).items():
        x, s, b = gn_inputs(torch, dev, n, h, c, dtype, 0)

        def lib():
            y = F.group_norm(x.permute(0, 3, 1, 2), 32, s.to(dtype),
                             b.to(dtype), 1e-6)
            return F.silu(y) if swish else y

        tot["ms"] += k * cuda_ms(
            torch, lambda: groupnorm_swish_fwd(x, s, b, 32, 1e-6, swish))
        tot["plain_ms"] += k * cuda_ms(
            torch, lambda: gn_swish_reference(x, s, b, 32, 1e-6, swish), 2)
        tot["library_ms"] += k * cuda_ms(torch, lib)
        elems = n * h * h * c
        tot["bytes_ms"] += k * 1e3 * 2 * elems * item / MEM_BW
        tot["ops_ms"] += k * 1e3 * 10 * elems / PEAK["float32"]
    return tot


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


def timing(torch, dev, gn_sites, conv_sites, launches, err):
    from pnpflow_tpu_torch.ops.degradations import GaussianDeblurring
    from pnpflow_tpu_torch.solvers.pnp_flow import make_pnp_flow_solver

    kernels = []
    for name, fn, sites, route, src, repl in (
        ("conv3x3_gn", time_conv, conv_sites, "cuda",
         "pnpflow_tpu_torch/ops/csrc/conv3x3_gn.cu",
         "pnpflow_tpu/ops/fused_conv_gn.py:87"),
        ("groupnorm_swish", time_gn, gn_sites, "triton",
         "pnpflow_tpu_torch/ops/gn_swish.py",
         "pnpflow_tpu/ops/pallas_kernels.py:140"),
    ):
        per = {}
        for dtype in (torch.float32, torch.bfloat16):
            with torch.inference_mode():
                per[str(dtype)[6:]] = fn(torch, dev, sites, dtype)
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
              "launches_per_forward": len(sites), "batch": BENCH_BATCH,
              **{dt: {k: v for k, v in d.items()} for dt, d in per.items()}})

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(BENCH_BATCH, 64, 64, 3, generator=g, device=dev)
    t = torch.rand(BENCH_BATCH, generator=g, device=dev)
    fwd = {}
    for fused in (False, True, "conv"):
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
        out = solve(y, x0, gen, 1, 3)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
    check(torch.isfinite(out).all().item(), "PnP steps not finite")
    emit({"pnp_step": {"fused_norm": "conv", "dtype": "float32",
                       "images": BENCH_BATCH // 5, "mc_samples": 5,
                       "seconds_per_step": step_s,
                       "img_per_s_at_100_steps":
                           (BENCH_BATCH // 5) / (100 * step_s)}})
    emit({"kernels": kernels})


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

    card = setup(torch)
    build()
    gn_sites, conv_sites = unet_sites(torch, dev)
    err = kernel_parity(torch, dev, gn_sites, conv_sites)
    model_parity(torch, dev)
    launches = main_path(torch)
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    timing(torch, dev, gn_sites, conv_sites, launches, err)
    emit({"seconds": time.perf_counter() - t_all})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
