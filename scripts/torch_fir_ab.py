#!/usr/bin/env python3
"""Time the port's upfirdn2d kernel against a baseline source of it, on one
NVIDIA GPU, in one process.

    python3 scripts/torch_fir_ab.py --baseline OLD/upfirdn2d.cu [--rounds 2]

The baseline is a ``upfirdn2d.cu`` with the one-thread-per-output C
interface ``upfirdn2d_launch(dtype, x, y, taps, K, N, H, W, C, OH, OW, up,
down, pad0, stream)``; it is built with the port's nvcc flags into
``build/kernels/``.  At every upfirdn2d site of one NCSN++ 256^2 forward, at
the main-path batch of 20 images and in float32 and bf16, both kernels are
held to the plain version and timed in turns (baseline, port, port,
baseline per round): device time from torch.profiler and CUDA-event time
around back-to-back calls.  Prints the card's name and power limit, then one
JSON line per dtype with the per-forward sums, their bytes bound and the
by-site numbers (ms for all of a site's launches per forward).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import subprocess
import sys
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_baseline(src):
    from pnpflow_tpu_torch.ops import _build

    data = open(src, "rb").read()
    tag = hashlib.sha256(data + "\0".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"libupfirdn2d_baseline-{tag.hexdigest()[:12]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        src], check=True)
    fn = ctypes.CDLL(str(out)).upfirdn2d_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def baseline_call(torch, fn, x, k, up, down, pad):
    """The baseline kernel on x: returns y."""
    n, h, w, c = x.shape
    kk = k.shape[0]
    oh = (h * up + pad[0] + pad[1] - kk) // down + 1
    ow = (w * up + pad[0] + pad[1] - kk) // down + 1
    flipped = k[::-1, ::-1].ravel()
    taps = (ctypes.c_float * flipped.size)(*flipped.tolist())
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    err = fn(0 if x.dtype == torch.float32 else 1, x.data_ptr(),
             y.data_ptr(), taps, kk, n, h, w, c, oh, ow, up, down, pad[0],
             torch._C._cuda_getCurrentRawStream(x.device.index))
    if err != 0:
        raise RuntimeError(f"baseline upfirdn2d failed (error {err})")
    return y


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="path of the baseline upfirdn2d.cu")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of (baseline, port, port, baseline)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_fir_ab: needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from pnpflow_tpu_torch.ops.upfirdn import upfirdn2d, upfirdn2d_reference

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    base = build_baseline(args.baseline)
    firs = cs.fir_sites(torch, dev)
    n = cs.MAIN_BATCH
    cases = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            for site, cnt in Counter(firs).items():
                x, k, kw = cs.fir_inputs(torch, dev, n, site, dtype, 0)
                calls = {
                    "baseline": functools.partial(
                        baseline_call, torch, base, x, k, kw["up"],
                        kw["down"], kw["pad"]),
                    "port": functools.partial(upfirdn2d, x, k, **kw)}
                want = upfirdn2d_reference(x, k, **kw).float()
                for name, fn in calls.items():
                    d = float((fn().float() - want).abs().max())
                    cs.check(d <= tol, f"{name} {dtype} at {site[:7]}: {d}")
                cases[dtype, site] = (cnt, calls)
        # event times first: after torch.profiler has run, launches cost
        # the host more; device times from one profiler session per kernel
        # and dtype in each turn
        times = {}
        for key, (cnt, calls) in cases.items():
            for _ in range(args.rounds):
                for name in ("baseline", "port", "port", "baseline"):
                    times.setdefault((key, name, "event_ms"), []).append(
                        cs.cuda_ms(torch, calls[name], reps=10))
        for dtype in (torch.float32, torch.bfloat16):
            keys = [key for key in cases if key[0] == dtype]
            for _ in range(args.rounds):
                for name in ("baseline", "port", "port", "baseline"):
                    each = cs.device_ms_each(
                        torch, [cases[key][1][name] for key in keys],
                        ("upfirdn2d",))
                    for key, ms in zip(keys, each):
                        times.setdefault((key, name, "device_ms"),
                                         []).append(ms)
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.finfo(dtype).bits // 8
        sums = {"baseline": {"device_ms": 0.0, "event_ms": 0.0},
                "port": {"device_ms": 0.0, "event_ms": 0.0}, "bound_ms": 0.0}
        by_site = {}
        for site, cnt in Counter(firs).items():
            bound = cnt * max(cs.fir_bounds_ms(site, n, item))
            row = {"launches": cnt, "bound_ms": bound}
            for name in ("baseline", "port"):
                row[name] = {}
                for metric in ("device_ms", "event_ms"):
                    ms = cnt * min(times[(dtype, site), name, metric])
                    row[name][metric] = ms
                    sums[name][metric] += ms
            sums["bound_ms"] += bound
            by_site[cs.fir_site_key(site)] = row
        print(json.dumps({"fir_ab": str(dtype)[6:], "batch": n,
                          "rounds": args.rounds, "min_of": 2 * args.rounds,
                          **sums, "by_site": by_site}), flush=True)


if __name__ == "__main__":
    main()
