#!/usr/bin/env python3
"""Time the port's conv3x3_gn kernel against a baseline source of it, on one
NVIDIA GPU, in one process.

    python3 scripts/torch_conv_ab.py --baseline OLD/conv3x3_gn.cu \
        [--baseline-plan OLD/fused_conv_gn.py] [--rounds 2] [--probes]

The baseline is a ``conv3x3_gn.cu`` with the C interface of its own
wrapper, ``conv3x3_gn_launch(dtype, x, w, bias, pa, pb, sb, res, y, mom, ws,
N, H, W, C, CO, flags, bm, bn, tw, stream)`` (HWIO weights, an (N, T, 2, CO)
moment workspace), launched with the tile plan of the ``fused_conv_gn.py``
beside it (or ``--baseline-plan``); it is built with the port's nvcc flags
into ``build/kernels/``.  At every conv3x3_gn site of one flagship U-Net
forward (64x64), at the main-path batch of 20 images and the bench batch of
320, in float32 and bf16, both kernels are held to the plain version, then
timed in turns (baseline, port, port, baseline per round) with cuDNN's
``F.conv2d`` beside them: CUDA-event time around back-to-back calls, and
device time from one torch.profiler session whose groups of calls are told
apart by marker kernels.  Prints the card's name and power limit, then one
JSON line per dtype and batch with the per-forward sums, their bound and the
by-site numbers (ms for all of a site's launches per forward), with the
port's tile, blocks, blocks an SM holds and shared memory a block.

``--probes`` adds measurements of what holds the port back, timed in the
same turns: two builds of the port's source, one whose weight ring is 96 KB
instead of 48 (``ring96k``) and one that loads each ring stage once and then
reuses it (``weights_once``: wrong products, the time without the weight
stream, a bound on what any cut of the weight traffic, such as a multicast
across a cluster, could save); and the sites with a prologue at 64x64 again
without it (``no_prologue`` lines), for the baseline, the port and cuDNN.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ("baseline", "port", "cudnn")


PROBES = {"ring96k": ["-DCONV3X3_GN_RING_BYTES=98304"],
          "weights_once": ["-DCONV3X3_GN_WEIGHTS_ONCE"]}


def start_build(src, name, defines=()):
    """Start nvcc on ``src`` with the port's flags (and ``defines``) into
    ``build/kernels/``; returns (library path, process or None if built)."""
    from pnpflow_tpu_torch.ops import _build

    flags = [*_build.NVCC_FLAGS, *defines]
    tag = hashlib.sha256(open(src, "rb").read() + "\0".join(flags).encode())
    out = _build.BUILD_DIR / f"lib{name}-{tag.hexdigest()[:12]}.so"
    if out.exists():
        return out, None
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return out, subprocess.Popen([_build._nvcc(), *flags, "-o", str(out),
                                  src], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish_build(out, proc):
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"torch_conv_ab: nvcc failed for {out}:\n{log}")
    return ctypes.CDLL(str(out))


def bind_baseline(lib):
    fn = lib.conv3x3_gn_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bind_port(lib, name="conv3x3_gn_launch"):
    from pnpflow_tpu_torch.ops import _build

    fn = getattr(lib, name)
    fn.argtypes = list(_build.SOURCES["conv3x3_gn"][1])
    if name == "conv3x3_gn_occupancy":
        fn.argtypes.append(ctypes.POINTER(ctypes.c_int))
    fn.restype = ctypes.c_int
    return fn


def port_call(torch, fn, x, w, b, prologue=None, sample_bias=None,
              residual=None, out=None):
    """A build of the port's source, launched as the port's wrapper launches
    it; returns (y, moments), or with ``out`` (an int array of 2) the
    occupancy query's (blocks an SM holds, shared memory a block)."""
    from pnpflow_tpu_torch.ops import fused_conv_gn as pfc

    flags = pfc._check_args(x, w, b, prologue, sample_bias, residual)
    n, h, wd, _ = x.shape
    plan = pfc.launch_plan(n, h, wd, w.shape[-1])
    args, y, mom = pfc._launch_args(x, w, b, flags, plan, prologue,
                                    sample_bias, residual, True)
    with torch.cuda.device(x.device):
        err = fn(*args) if out is None else fn(*args, out)
    if err != 0:
        raise RuntimeError(f"port build of conv3x3_gn failed (error {err})")
    return (y, mom) if out is None else tuple(out)


def load_plan_module(path):
    spec = importlib.util.spec_from_file_location("conv3x3_gn_baseline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def baseline_call(torch, fn, mod, x, w, b, prologue=None, sample_bias=None,
                  residual=None):
    """The baseline kernel as its own wrapper launched it: the same checks
    and allocations, its plan; returns (y, moments)."""
    flags = mod._check_args(x, w, b, prologue, sample_bias, residual) | 8
    n, h, wd, c = x.shape
    co = w.shape[-1]
    plan = mod.launch_plan(n, h, wd, co)
    dev = x.device
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=dev)
    mom = torch.empty((n, 2, co), dtype=torch.float32, device=dev)
    ws = torch.empty((n, plan.tiles_y * plan.tiles_x, 2, co),
                     dtype=torch.float32, device=dev)
    pa, pb = prologue if prologue is not None else (None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(0 if x.dtype == torch.float32 else 1, ptr(x), ptr(w), ptr(b),
             ptr(pa), ptr(pb), ptr(sample_bias), ptr(residual), ptr(y),
             ptr(mom), ptr(ws), n, h, wd, c, co, flags, plan.bm, plan.bn,
             plan.tw, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline conv3x3_gn failed (error {err})")
    return y, mom


def device_ms_groups(torch, groups, reps):
    """Device time of one call of each of ``groups`` (functions), from one
    torch.profiler session: each group's ``reps`` calls follow a marker
    kernel (``torch.cuda._sleep``), and a group's time is the device time of
    the kernels between its marker and the next.  None for every group if
    the session dropped a marker."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in groups:
            torch.cuda._sleep(100)
            for _ in range(reps):
                fn()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    marks = [i for i, ev in enumerate(evs) if "spin_kernel" in ev.name]
    if len(marks) != len(groups) + 1:
        return [None] * len(groups)
    return [sum(ev.time_range.elapsed_us() for ev in evs[a + 1:b])
            / 1e3 / reps for a, b in zip(marks, marks[1:])]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="path of the baseline conv3x3_gn.cu")
    ap.add_argument("--baseline-plan",
                    help="its fused_conv_gn.py (default: beside it)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of (baseline, port, port, baseline)")
    ap.add_argument("--probes", action="store_true",
                    help="also time the probe builds and the 64x64 sites "
                    "without their prologue")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("torch_conv_ab: needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from pnpflow_tpu_torch.device import set_fp32_parity_mode
    from pnpflow_tpu_torch.ops import _build
    from pnpflow_tpu_torch.ops.fused_conv_gn import (
        conv3x3_gn, conv3x3_gn_reference, launch_plan)

    set_fp32_parity_mode()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    # every nvcc at once: the baseline, the probes, the port's library
    builds = {"baseline": start_build(args.baseline, "conv3x3_gn_baseline")}
    port_src = str(_build._CSRC / "conv3x3_gn.cu")
    for name, defines in (PROBES.items() if args.probes else ()):
        builds[name] = start_build(port_src, f"conv3x3_gn_{name}", defines)
    _build.load("conv3x3_gn")
    libs = {name: finish_build(*b) for name, b in builds.items()}
    base = bind_baseline(libs["baseline"])
    probes = {name: bind_port(libs[name]) for name in PROBES
              if name in libs}
    occupancy = bind_port(ctypes.CDLL(str(_build.library_path(
        "conv3x3_gn"))), "conv3x3_gn_occupancy")
    impls = IMPLS + tuple(probes)
    plan_mod = load_plan_module(args.baseline_plan or os.path.join(
        os.path.dirname(os.path.abspath(args.baseline)), "fused_conv_gn.py"))
    _, sites = cs.unet_sites(torch, dev)
    counts = Counter(sites)
    # the 64x64 sites with a prologue, timed again without it
    bare = {(h, cin, cout, False, sb, res): k
            for (h, cin, cout, pro, sb, res), k in counts.items()
            if args.probes and pro and h == 64}
    cases, tiles = {}, {}
    with torch.inference_mode():
        for n in (cs.MAIN_BATCH, cs.BENCH_BATCH):
            for dtype in (torch.float32, torch.bfloat16):
                tol = 1e-4 if dtype == torch.float32 else 2e-2
                for site in [*counts, *bare]:
                    (x, w, b), kw = cs.conv_inputs(torch, dev, n, site,
                                                   dtype, 0)
                    x_nchw = x.permute(0, 3, 1, 2)
                    w_oihw = w.permute(3, 2, 0, 1).contiguous()
                    b_lib = b.to(dtype)
                    calls = {
                        "baseline": functools.partial(
                            baseline_call, torch, base, plan_mod, x, w, b,
                            **kw),
                        "port": functools.partial(conv3x3_gn, x, w, b, **kw),
                        "cudnn": functools.partial(
                            F.conv2d, x_nchw, w_oihw, b_lib, padding=1)}
                    for name, fn in probes.items():
                        calls[name] = functools.partial(
                            port_call, torch, fn, x, w, b, **kw)
                    plan = launch_plan(n, site[0], site[0], site[2])
                    per_sm, smem = port_call(torch, occupancy, x, w, b,
                                             out=(ctypes.c_int * 2)(), **kw)
                    tiles[n, dtype, site] = {
                        "tile": f"{plan.bm}x{plan.bn}/{plan.samples}",
                        "blocks": plan.blocks(n, site[2]),
                        "blocks_per_sm": per_sm, "smem": smem}
                    want, wm = conv3x3_gn_reference(x, w, b, **kw)
                    scale = float(want.float().abs().max())
                    for name in probes:  # a probe the card refuses: None
                        try:
                            calls[name]()
                        except RuntimeError as e:
                            print(f"{name} n {n} {dtype} at {site}: {e}",
                                  flush=True)
                            calls[name] = None
                    # weights_once computes wrong products by design
                    for name in ("baseline", "port", *(
                            k for k in probes if k != "weights_once")):
                        if calls[name] is None:
                            continue
                        y, m = calls[name]()
                        d = float((y.float() - want.float()).abs().max())
                        dm = max(float((m[:, k] - wm[:, k]).abs().max())
                                 / float(wm[:, k].abs().max())
                                 for k in range(2))
                        cs.check(d <= tol * scale and dm <= tol,
                                 f"{name} {dtype} n {n} at {site}: y {d} "
                                 f"(max {scale}), moments {dm}")
                    cases[n, dtype, site] = calls
        # event times first: after torch.profiler has run, launches cost
        # the host more
        times = {}
        for key, calls in cases.items():
            for _ in range(args.rounds):
                for name in ("baseline", "port", "port", "baseline",
                             "cudnn", *probes):
                    times.setdefault((key, name, "event_ms"), []).append(
                        None if calls[name] is None
                        else cs.cuda_ms(torch, calls[name], reps=10))
        for _ in range(args.rounds):
            for name in ("baseline", "port", "port", "baseline", "cudnn",
                         *probes):
                keys = [key for key in cases if cases[key][name] is not None]
                each = device_ms_groups(
                    torch, [cases[key][name] for key in keys], 10)
                for key in cases:
                    times.setdefault((key, name, "device_ms"), [])
                for key, ms in zip(keys, each):
                    times[key, name, "device_ms"].append(ms)
    for n in (cs.MAIN_BATCH, cs.BENCH_BATCH):
        for dtype in (torch.float32, torch.bfloat16):
            for label, group in (("conv_ab", counts), ("no_prologue", bare)):
                if group:
                    print(json.dumps(summary(
                        times, tiles, label, group, n, dtype, impls,
                        args.rounds, cs)), flush=True)


def summary(times, tiles, label, counts, n, dtype, impls, rounds, cs):
    """One JSON object: the per-forward sums of ``counts``'s sites and the
    by-site rows, each the least of its turns."""
    sums = {name: {"device_ms": 0.0, "event_ms": 0.0} for name in impls}
    sums["bound_ms"] = 0.0
    by_site = {}
    for site, cnt in counts.items():
        bytes_ms, ops_ms = cs.conv_bounds_ms(site, n, dtype)
        row = {"launches": cnt, "bound_ms": cnt * max(bytes_ms, ops_ms),
               **tiles[n, dtype, site]}
        for name in impls:
            row[name] = {}
            for metric in ("device_ms", "event_ms"):
                got = [v for v in times[(n, dtype, site), name,
                                        metric] if v is not None]
                ms = cnt * min(got) if got else None
                row[name][metric] = ms
                if ms is None or sums[name][metric] is None:
                    sums[name][metric] = None
                else:
                    sums[name][metric] += ms
        sums["bound_ms"] += row["bound_ms"]
        by_site["/".join(str(int(v)) for v in site)] = row
    return {label: str(dtype)[6:], "batch": n, "rounds": rounds,
            "min_of": 2 * rounds, **sums, "by_site": by_site}


if __name__ == "__main__":
    main()
