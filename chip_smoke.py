#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which exits non-zero on
failure (nothing is caught and passed over) and prints its seconds:

1. setup: card name and power limit, versions, TF32 flags, optional modules;
2. build: the CUDA kernels, from the sources in the checkout, one nvcc each;
3. sites: the shapes each kernel sees in one forward of the flagship U-Net
   (ch 32, mult 1,2,4,8, 6 blocks, attention at 16 and 8) at 64x64 and at
   the trainer's 128x128, and of the rectified NCSN++ (256x256, nf 128,
   mult 1,1,2,2,2,2,2, 2 blocks, attention at 16);
4. kernel parity: each kernel against its plain PyTorch version at every
   site of the main paths, in float32 and bf16: the conv kernel at the
   64x64 U-Net's sites at the main-path batch of 20 images and the bench
   batch of 320 (where the 8x8 sites take tiles of two samples), the
   128x128 U-Net's at 20 (the restoration halves), every epilogue
   combination with and without moments, a batch the two-sample tiles do
   not divide and a ragged image, and the SASS of every conv kernel
   function the script launched must hold HGMMA (and the counts of HGMMA
   and of TMA loads, UTMALDG, go on the ``kernels`` line); both
   GroupNorm entries at the 64x64 sites at 20 images and the 128x128 ones
   at 4 (where float32 samples of 64 and 96 channels fit no cluster and
   take the two-phase path), and groupnorm_swish in float32, forward and
   the gradients through its autograd function, with the launch plans the
   model's forward takes there, at every batch a path runs it under a
   gradient: the 128x128 sites at the training batch of 128, the GS
   trainer's 32 and the GS restoration's 4, and the 64x64 sites at the
   differentiated methods' 4; the conv, GroupNorm and FIR kernels must also repeat bit for
   bit, and each FIR site must take the tiled path (the narrow one at
   C = 3); then under autodiff at the differentiated methods' batch of 4:
   upfirdn2d's backward (the kernel in the adjoint geometry) at every
   NCSN++ site, on the path predicted and bit for bit, and
   groupnorm_swish's JVP at every 64x64 site;
5. model parity: the random flagship U-Net with ``fused_norm`` True, "bm"
   and "conv" against False, and the random NCSN++ 256^2 on the card
   against the same weights on the CPU; then training: the flagship at
   128x128 and the training batch of 128, its flow-matching loss and every
   parameter's gradient with ``fused_norm`` True against False (summed over
   slices of 32 images); then autodiff: the flagship's VJP and JVP at
   64x64 and 4 images, True against False, and the NCSN++ 256^2's VJP on
   the card against the CPU; then the gradient-step denoiser on the
   flagship at 128x128 and 4 images (Dg and every parameter's GS-loss
   gradient, second order through the GroupNorm rules, True against
   False), and the full-width DiffUNet at 256x256 and 2 images on the card
   against the CPU, with its time and peak memory per 4-image forward;
   then the metric networks: the FID InceptionV3 (synthetic weights,
   written by the port's converter) at 2 images and LPIPS (seeded AlexNet)
   at 4, at 64x64 and 256x256, the card against the CPU;
6. main path: the port's CLI, pnp_flow on synthetic images -- the U-Net at
   64x64 (FFT deblur; "conv" fp32 at 100 steps, "conv" bf16, True and "bm"
   at 10) and the rectified NCSN++ at 256x256 (FFT deblur fp32 at 3 steps,
   cut from 100 to keep the script within half its time limit, bf16 at 10,
   super-resolution at 3) -- then ``train True eval True``:
   the flagship ``ot`` U-Net trained at 128x128, batch 128, exact OT, fp32,
   for 4 steps, and restored from the checkpoint it wrote (FFT deblur, 10
   steps); then the differentiated methods, fp32, FFT deblur, 4 images:
   the U-Net at 64x64 with ot_ode at 25 steps (20 VJP steps, cut from the
   default 100), flow_priors at N 5 (cut from the default 100; K 1),
   d_flow with max_iter cut from 20 to 1 and its LBFGS iterations from 20
   to 2 (these cuts keep the script within half its time limit)
   and ot_ode on bicubic super-resolution (GMRES, 10 steps), and the
   NCSN++ 256^2 with ot_ode at 5 steps (4 VJPs) and flow_priors at N 1;
   then pnp_gs with ``model gradient_step`` (the flagship at 64x64, 4
   images): pgd and hqs FFT deblurring and hqs random inpainting at 15
   iterations (cut from the default 30), hqs bicubic SR at 10, and pgd at
   10, whose peak memory must equal the 15-iteration run's; ``train True
   eval True`` with ``model gradient_step`` at 128x128 for 1 epoch of the
   256-image
   synthetic split at batch 32 (cut from the config's 128: a GS step keeps
   about 2 GB an image at 128x128, so 32 is the largest power of two that
   fits the card's 80 GB), then 10 pgd iterations from the checkpoint it
   wrote; pnp_diff with ``model diffusion`` (the full-width
   DiffUNet at 256x256, 4 images): FFT deblurring at 10 steps (cut from
   the default 100 to keep the script within half its time limit)
   and laplace-noise inpainting (the L1 dual prox) at 5; every CLI run
   with ``lpips_alex.npz`` in place, so it reports LPIPS; then the metric
   stack: ``compute_metrics True`` with the flagship at 64x64 (100 samples,
   cut from the protocol's 5000, by Euler in 10 steps, on the Inception
   features, then 10 PnP steps) and one dopri5 chunk of 50 samples; the FM
   trainer's FID curve on the checkpoint the training run wrote (n 100,
   twice, one train step apart), each compute_metrics line held against
   the same statistics recomputed on the CPU from the features it cached;
   ``remat`` False and True on each method that differentiates the model
   (U-Net 64x64 ot_ode, d_flow and pnp_gs, NCSN++ 256^2 flow_priors at
   N 1: equal results, both peaks); and the serving
   API (``Restorer``, pnp_flow at 64x64, 4 images, 10 steps: warmup and
   two seeded restores, bit for bit);
   every launch counter set to 0 before each run and read after;
6c. rf_zoo: the rectified-flow entry point (``pnpflow_tpu_torch/rf_main.py``) on
   the CelebA-HQ NCSN++ 256^2 config (nf 128, mult 1,1,2,2,2,2,2, 2 blocks,
   attention at 16, FIR [1,3,3,1]): one train step at batch 1, card against
   CPU on the same real-scale weights, z0 and t (loss rel 1e-5, gradients
   1e-4 of each max); ``--mode train`` at batch 12 (cut from 64; the
   largest of 8 or 12 that fits) for 2 steps on synthetic data from the
   seeded init, ``sample`` (rk45, ode_tol 1e-5, 2 samples) from the state it
   wrote, ``reflow`` with train_reflow and train_online_reflow (1
   iteration each at batch 4, sample_N cut to 10; online generates in 20
   Euler steps), ``generate_pairs`` (8) and bits/dim (4 images, 2 midpoint
   steps, 1 probe, each a JVP: the FIR kernel on the tangent), every FIR
   launch counted by role; then cifar10_rf_gaussian_ddpmpp (no FIR) trained
   3 steps at its batch of 128 and its loss and gradients at 32 images,
   card against CPU, score_sde's
   cifar10 DDPM and ncsnv2's CelebA NCSNv2 64^2 forwards, card against CPU
   within 1e-4;
6d. parallel (this slice: data parallelism, the backends, the profiler and
   the demos): the FM trainer step (the 128^2 flagship, fused_norm True,
   batch 128, precoupled exact OT) and the GS trainer step (batch 32), 2
   steps each without a process group and under ``init_distributed`` at
   world size 1 over NCCL, equal bit for bit (cuDNN deterministic);
   ``Restorer(shard=True, n_devices=1)`` against ``shard=False`` (bit for
   bit) and two shards on the one card (two threads, within 1e-4); the
   restorations that couple a batch (d_flow, ot_ode on bicubic SR, pnp_gs
   hqs deblurring: one solver, the network fanned out), two shards on card
   0, and on cards 0 and 1 where two are visible, against unsharded within
   1e-4, with the GroupNorm kernel's launches by card and its plain-version
   parity on each card;
   ``ComputeMetric`` with the sampler and the Inception chunker fanned out
   over two copies on the card (n 100); ``train True`` through the CLI on
   a generated CelebA-layout folder at 128^2 with ``data_backend grain``
   and ``ckpt_backend orbax`` (2 epochs, a resume to 4, retention of 3);
   one forward per ``fused_norm`` "dot", "tview" and "bf16stats", fp32
   and bf16, against False, with its time; the three demos at shrunk knobs;
   and, after the profiles of 8., a ``jax_profile`` restoration and the
   report's top ops;
7. timing: CUDA-event times of each kernel, its plain version and the
   PyTorch library call, per forward at the bench shapes (U-Net: 64x64, 64
   images x 5 Monte-Carlo samples, and for conv3x3_gn and both GroupNorm
   entries also the main-path 20; NCSN++: 256x256, 4 x 5, upfirdn2d also
   by site, and its adjoint per NCSN++ VJP at 4 images), the forwards per
   mode (median of 5), PnP steps and the peak memory of a rectified step;
   each CLI run's seconds per iteration and peak memory;
8. profiles, last, since the profiler leaves later launches slower on the
   host: the GroupNorm kernels' device time per forward, the upfirdn2d
   kernels' per NCSN++ forward and by site and their adjoint launches' per
   NCSN++ VJP at 4 images, torch.profiler kernel
   breakdowns of one U-Net forward with ``fused_norm`` True per dtype and
   of one float32 NCSN++ forward, and one train step of the 128x128
   flagship at batch 128, split into forward, backward, Adam and EMA.

Before the result, the script stops the grain workers' forkserver and
resource tracker and fails if any process it started still runs (and kills
it).  JSON lines precede the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_BW = 3.35e12                     # H100 SXM HBM3 bytes/s
PEAK = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}  # FLOP/s, dense
FLAGSHIP = dict(input_channels=3, input_height=64, ch=32,
                ch_mult=(1, 2, 4, 8), num_res_blocks=6,
                attn_resolutions=(16, 8))
RECT_DIM = 256          # the NCSN++ 256^2 (CelebA-HQ / AFHQ-Cat) defaults
RECT_FIR_SITES = 36     # upfirdn2d calls per NCSN++ 256^2 forward
RECT_FIR_NARROW = 12    # of which C = 3 (the image pyramids)
RECT_FIR_TRAIN_ADJOINT = 30  # adjoint launches of a backward to the weights
# only: the input pyramid's 6 downsamples have nothing to differentiate
CLI_STEPS = 100         # main-path PnP steps: the CLI default
RECT_CLI_STEPS = 3      # the rectified fp32 runs (deblur and SR), cut from
                        # 100 (about 2 s a step on an H100) to keep the
                        # script within half its time limit
MAIN_BATCH = 4 * 5      # batch_size_ip x num_samples: images per forward
BENCH_BATCH = 64 * 5    # the bench protocol: 64 images x 5 MC samples
NCSNPP_REL_TOL = 1e-4   # NCSN++ card vs CPU, relative to max|out|, fp32
KERNELS = ("conv3x3_gn", "groupnorm_swish", "groupnorm_swish_bm",
           "upfirdn2d")
TWO_PHASE_BATCH = 4     # images at the 128x128 U-Net's GroupNorm sites
TWO_PHASE_SITES = [(128, c, True) for c in (32, 64, 96)]
FORWARD_REPS = 5        # model forwards are the median of this many
TRAIN_DIM = 128         # CelebA's geometry (config/dataset_config/celeba.yaml)
TRAIN_BATCH = 128       # batch_size_train (config/main_config.yaml)
TRAIN_EPOCHS = 2        # x 2 steps: the synthetic train split is 256 images
TRAIN_STEPS_PER_EPOCH = 2
TRAIN_PARITY_CHUNK = 32  # images per plain-GroupNorm slice in training parity
CONV_SITES = 109        # conv3x3_gn launches per flagship forward
PLOT_FORWARDS = 10      # the Euler sample plot at epoch 0, with matplotlib
NOISE_FLOOR = 1e-6      # of the largest gradient: float32 rounding noise
GN_SITES_64 = 136       # groupnorm_swish launches per 64x64 flagship forward
DIFF_BATCH = 4          # batch_size_ip of ot_ode / flow_priors / d_flow
OT_ODE_STEPS = 25       # steps_ode, cut from the default 100: from
                        # start_time 0.2, 20 steps
FP_N = 5                # flow_priors N, cut from the default 100 (K 1)
D_FLOW_MAX_ITER = 1     # of the default 20 LBFGS steps
D_FLOW_LBFGS_ITER = 2   # LBFGS iterations a step, cut from the default 20
# (both cuts keep the script within half its time limit)
BICUBIC_STEPS = 10      # ot_ode steps_ode for bicubic SR (GMRES): 8 steps
RECT_OT_STEPS = 5       # ot_ode on the NCSN++ 256^2: 4 VJP steps
RECT_FP_N = 1           # flow_priors on the NCSN++ 256^2: 1 outer step
GS_PARITY_BATCH = 4     # images of the GS denoiser parity at 128x128
GS_ITERS = 15           # pnp_gs max_iter, cut from the default 30
GS_SR_ITERS = 10        # pnp_gs hqs bicubic SR
GS_TRAIN_BATCH = 32     # the GS trainer's batch, cut from 128 (memory)
GS_TRAIN_EPOCHS = 1
GS_EVAL_BATCH = 4       # batch_size_ip of the GS restoration at 128x128
GS_EVAL_ITERS = 10      # pgd iterations restoring with the trained weights
SYNTHETIC_TRAIN = 256   # images in the synthetic train split
DIFF_DIM = 256          # the DiffUNet's geometry (DiffPIR ffhq_10m)
DIFFUNET_PARITY_BATCH = 2
PNP_DIFF_STEPS = 10     # pnp_diff max_iter, cut from the default 100
                        # (about 0.35 s a step)
PNP_DIFF_LAPLACE_STEPS = 5
METRIC_N = 100          # compute_metrics and FID-curve samples, cut from
                        # the protocol's 5000 to keep the script within
                        # half its time limit
METRIC_STEPS = 10       # Euler steps of the compute_metrics run
METRIC_BATCH = 50       # the sampling and Inception sub-batch
INCEPTION_TOL = 1e-4    # pool3 card vs CPU, of max|pool3|; probs 1e-5
LPIPS_TOL = 1e-5        # LPIPS card vs CPU, relative
METRIC_DIMS = (64, 256)
SERVE_STEPS = 10        # steps_pnp of the serving run, cut from 100
REMAT_OT_STEPS = 5      # remat False / True: ot_ode steps_ode (4 VJPs),
REMAT_LBFGS_ITER = 1    # d_flow's LBFGS iterations in its one step,
REMAT_GS_ITERS = 3      # pnp_gs iterations
METRIC_REL_TOL = 1e-4   # metrics.txt (card) against the CPU, relative
# the synthetic Inception and seeded LPIPS weight files, written once
RF_CONFIG = "celeba_hq_pytorch_rf_gaussian"   # the rf_zoo phase's config
RF_BATCH = 12           # its training batch, cut from the config's 64
RF_TRAIN_STEPS = 2
RF_SAMPLES = 2          # rk45 at the config's ode_tol 1e-5
RF_REFLOW_ITERS = 1     # each reflow mode,
RF_REFLOW_BATCH = 4     # at this training.batch_size
RF_SAMPLE_N = 10        # sampling.sample_N of reflow and pairs, cut from 1000
RF_ONLINE_GEN = 20      # online reflow's Euler steps (the JAX default)
RF_PAIRS = 8            # reflow.total_number_of_samples
RF_BPD_BATCH = 4        # bits/dim: images, midpoint steps (cut from 100),
RF_BPD_STEPS = 2        # and one probe
CIFAR_BATCH = 128       # cifar10_rf_gaussian_ddpmpp's training.batch_size
CIFAR_PARITY_BATCH = 32  # its loss and gradients card vs CPU, cut from 128
                        # (the CPU side is the cost)
RF_REL_TOL = 1e-4       # the small configs card vs CPU, relative to max
METRIC_WEIGHTS = {}


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
    fir = launch_counters()["upfirdn2d"]
    fir.paths = dict.fromkeys(fir.paths, 0)
    fir.roles = dict.fromkeys(fir.roles, 0)
    launch_counters()["groupnorm_swish"].cards.clear()


def fir_paths():
    return dict(launch_counters()["upfirdn2d"].paths)


def fir_roles():
    """upfirdn2d launches by role: "forward", "adjoint" (the backward) and
    "tangent" (forward mode)."""
    return dict(launch_counters()["upfirdn2d"].roles)


def read_counts():
    return {k: fn.launches for k, fn in launch_counters().items()}


def only(**counts):
    return {k: counts.get(k, 0) for k in KERNELS}


def fir_forward_paths(forwards):
    """upfirdn2d launches by path over ``forwards`` NCSN++ 256^2 forwards:
    the tiled path, and the narrow one for the C = 3 image pyramids."""
    return {"tiled": (RECT_FIR_SITES - RECT_FIR_NARROW) * forwards,
            "narrow": RECT_FIR_NARROW * forwards, "general": 0}


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
                      "cv2")}
    emit({"setup": {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda, "python": sys.version.split()[0],
                    "tf32": flags, "importable": mods}})
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
    return conv_sass()


def conv_sass():
    """Per conv3x3_gn kernel function of the built library, by
    ``fused_conv_gn.tile_key``: its counts of HGMMA (wgmma) and UTMALDG
    (TMA loads) in ``cuobjdump -sass``."""
    import re

    from pnpflow_tpu_torch.ops import _build
    from pnpflow_tpu_torch.ops.fused_conv_gn import WARPGROUPS, tile_key

    import torch

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_build.library_path(
        "conv3x3_gn"))], capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    names = {}
    for (bm, (nwg, mw)) in WARPGROUPS.items():
        for bn in (32, 64, 128):
            for dtype, mangled in ((torch.float32, "f"),
                                   (torch.bfloat16, "13__nv_bfloat16")):
                names[f"conv3x3_gn_kernelI{mangled}Li{bn}ELi{nwg}ELi{mw}E"
                      ] = tile_key(dtype, bm, bn)
    counts, key = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = next((k for n, k in names.items() if n in m.group(1)),
                       None)
            if key:
                counts[key] = {"HGMMA": 0, "UTMALDG": 0}
            continue
        if key:
            for op in ("HGMMA", "UTMALDG"):
                counts[key][op] += op in line
    check(counts, "no conv3x3_gn kernel function in the SASS")
    return counts


# ---------------------------------------------------------------- 3. sites
def unet_sites(torch, dev, dim=64):
    """Record, with forward hooks on a batch-1 plain forward, the shapes each
    kernel sees in one forward of the flagship at dim x dim: GroupNorm sites
    (hw, c, swish) and conv sites (hw, cin, cout, prologue, sample_bias,
    residual)."""
    from pnpflow_tpu_torch.models.unet import (
        ResidualBlock, SelfAttention, VelocityUNet)

    m = VelocityUNet(**dict(FLAGSHIP, input_height=dim)).to(dev).eval()
    gn, conv = [], [(dim, 3, 32, False, False, False)]

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
        m(torch.zeros(1, dim, dim, 3, device=dev), torch.zeros(1, device=dev))
    gn.append((dim, 32, True))  # end_norm
    check(len(gn) == gn_sites_at(dim) and len(conv) == CONV_SITES,
          f"{dim}x{dim} site count {len(gn)} / {len(conv)}")
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
    record.launches, record.paths = 0, dict.fromkeys(upfirdn_mod.PATHS, 0)
    record.roles = dict.fromkeys(upfirdn_mod.ROLES, 0)
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
def kernel_parity(torch, dev, gn_sites, conv_sites, firs, train_sites):
    """``train_sites`` are the 128x128 U-Net's (gn, conv) sites: its conv
    sites run in the restoration half of the training CLI run, its
    GroupNorm sites in the train step."""
    from pnpflow_tpu_torch.ops.fused_conv_gn import (
        conv3x3_gn, conv3x3_gn_reference, launch_plan)
    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_plan, gn_swish_reference, groupnorm_swish_fwd)
    from pnpflow_tpu_torch.ops.gn_swish_bm import groupnorm_swish_bm_fwd
    from pnpflow_tpu_torch.ops.upfirdn import upfirdn2d, upfirdn2d_reference

    n = MAIN_BATCH
    err = {k: 0.0 for k in KERNELS}
    gn_cases = [(n, site) for site in sorted(set(gn_sites))] + [
        (TWO_PHASE_BATCH, site) for site in TWO_PHASE_SITES]
    paths = Counter()
    for name, fn in (("groupnorm_swish", groupnorm_swish_fwd),
                     ("groupnorm_swish_bm", groupnorm_swish_bm_fwd)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            for i, (bn, (h, c, swish)) in enumerate(gn_cases):
                x, s, b = gn_inputs(torch, dev, bn, h, c, dtype, i)
                got = fn(x, s, b, 32, 1e-6, swish)
                torch.cuda.synchronize()
                want = gn_swish_reference(x, s, b, 32, 1e-6, swish)
                d = float((got.float() - want.float()).abs().max())
                where = f"{name} {dtype} at {(bn, h, c, swish)}"
                check(got.dtype == dtype and d <= tol, f"{where}: err {d}")
                check(torch.equal(got, fn(x, s, b, 32, 1e-6, swish)),
                      f"{where}: not bit-for-bit")
                paths[gn_plan(bn, h * h, c, 32, x.element_size()).path] += 1
                if dtype == torch.float32:
                    err[name] = max(err[name], d)
    check(set(paths) == {"cluster", "two_phase"},
          f"GroupNorm parity did not reach both paths: {dict(paths)}")
    # the forward plans of every batch and size a path of the script runs
    # the kernel at under a gradient: the FM train step, the GS train step,
    # the GS restoration and parity at 128x128, and the differentiated
    # methods (pnp_gs among them) at 64x64
    by_dim = {TRAIN_DIM: train_sites[0], 64: gn_sites}
    train_plans = {}
    for j, (dim, bn) in enumerate(dict.fromkeys((
            (TRAIN_DIM, TRAIN_BATCH), (TRAIN_DIM, GS_TRAIN_BATCH),
            (TRAIN_DIM, GS_EVAL_BATCH), (TRAIN_DIM, GS_PARITY_BATCH),
            (64, DIFF_BATCH)))):
        train_plans[f"{dim}x{dim}/{bn}"] = train_gn_parity(
            torch, dev, by_dim[dim], bn, 300 + 1000 * j)

    combos = [(32, 64, 64, p, s, r) for p in (False, True)
              for s in (False, True) for r in (False, True)]
    # (batch, site): every 64x64 site at the main-path batch and the bench
    # batch, the 128x128 ones and the epilogue combinations at the main-path
    # batch, and a batch that tiles of two 8x8 samples do not divide (133);
    # then a ragged 7 x 12 image with every flag (the sites are square)
    cases = [(b, site) for b in (n, BENCH_BATCH)
             for site in sorted(set(conv_sites))]
    cases += [(n, site) for site in sorted(
        (set(train_sites[1]) | set(combos)) - set(conv_sites))]
    cases += [(133, (8, 128, 256, True, True, False))]
    ragged = (3, 7, 12, 40, 64)
    plans, spans = Counter(), 0
    for dtype, ytol, mtol in ((torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, 2e-2, 2e-2)):
        for i, (bn_, site) in enumerate(cases + [(ragged[0], None)]):
            if site is None:  # the ragged image, every flag
                _, h_, w_, c_, co_ = ragged
                g = torch.Generator(device=dev).manual_seed(77)
                x = torch.randn(bn_, h_, w_, c_, generator=g,
                                device=dev).to(dtype)
                w = (torch.randn(3, 3, c_, co_, generator=g, device=dev)
                     / (9 * c_) ** 0.5).to(dtype)
                b = torch.randn(co_, generator=g, device=dev) * 0.1
                args = (x, w, b)
                kw = dict(prologue=(torch.rand(bn_, c_, generator=g,
                                               device=dev) + 0.5,
                                    torch.randn(bn_, c_, generator=g,
                                                device=dev)),
                          sample_bias=torch.randn(bn_, co_, generator=g,
                                                  device=dev),
                          residual=torch.randn(bn_, h_, w_, co_, generator=g,
                                               device=dev).to(dtype))
                where = f"ragged {ragged}"
            else:
                args, kw = conv_inputs(torch, dev, bn_, site, dtype, 100 + i)
                where = f"n {bn_} at {site}"
            plan = launch_plan(*args[0].shape[:3], args[1].shape[-1])
            plans[f"{plan.bm}x{plan.bn}/{plan.samples}"] += 1
            spans += plan.samples > 1
            for emit_m in ((True, False) if site in combos else (True,)):
                y, m = conv3x3_gn(*args, emit_moments=emit_m, **kw)
                torch.cuda.synchronize()
                y2, m2 = conv3x3_gn_reference(*args, emit_moments=emit_m,
                                              **kw)
                scale = float(y2.float().abs().max())
                d = float((y.float() - y2.float()).abs().max())
                check(y.dtype == dtype and d <= ytol * scale,
                      f"conv3x3_gn {dtype} {where}: y err {d} "
                      f"(max|y| {scale})")
                if emit_m:
                    for k in range(2):
                        ref = float(m2[:, k].abs().max())
                        dm = float((m[:, k] - m2[:, k]).abs().max())
                        check(dm <= mtol * ref,
                              f"conv3x3_gn {dtype} {where}: moment {k} "
                              f"err {dm} (max {ref})")
                else:
                    check(m is None, "moments returned when not asked")
                y3, m3 = conv3x3_gn(*args, emit_moments=emit_m, **kw)
                check(torch.equal(y, y3) and (m is None or torch.equal(m, m3)),
                      f"conv3x3_gn {dtype} {where}: not bit-for-bit")
                if dtype == torch.float32:
                    err["conv3x3_gn"] = max(err["conv3x3_gn"], d)
    check(spans > 0, "no conv3x3_gn case took a tile of several samples")

    # fp32: atol 1e-5 (16 fp32 products of O(1) values); bf16: one bf16
    # rounding of outputs below 4, where an ulp is 2^-6.  Sums in a fixed
    # order, no atomics: repeats are bit for bit.  Each NCSN++ site takes
    # the tiled path, or the narrow one at C = 3.
    fir_path_counts = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for i, site in enumerate(sorted(set(firs))):
            x, k, kw = fir_inputs(torch, dev, n, site, dtype, 200 + i)
            before = fir_paths()
            got = upfirdn2d(x, k, **kw)
            torch.cuda.synchronize()
            path = [p for p, v in fir_paths().items() if v != before[p]]
            want = upfirdn2d_reference(x, k, **kw)
            d = float((got.float() - want.float()).abs().max())
            where = f"upfirdn2d {dtype} at {site[:7]}"
            check(got.dtype == dtype and got.shape == want.shape
                  and d <= tol, f"{where}: err {d}")
            check(torch.equal(got, upfirdn2d(x, k, **kw)),
                  f"{where}: not bit-for-bit")
            check(path == ["narrow" if site[2] == 3 else "tiled"],
                  f"{where}: took path {path}")
            fir_path_counts[path[0]] = fir_path_counts.get(path[0], 0) + 1
            if dtype == torch.float32:
                err["upfirdn2d"] = max(err["upfirdn2d"], d)
    emit({"kernel_parity": {"gn_sites": len(gn_cases),
                            "gn_paths": dict(paths),
                            "gn_train_plans": train_plans,
                            "conv_cases": 2 * (len(cases) + 1),
                            "conv_plans": dict(plans),
                            "fir_sites": len(set(firs)),
                            "fir_paths": fir_path_counts, "batch": n,
                            "max_abs_err_fp32": err}})
    return err, train_plans


def train_gn_parity(torch, dev, sites, n, seed=300):
    """groupnorm_swish in float32 at each GroupNorm site in ``sites`` and
    ``n`` images, with the plans a forward of the model launches there
    (``gn_plan`` depends on n).  The output within 1e-4 of the plain
    version and bit for bit on a repeat; x's, the scale's and the bias's
    gradients through the autograd function within 1e-4 of each gradient's
    max|g| against autograd through the plain version.  Returns each
    site's plan."""
    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_plan, gn_swish_reference, groupnorm_swish, groupnorm_swish_fwd)

    plans, worst = [], {"fwd": 0.0, "grad_rel": 0.0}
    for i, (h, c, swish) in enumerate(sorted(set(sites))):
        where = f"groupnorm_swish float32 at {(n, h, c, swish)}"
        x, s, b = gn_inputs(torch, dev, n, h, c, torch.float32, seed + i)
        with torch.no_grad():
            got = groupnorm_swish_fwd(x, s, b, 32, 1e-6, swish)
            torch.cuda.synchronize()
            want = gn_swish_reference(x, s, b, 32, 1e-6, swish)
            d = float((got - want).abs().max())
            check(d <= 1e-4, f"{where}: err {d}")
            check(torch.equal(got, groupnorm_swish_fwd(x, s, b, 32, 1e-6,
                                                        swish)),
                  f"{where}: not bit-for-bit")
            del got, want
        worst["fwd"] = max(worst["fwd"], d)
        dy = torch.randn(x.shape, generator=torch.Generator(
            device=dev).manual_seed(seed + 100 + i), device=dev)
        grads = []
        for fn in (groupnorm_swish, gn_swish_reference):
            args = [a.detach().requires_grad_() for a in (x, s, b)]
            fn(*args, 32, 1e-6, swish).backward(dy)
            grads.append([a.grad for a in args])
            del args
        for k, gk, gr in zip("xsb", *grads):
            scale = float(gr.abs().max())
            rel = float((gk - gr).abs().max()) / scale
            check(rel <= 1e-4, f"{where}: d{k} rel err {rel}")
            worst["grad_rel"] = max(worst["grad_rel"], rel)
        del x, dy, grads
        p = gn_plan(n, h * h, c, 32, 4)
        plans.append({"site": [h, c, swish], "path": p.path, "k": p.k})
    torch.cuda.empty_cache()
    emit({"kernel_parity": "groupnorm_swish_train", "batch": n,
          "image": max(h for h, _, _ in sites), "plans": plans,
          "sites": len(plans), "max_abs_err": worst["fwd"],
          "grad_worst_rel_err": worst["grad_rel"],
          "tolerances": {"fwd_abs": 1e-4, "grad_rel_of_max": 1e-4}})
    return plans


def autodiff_kernel_parity(torch, dev, firs, gn_sites):
    """The kernels under autodiff at the differentiated methods' batch:
    upfirdn2d's backward at every NCSN++ 256^2 site, in float32 and bf16 --
    the kernel launched in the adjoint geometry, against autograd through
    the plain version on the card, on the path predicted (tiled; narrow at
    C = 3), bit for bit on a repeat -- and groupnorm_swish's JVP at every
    64x64 site: the primal the kernel's forward, bit for bit, the tangent
    the plain forward-mode rule against forward AD through the plain
    version.  Bounds: FIR fp32 1e-5, bf16 2e-2, each times max(1, max|dx|)
    (the up sites' adjoint sums 16 taps of up to 0.56 into gradients near
    5); GroupNorm tangent fp32 1e-4, bf16 5e-2 of max|tangent|."""
    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_swish_reference, groupnorm_swish, groupnorm_swish_fwd)
    from pnpflow_tpu_torch.ops.upfirdn import (
        adjoint_geometry, upfirdn2d, upfirdn2d_reference)

    n, err, paths = DIFF_BATCH, {}, Counter()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        dt = str(dtype)[6:]
        for i, site in enumerate(sorted(set(firs))):
            x, k, kw = fir_inputs(torch, dev, n, site, dtype, 500 + i)
            g = torch.Generator(device=dev).manual_seed(600 + i)
            y = upfirdn2d_reference(x, k, **kw)
            dy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
            where = f"upfirdn2d adjoint {dt} at {site[:7]}"
            grads = []
            reset_counts()
            for fn in (upfirdn2d, upfirdn2d_reference):
                xr = x.clone().requires_grad_()
                grads.append(torch.autograd.grad(fn(xr, k, **kw), xr, dy)[0])
            torch.cuda.synchronize()
            got, want = grads
            path = "narrow" if site[2] == 3 else "tiled"
            check(fir_roles() == {"forward": 1, "adjoint": 1, "tangent": 0}
                  and fir_paths()[path] == 2,
                  f"{where}: roles {fir_roles()}, paths {fir_paths()}")
            paths[path] += 1
            taps, up, down, pad, crop = adjoint_geometry(
                site[0], site[1], k, kw["up"], kw["down"], kw["pad"])
            check(crop is None and torch.equal(
                got, upfirdn2d(dy, taps, up, down, pad)),
                f"{where}: not bit-for-bit")
            d = float((got.float() - want.float()).abs().max())
            scale = max(1.0, float(want.float().abs().max()))
            check(got.dtype == dtype and d <= tol * scale,
                  f"{where}: err {d} (max|dx| {scale})")
            err[f"upfirdn2d_adjoint/{dt}"] = max(
                err.get(f"upfirdn2d_adjoint/{dt}", 0.0), d / scale)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        dt = str(dtype)[6:]
        for i, (h, c, swish) in enumerate(sorted(set(gn_sites))):
            x, s, b = gn_inputs(torch, dev, n, h, c, dtype, 700 + i)
            dx = torch.randn(x.shape, generator=torch.Generator(
                device=dev).manual_seed(800 + i), device=dev).to(dtype)
            where = f"groupnorm_swish jvp {dt} at {(n, h, c, swish)}"
            reset_counts()
            y, got = torch.func.jvp(
                lambda z: groupnorm_swish(z, s, b, 32, 1e-6, swish), (x,),
                (dx,))
            torch.cuda.synchronize()
            check(read_counts() == only(groupnorm_swish=1),
                  f"{where}: launches {read_counts()}")
            check(torch.equal(y, groupnorm_swish_fwd(x, s, b, 32, 1e-6,
                                                     swish)),
                  f"{where}: the primal is not the kernel's forward")
            _, want = torch.func.jvp(
                lambda z: gn_swish_reference(z, s, b, 32, 1e-6, swish),
                (x,), (dx,))
            scale = float(want.float().abs().max())
            d = float((got.float() - want.float()).abs().max())
            check(got.dtype == dtype and d <= tol * scale,
                  f"{where}: err {d} (max {scale})")
            err[f"groupnorm_swish_jvp/{dt}"] = max(
                err.get(f"groupnorm_swish_jvp/{dt}", 0.0), d / scale)
    emit({"kernel_parity": "autodiff", "batch": n,
          "fir_adjoint_sites": len(set(firs)),
          "fir_adjoint_paths_per_dtype": {k: v // 2 for k, v in
                                          paths.items()},
          "gn_jvp_sites": len(set(gn_sites)),
          "max_err_of_scale": err,
          "tolerances": {"fir_adjoint": {"float32": 1e-5, "bfloat16": 2e-2,
                                         "of": "max(1, max|dx|)"},
                         "gn_jvp": {"float32": 1e-4, "bfloat16": 5e-2,
                                    "of": "max|tangent|"}}})
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
        launches, paths = read_counts(), fir_paths()
    vmax = float(want.abs().max())
    rel = float((got.cpu() - want).abs().max()) / vmax
    emit({"model_parity": "ncsnpp_256", "batch": 1, "max_abs_v": vmax,
          "rel_err": rel, "rel_tol": NCSNPP_REL_TOL, "launches": launches,
          "fir_paths": paths})
    check(torch.isfinite(got).all().item() and vmax > 1e-3,
          f"NCSN++ output not finite or vanishing (max {vmax})")
    check(rel <= NCSNPP_REL_TOL, f"NCSN++ card vs CPU: rel err {rel}")
    check(launches == only(upfirdn2d=RECT_FIR_SITES),
          f"NCSN++ launches {launches}")
    check(paths == fir_forward_paths(1), f"NCSN++ FIR paths {paths}")


def gn_sites_at(dim):
    """groupnorm_swish launches per forward of the flagship at dim x dim
    with ``fused_norm`` True: one per GroupNorm.  Attention sits at 16 and
    8, so the 128x128 U-Net has 14 attention norms where the 64x64 one has
    27: 123 launches against 136."""
    import torch.nn as nn
    from pnpflow_tpu_torch.models.unet import VelocityUNet

    m = VelocityUNet(**dict(FLAGSHIP, input_height=dim))
    return sum(isinstance(mod, nn.GroupNorm) for mod in m.modules())


def training_parity(torch, dev):
    """The flagship at 128x128 and the training batch of 128: the
    flow-matching loss and every parameter's gradient with ``fused_norm``
    True (the groupnorm_swish kernel forward at the train step's plans, its
    plain backward) in one batch, against False (plain GroupNorm under
    autograd), same weights and pairs.  The plain GroupNorm saves too many
    float32 temporaries for 128 images on one card, so False sums the loss
    and gradients of TRAIN_PARITY_CHUNK-image slices, each weighted by its
    share of the batch (every term is per sample, so that is the same sum).
    Loss within rel 1e-5; each gradient tensor within 1e-4 of its max|g|,
    except tensors whose gradient is zero in exact arithmetic (under False
    below 1e-6 of the largest gradient: rounding noise), held to being
    noise under True."""
    from pnpflow_tpu_torch.training.flow_matching import make_fm_loss

    n, dim = TRAIN_BATCH, TRAIN_DIM
    g = torch.Generator(device=dev).manual_seed(9)
    x0 = torch.randn(n, dim, dim, 3, generator=g, device=dev)
    x1 = 0.5 * torch.randn(n, dim, dim, 3, generator=g, device=dev)
    t = torch.rand(n, generator=g, device=dev)
    out, peak = {}, {}
    for fused in (False, True):
        torch.cuda.reset_peak_memory_stats()
        m = randomized_unet(torch, dev, fused, input_height=dim)
        fm_loss, total = make_fm_loss(m), 0.0
        reset_counts()
        for i in range(0, n, n if fused else TRAIN_PARITY_CHUNK):
            sl = slice(i, i + (n if fused else TRAIN_PARITY_CHUNK))
            share = (sl.stop - sl.start) / n
            loss = fm_loss(x0[sl], x1[sl], t[sl]) * share
            loss.backward()
            total += float(loss.detach())
        torch.cuda.synchronize()
        out[fused] = (total, read_counts(),
                      {k: p.grad for k, p in m.named_parameters()})
        peak[str(fused)] = torch.cuda.max_memory_allocated()
        del m, loss
        torch.cuda.empty_cache()
    (want, lw, gw), (got, lg, gg) = out[False], out[True]
    floor = NOISE_FLOOR * max(float(v.abs().max()) for v in gw.values())
    worst, noise = 0.0, []
    for k, w in gw.items():
        scale = float(w.abs().max())
        if scale < floor:
            noise.append(k)
            check(float(gg[k].abs().max()) < floor,
                  f"training parity: {k} is noise under False, not True")
            continue
        rel = float((gg[k] - w).abs().max()) / scale
        worst = max(worst, rel)
        check(rel <= 1e-4, f"training parity: {k} gradient rel err {rel}")
    rel_loss = abs(got - want) / abs(want)
    emit({"model_parity": "unet_training", "image": dim, "batch": n,
          "loss": [want, got], "loss_rel_err": rel_loss,
          "grad_worst_rel_err": worst, "grad_tensors": len(gw),
          "noise_tensors": noise, "launches": lg,
          "false_chunk": TRAIN_PARITY_CHUNK, "max_memory_allocated": peak,
          "tolerances": {"loss_rel": 1e-5, "grad_rel_of_tensor_max": 1e-4,
                         "noise_floor_of_max_grad": NOISE_FLOOR}})
    check(all(math.isfinite(v) for v in (want, got)), "loss not finite")
    check(rel_loss <= 1e-5, f"training parity: loss rel err {rel_loss}")
    check(lw == only() and lg == only(groupnorm_swish=gn_sites_at(dim)),
          f"training parity launches {lw} / {lg}")


def autodiff_model_parity(torch, dev, rect_state):
    """The flagship U-Net at 64x64 and the differentiated methods' batch,
    ``fused_norm`` True against False on the same weights: a VJP
    (``torch.autograd.grad``) and a JVP (``torch.func.jvp``), each within
    1e-4 of its max, the forward's bound, with 136 kernel launches in each
    True forward; then the NCSN++ 256^2's VJP on the card (upfirdn2d
    forward and adjoint) against the CPU (plain), batch 1, within
    NCSNPP_REL_TOL of max|dx|."""
    g = torch.Generator(device=dev).manual_seed(11)
    x, w = (torch.randn(DIFF_BATCH, 64, 64, 3, generator=g, device=dev)
            for _ in range(2))
    t = torch.rand(DIFF_BATCH, generator=g, device=dev)
    out = {}
    for fused in (False, True):
        m = randomized_unet(torch, dev, fused).requires_grad_(False)
        reset_counts()
        xr = x.clone().requires_grad_()
        (vjp,) = torch.autograd.grad(m(xr, t), xr, w)
        _, jvp = torch.func.jvp(lambda z: m(z, t), (x,), (w,))
        torch.cuda.synchronize()
        out[fused] = (vjp, jvp, read_counts())
        del m
    res = {}
    for i, name in enumerate(("vjp", "jvp")):
        want, got = out[False][i], out[True][i]
        rel = float((got - want).abs().max()) / float(want.abs().max())
        res[name] = rel
        check(torch.isfinite(got).all().item() and rel <= 1e-4,
              f"U-Net {name} True vs False: rel err {rel}")
    check(out[False][2] == only()
          and out[True][2] == only(groupnorm_swish=2 * GN_SITES_64),
          f"U-Net autodiff launches {out[False][2]} / {out[True][2]}")
    emit({"model_parity": "unet_autodiff", "batch": DIFF_BATCH,
          "rel_err": res, "launches": out[True][2], "rel_tol": 1e-4})

    xg = torch.Generator().manual_seed(12)
    x = torch.randn(1, RECT_DIM, RECT_DIM, 3, generator=xg)
    dy = torch.randn(x.shape, generator=xg)
    t = torch.tensor([0.43 * 999.0])
    grads = {}
    for d in ("cpu", dev):
        m = ncsnpp(torch, d, rect_state).requires_grad_(False)
        reset_counts()
        xr = x.to(d).requires_grad_()
        (grads[str(d)],) = torch.autograd.grad(m(xr, t.to(d)), xr, dy.to(d))
        if d == dev:
            torch.cuda.synchronize()
            launches, roles = read_counts(), fir_roles()
        del m
    want, got = grads["cpu"], grads[str(dev)].cpu()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    emit({"model_parity": "ncsnpp_256_vjp", "batch": 1, "max_abs_dx": scale,
          "rel_err": rel, "rel_tol": NCSNPP_REL_TOL, "launches": launches,
          "fir_roles": roles})
    check(torch.isfinite(got).all().item() and scale > 1e-3,
          f"NCSN++ VJP not finite or vanishing (max {scale})")
    check(rel <= NCSNPP_REL_TOL, f"NCSN++ VJP card vs CPU: rel err {rel}")
    check(launches == only(upfirdn2d=2 * RECT_FIR_SITES)
          and roles == {"forward": RECT_FIR_SITES,
                        "adjoint": RECT_FIR_SITES, "tangent": 0},
          f"NCSN++ VJP launches {launches}, roles {roles}")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ 6. main path
def method_keys(method):
    """The keys of ``config/method_config/{method}.yaml``: the header of
    ``final_psnr.txt`` after psnr_rec and psnr_noisy."""
    from pnpflow_tpu_torch.utils.config import load_cfg_from_cfg_file

    return list(load_cfg_from_cfg_file(os.path.join(
        HERE, "config", "method_config", f"{method}.yaml")))


def link_metric_weights(out, inception=False, lpips=True):
    """``lpips_alex.npz`` and ``inception_fid.npz``, each if asked, under
    out/model/."""
    os.makedirs(os.path.join(out, "model"), exist_ok=True)
    for name, want in (("inception_fid.npz", inception),
                       ("lpips_alex.npz", lpips)):
        if want:
            os.symlink(METRIC_WEIGHTS[name], os.path.join(out, "model", name))


def metrics_line(root, model="ot"):
    """The last metrics.txt line of a compute_metrics run, token by key."""
    with open(os.path.join(root, "results", "synthetic", model,
                           "metrics.txt")) as f:
        tok = f.read().splitlines()[-1].split()
    return dict(zip(tok[0::2], tok[1::2]))


def metrics_against_cpu(root, line):
    """FID, KID, KID_std, Vendi, SW, IS and IS_std of a ``compute_metrics``
    run, recomputed on the CPU by the same functions from the features the
    run cached (the test split's and every generated chunk's, with their
    probabilities): each metrics.txt value, which the card computed, must
    lie within METRIC_REL_TOL of its CPU value.  Returns the relative
    errors."""
    import glob

    import numpy as np

    from pnpflow_tpu_torch.metrics import generative as gen

    n = int(line["n"])
    cache = os.path.join(root, "results", "synthetic", "ot", "metric_cache")
    (tpath,) = glob.glob(os.path.join(cache, "test_*", f"feats_n{n}.npz"))
    (gdir,) = glob.glob(os.path.join(cache, "s*"))
    feats, probs = [], []
    for chunk in sorted(glob.glob(os.path.join(gdir, "chunk_*.npz"))):
        with np.load(chunk) as f:
            feats.append(f["feats"])
            probs.append(f["probs"])
    with np.load(tpath) as f:
        test = f["feats"]
    fgen, pgen = np.concatenate(feats)[:n], np.concatenate(probs)[:n]
    kid, kid_std = gen.kid_from_features(test, fgen, device="cpu")
    is_mean, is_std = gen.inception_score(pgen)
    cpu = {"FID": gen.fid_from_features(test, fgen), "KID": kid,
           "KID_std": kid_std,
           "Vendi": gen.vendi_score(fgen[:gen.VENDI_MAX], device="cpu"),
           "SW": gen.sliced_wasserstein(fgen, test, device="cpu"),
           "IS": is_mean, "IS_std": is_std}
    err = {k: abs(float(line[k]) - v) / abs(v) if v else
           abs(float(line[k])) for k, v in cpu.items()}
    emit({"metrics_against_cpu": {"n": n, "cpu": cpu, "rel_err": err}})
    check(all(e <= METRIC_REL_TOL for e in err.values()),
          f"metrics.txt against the CPU: relative errors {err}")
    return err


def cli_run(torch, extra, steps, ckpt=None, method="pnp_flow",
            metrics=False, lpips=True):
    """One CLI run on synthetic images, FFT deblurring unless ``extra``
    says otherwise, batch 4 (pnp_flow: x 5 MC samples, ``steps`` PnP
    steps), with the seeded ``lpips_alex.npz`` in place; checks the
    reference file set (LPIPS's included) and a finite PSNR and LPIPS and
    returns the launches, the time per batch and the peak memory it wrote.
    ``ckpt``, a ``.pt`` or ``.msgpack`` file, is linked in as the
    checkpoint of the model that ``extra`` names.  ``metrics`` also links
    ``inception_fid.npz`` and returns the ``metrics.txt`` line of a
    ``compute_metrics True`` run, its seconds by part and the relative
    errors of its values against the CPU (``metrics_against_cpu``);
    ``lpips=False`` leaves LPIPS out."""
    import ast

    from pnpflow_tpu_torch.main import main

    with tempfile.TemporaryDirectory() as out:
        link_metric_weights(out, inception=metrics, lpips=lpips)
        if ckpt is not None:
            model = extra[extra.index("model") + 1]
            ck = os.path.join(out, "model", "synthetic", model)
            os.makedirs(ck)
            os.symlink(ckpt, os.path.join(
                ck, "model_final" + os.path.splitext(ckpt)[1]))
        opts = ["dataset", "synthetic", "model", "ot", "eval", "True",
                "method", method, "problem", "gaussian_deblurring_FFT",
                "batch_size_ip", "4", "max_batch", "1",
                "save_results", "True", "compute_time", "True",
                "compute_memory", "True", "output_root", out]
        if method == "pnp_flow":
            opts += ["num_samples", "5", "steps_pnp", str(steps)]
        reset_counts()
        t0 = time.perf_counter()
        args = main(["--opts"] + opts + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, paths, roles = read_counts(), fir_paths(), fir_roles()
        ip = args.save_path_ip
        for f in ("psnr_rec_batch0.txt", "psnr_noisy_batch0.txt",
                  "ssim_rec_batch0.txt", "psnr_rec_average.txt",
                  "ssim_rec_average.txt", "time_stats.txt",
                  "time_average.txt", "memory_stats.txt",
                  "max_memory_average.txt",
                  *(("lpips_rec_batch0.txt", "lpips_noisy_batch0.txt")
                    if lpips else ()),
                  f"{args.problem}_{method}_batch0_final.png"):
            check(os.path.exists(os.path.join(ip, f)), f"missing {f}")
        with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
            header, row = f.readline().split(), f.readline().split()
        check(header == ["psnr_rec", "psnr_noisy"] + method_keys(method),
              f"final_psnr.txt header {header}")
        psnr = float(row[0])
        check(psnr == psnr and abs(psnr) != float("inf"),
              f"PSNR not finite: {psnr}")
        row_lp = [float("nan")]
        if lpips:
            with open(os.path.join(args.save_path, "final_lpips.txt")) as f:
                header, row_lp = f.readline().split(), f.readline().split()
            check(header[:2] == ["lpips_rec", "lpips_noisy"]
                  and all(math.isfinite(float(v)) for v in row_lp[:2]),
                  f"final_lpips.txt: {header} {row_lp}")
        line = metrics_line(out) if metrics else None
        cpu_err = metrics_against_cpu(out, line) if metrics else None
        metric_seconds = args.metrics["seconds"] if metrics else None
        with open(os.path.join(ip, "time_stats.txt")) as f:
            tstat = ast.literal_eval(f.readline().strip())
        with open(os.path.join(ip, "memory_stats.txt")) as f:
            mstat = ast.literal_eval(f.readline().strip())
    return {"method": method, "opts": extra, "steps": steps,
            "seconds": seconds, "final_psnr_rec": psnr,
            "final_psnr_noisy": float(row[1]),
            "final_lpips_rec": float(row_lp[0]), "metrics_line": line,
            "metrics_rel_err_against_cpu": cpu_err,
            "metric_seconds": metric_seconds,
            "launches": launches,
            "fir_paths": paths, "fir_roles": roles,
            "time_per_batch": tstat["time_per_batch"],
            "max_memory_allocated": mstat["max_allocated"]}


def main_path(torch, rect_ckpt):
    """Every run is read right after it; returns each kernel's launches on
    the run that drives it, and every run's result."""
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
        ("rect_fp32", rect, RECT_CLI_STEPS,
         only(upfirdn2d=RECT_FIR_SITES * RECT_CLI_STEPS)),
        ("rect_bf16", rect + ["bf16", "True"], 10,
         only(upfirdn2d=RECT_FIR_SITES * 10)),
        ("rect_sr_fp32", rect + ["problem", "superresolution"],
         RECT_CLI_STEPS, only(upfirdn2d=RECT_FIR_SITES * RECT_CLI_STEPS)),
    )
    runs = {}
    for name, extra, steps, expect in unet_runs + rect_runs:
        with phase(f"main_path/{name}"):
            r = cli_run(torch, extra, steps,
                        rect_ckpt if extra[:2] == rect[:2] else None)
        check(r["launches"] == expect,
              f"{name}: launches {r['launches']}, expected {expect}")
        if name.startswith("rect"):
            check(r["fir_paths"] == fir_forward_paths(steps),
                  f"{name}: upfirdn2d paths {r['fir_paths']}")
        emit({"main_path": name, "sites_per_forward":
              RECT_FIR_SITES if name.startswith("rect") else None, **r})
        runs[name] = r
    return {"conv3x3_gn": runs["conv_fp32"]["launches"]["conv3x3_gn"],
            "groupnorm_swish": runs["gn_fp32"]["launches"]["groupnorm_swish"],
            "groupnorm_swish_bm":
                runs["bm_fp32"]["launches"]["groupnorm_swish_bm"],
            "upfirdn2d": runs["rect_fp32"]["launches"]["upfirdn2d"]}, runs


def differentiated_path(torch, rect_ckpt):
    """ot_ode, flow_priors and d_flow through the CLI, fp32, FFT deblurring,
    4 images: the flagship U-Net at 64x64 (``fused_norm`` True, these
    methods' default) with ot_ode at OT_ODE_STEPS steps (from start_time
    0.2: 80% of them VJP steps), flow_priors at N = FP_N (K 1),
    d_flow with max_iter cut from 20 to D_FLOW_MAX_ITER and its LBFGS
    iterations from 20 to D_FLOW_LBFGS_ITER (each takes 10 forwards, 10
    recomputed, and a backward), and
    ot_ode on bicubic super-resolution (GMRES) at 10 steps; then the
    NCSN++ 256^2 with ot_ode at RECT_OT_STEPS steps and flow_priors at
    N = RECT_FP_N.  Launches: groupnorm_swish once per site in every
    forward (its tangent and cotangent are plain), upfirdn2d forward once
    per site in every forward, adjoint once per site whose input a
    backward must reach, tangent once per site in every JVP (the CPU test
    ``test_fir_launch_roles_of_the_differentiated_solvers`` counts the
    same).  Returns each run's result."""
    rect = ["model", "rectified", "dim_image", str(RECT_DIM)]
    gn, fir, pyr = GN_SITES_64, RECT_FIR_SITES, RECT_FIR_NARROW // 2
    ot_iters = OT_ODE_STEPS - int(OT_ODE_STEPS * 0.2)
    sr_iters = BICUBIC_STEPS - int(BICUBIC_STEPS * 0.2)
    rect_ot = RECT_OT_STEPS - int(RECT_OT_STEPS * 0.2)
    # name, method, options, iterations, launches (None: data-dependent,
    # checked below), FIR roles
    runs = (
        ("ot_ode_fp32", "ot_ode", ["steps_ode", str(OT_ODE_STEPS)],
         ot_iters,
         only(groupnorm_swish=gn * ot_iters), None),
        ("flow_priors_fp32", "flow_priors", ["N", str(FP_N)], FP_N,
         only(groupnorm_swish=2 * gn * FP_N), None),
        ("d_flow_fp32", "d_flow", ["max_iter", str(D_FLOW_MAX_ITER),
                                   "LBFGS_iter", str(D_FLOW_LBFGS_ITER)],
         D_FLOW_MAX_ITER, None, None),
        ("ot_ode_sr_bicubic_fp32", "ot_ode",
         ["problem", "superresolution_bicubic", "steps_ode",
          str(BICUBIC_STEPS)], sr_iters, only(groupnorm_swish=gn * sr_iters),
         None),
        ("rect_ot_ode_fp32", "ot_ode", rect + ["steps_ode",
                                               str(RECT_OT_STEPS)], rect_ot,
         only(upfirdn2d=2 * fir * rect_ot),
         {"forward": fir * rect_ot, "adjoint": fir * rect_ot, "tangent": 0}),
        # per outer step: the JVP's primal and the advance (forward), the
        # JVP's tangent, and the backward through both the primal and the
        # tangent (adjoint), but for the tangent of the input pyramid's six
        # C = 3 down sites, which does not depend on x
        ("rect_flow_priors_fp32", "flow_priors", rect + ["N", str(RECT_FP_N)],
         RECT_FP_N, only(upfirdn2d=(5 * fir - pyr) * RECT_FP_N),
         {"forward": 2 * fir * RECT_FP_N,
          "adjoint": (2 * fir - pyr) * RECT_FP_N,
          "tangent": fir * RECT_FP_N}),
    )
    out = {}
    for name, method, extra, iters, expect, roles in runs:
        torch.cuda.empty_cache()
        with phase(f"main_path/{name}"):
            r = cli_run(torch, extra, iters,
                        rect_ckpt if extra[:2] == rect[:2] else None, method)
        got = r["launches"]
        if expect is None:
            check(got["groupnorm_swish"] > 0
                  and got["groupnorm_swish"] % gn == 0
                  and got == only(groupnorm_swish=got["groupnorm_swish"]),
                  f"{name}: launches {got}")
        else:
            check(got == expect, f"{name}: launches {got}, expected {expect}")
        if roles is not None:
            check(r["fir_roles"] == roles,
                  f"{name}: upfirdn2d roles {r['fir_roles']}, expected "
                  f"{roles}")
        r["seconds_per_iteration"] = r["time_per_batch"] / iters
        r["iterations"] = iters
        emit({"main_path": name, **r})
        out[name] = r
    return out


def train_run(torch, batch):
    """``train True eval True`` through the CLI: the flagship ``ot`` U-Net
    at 128x128 trained for TRAIN_EPOCHS x TRAIN_STEPS_PER_EPOCH steps of
    ``batch`` images (exact OT on the host, fp32, ``fused_norm`` True by the
    trainer's default), then 10 PnP steps restoring with the
    ``model_final.msgpack`` it wrote ("conv" by the eval default).  Checks
    the checkpoint set, the parameter count, finite losses, that the eval
    half loaded the checkpoint, and the exact launch counts."""
    from pnpflow_tpu_torch.main import main
    from pnpflow_tpu_torch.models.unet import VelocityUNet

    steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    plot = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as out:
        opts = ["dataset", "synthetic", "dim_image", str(TRAIN_DIM),
                "model", "ot", "train", "True",
                "num_epoch", str(TRAIN_EPOCHS),
                "max_iters_per_epoch", str(TRAIN_STEPS_PER_EPOCH),
                "batch_size_train", str(batch), "eval", "True",
                "method", "pnp_flow", "problem", "gaussian_deblurring_FFT",
                "steps_pnp", "10", "num_samples", "5", "batch_size_ip", "4",
                "max_batch", "1", "save_results", "True",
                "compute_time", "True", "output_root", out]
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            args = main(["--opts"] + opts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        msgs = [str(w.message) for w in caught]
        d = os.path.join(out, "model", "synthetic", "ot")
        for f in ("loss_training.txt", "model_info.txt", "model_0.msgpack",
                  "ema_model_0.msgpack", "model_final.msgpack",
                  "ema_model_final.msgpack", "train_state.msgpack"):
            check(os.path.exists(os.path.join(d, f)), f"train: missing {f}")
        n_params = sum(p.numel() for p in VelocityUNet(
            **dict(FLAGSHIP, input_height=TRAIN_DIM)).parameters())
        with open(os.path.join(d, "model_info.txt")) as f:
            info = f.read()
        check(info == f"num_params {n_params}\n",
              f"model_info.txt: {info!r}, expected {n_params}")
        with open(os.path.join(d, "loss_training.txt")) as f:
            losses = [float(v) for v in f.read().split()]
        with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
            f.readline()
            psnr = float(f.readline().split()[0])
        with open(os.path.join(args.save_path_ip, "time_stats.txt")) as f:
            tstat = f.readline().strip()
        stats = args.train_stats
        with phase("main_path/train_fp32/fid_curve"):
            curve = fid_curve(torch, args, out, steps)
        emit({"main_path": "fid_curve", **curve})
    check(len(losses) == steps and all(map(math.isfinite, losses))
          and losses == stats["losses"],
          f"train losses {losses} / {stats['losses']}")
    check(not [m for m in msgs if "random init" in m or "Checkpoint at" in m
               or "resume state" in m],
          f"the eval half did not load the trained checkpoint: {msgs}")
    check(math.isfinite(psnr), f"PSNR not finite: {psnr}")
    expect = only(groupnorm_swish=gn_sites_at(TRAIN_DIM) * (
        steps + PLOT_FORWARDS * plot), conv3x3_gn=CONV_SITES * 10)
    check(launches == expect,
          f"train: launches {launches}, expected {expect}")
    step_s = statistics.median(stats["step_seconds"][1:])
    return {"batch": batch, "image": TRAIN_DIM, "steps": steps,
            "seconds": seconds, "seconds_per_step": step_s,
            "images_per_s": batch / step_s,
            "step_seconds": stats["step_seconds"],
            "pair_seconds_per_step": statistics.median(stats["pair_seconds"]),
            "pair_seconds": stats["pair_seconds"],
            "max_memory_allocated": stats["max_memory_allocated"],
            "losses": losses, "num_params": n_params, "sample_plot": plot,
            "launches": launches, "final_psnr_rec": psnr,
            "time_stats": tstat, "fid_curve": curve}


def train_path(torch):
    torch.cuda.empty_cache()
    with phase("main_path/train_fp32"):
        r = train_run(torch, TRAIN_BATCH)
    emit({"main_path": "train_fp32", **r})
    return r


# ------------------------------ 5b/6b. gradient-step denoiser and DiffPIR
def gs_model_parity(torch, dev):
    """The gradient-step denoiser on the flagship at 128x128 and
    GS_PARITY_BATCH images, ``fused_norm`` True (the groupnorm_swish kernel
    forward, the VJP through its plain backward, which the GS loss's
    gradient differentiates again) against False on the same weights:
    ``calculate_grad``'s Dg within 1e-4 of max|Dg|; the GS loss within rel
    1e-5 and each parameter's gradient within 1e-4 of its tensor's max, with
    the NOISE_FLOOR rule of the training parity.  Launches: one per site in
    each of the two True forwards."""
    from pnpflow_tpu_torch.training.denoiser import (
        calculate_grad, denoiser_forward)

    n, dim = GS_PARITY_BATCH, TRAIN_DIM
    g = torch.Generator(device=dev).manual_seed(13)
    y = 0.5 * torch.randn(n, dim, dim, 3, generator=g, device=dev)
    x = y + 0.1 * torch.randn(y.shape, generator=g, device=dev)
    sv = torch.full((n,), 0.1, device=dev)
    out = {}
    for fused in (False, True):
        torch.cuda.reset_peak_memory_stats()
        m = randomized_unet(torch, dev, fused, input_height=dim)
        reset_counts()
        with torch.no_grad():
            dg, _ = calculate_grad(m, x, sv)
        x_hat, _ = denoiser_forward(m, x, sv, create_graph=True)
        loss = ((x_hat - y) ** 2).reshape(n, -1).mean(dim=1).mean()
        grads = torch.autograd.grad(loss, list(m.parameters()))
        torch.cuda.synchronize()
        out[fused] = (dg, float(loss.detach()),
                      dict(zip([k for k, _ in m.named_parameters()], grads)),
                      read_counts(), torch.cuda.max_memory_allocated())
        del m, x_hat, loss, grads
        torch.cuda.empty_cache()
    (dgw, lw, gw, cw, pw), (dgg, lg, gg, cg, pg) = out[False], out[True]
    rel_dg = float((dgg - dgw).abs().max()) / float(dgw.abs().max())
    floor = NOISE_FLOOR * max(float(v.abs().max()) for v in gw.values())
    worst, noise = 0.0, []
    for k, w in gw.items():
        scale = float(w.abs().max())
        if scale < floor:
            noise.append(k)
            check(float(gg[k].abs().max()) < floor,
                  f"GS parity: {k} is noise under False, not True")
            continue
        rel = float((gg[k] - w).abs().max()) / scale
        worst = max(worst, rel)
        check(rel <= 1e-4, f"GS parity: {k} gradient rel err {rel}")
    rel_loss = abs(lg - lw) / abs(lw)
    emit({"model_parity": "gs_denoiser", "image": dim, "batch": n,
          "dg_rel_err": rel_dg, "loss": [lw, lg], "loss_rel_err": rel_loss,
          "grad_worst_rel_err": worst, "grad_tensors": len(gw),
          "noise_tensors": noise, "launches": cg,
          "max_memory_allocated": {"False": pw, "True": pg},
          "tolerances": {"dg_rel_of_max": 1e-4, "loss_rel": 1e-5,
                         "grad_rel_of_tensor_max": 1e-4,
                         "noise_floor_of_max_grad": NOISE_FLOOR}})
    check(math.isfinite(lw) and math.isfinite(lg), "GS loss not finite")
    check(rel_dg <= 1e-4, f"GS parity: Dg rel err {rel_dg}")
    check(rel_loss <= 1e-5, f"GS parity: loss rel err {rel_loss}")
    check(cw == only() and cg == only(groupnorm_swish=2 * gn_sites_at(dim)),
          f"GS parity launches {cw} / {cg}")


def randomized_diffunet_state(torch, seed=0):
    """A state_dict of the full-width DiffUNet with every parameter at a
    real scale (``init_diffunet_real_scale``)."""
    from pnpflow_tpu_torch.models.diffunet import (
        DiffUNet, init_diffunet_real_scale)

    return init_diffunet_real_scale(DiffUNet(), seed).state_dict()


def diffunet_parity(torch, dev, state):
    """The full-width DiffUNet at 256x256 on the card (cuDNN, TF32 off)
    against the same weights on the CPU, DIFFUNET_PARITY_BATCH images,
    within 1e-4 of max|out|; no kernel of the repository runs.  Then its
    time per forward (median of FORWARD_REPS) and peak memory at pnp_diff's
    batch of 4."""
    from pnpflow_tpu_torch.models.diffunet import DiffUNet

    xg = torch.Generator().manual_seed(22)
    x = torch.randn(DIFFUNET_PARITY_BATCH, DIFF_DIM, DIFF_DIM, 3,
                    generator=xg)
    t = torch.tensor([37.0, 801.0])
    with torch.inference_mode():
        cpu = DiffUNet()
        cpu.load_state_dict(state)
        want = cpu(x, t)
        card = DiffUNet()
        card.load_state_dict(state)
        card.to(dev).eval()
        reset_counts()
        got = card(x.to(dev), t.to(dev))
        torch.cuda.synchronize()
        launches = read_counts()
        x4 = torch.randn(DIFF_BATCH, DIFF_DIM, DIFF_DIM, 3, device=dev)
        t4 = torch.full((DIFF_BATCH,), 500.0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_median_ms(torch, lambda: card(x4, t4))
        peak = torch.cuda.max_memory_allocated()
    vmax = float(want.abs().max())
    rel = float((got.cpu() - want).abs().max()) / vmax
    emit({"model_parity": "diffunet_256", "batch": DIFFUNET_PARITY_BATCH,
          "max_abs_out": vmax, "rel_err": rel, "rel_tol": 1e-4,
          "launches": launches, "forward_ms_at_4": ms,
          "forward_peak_at_4": peak})
    check(torch.isfinite(got).all().item() and vmax > 1e-3,
          f"DiffUNet output not finite or vanishing (max {vmax})")
    check(rel <= 1e-4, f"DiffUNet card vs CPU: rel err {rel}")
    check(launches == only(), f"DiffUNet launches {launches}")
    del card, got
    torch.cuda.empty_cache()


def pnp_gs_path(torch):
    """pnp_gs through the CLI: ``model gradient_step`` (the flagship U-Net,
    ``fused_norm`` True by the method's default), 64x64, 4 images, fp32,
    seeded random weights: pgd and hqs FFT deblurring and hqs random
    inpainting at GS_ITERS iterations, hqs bicubic SR at
    GS_SR_ITERS; and pgd at 10 iterations, whose peak memory must equal
    the GS_ITERS-iteration run's (no graph lives across iterations).  Each
    iteration is one forward and its VJP: exactly 136 groupnorm_swish
    launches.  These runs leave LPIPS out: its cuDNN workspace inside the
    measured region moves the peak by megabytes with the allocator's
    state, and the check holds the solver's own memory."""
    gs = ["model", "gradient_step"]
    it = ["max_iter", str(GS_ITERS)]
    runs = (
        ("pnp_gs_pgd_fp32", gs + ["algo", "pgd"] + it, GS_ITERS),
        ("pnp_gs_pgd_fp32_10it", gs + ["algo", "pgd", "max_iter", "10"], 10),
        ("pnp_gs_hqs_fp32", gs + ["algo", "hqs"] + it, GS_ITERS),
        ("pnp_gs_hqs_inpainting_fp32",
         gs + ["algo", "hqs", "problem", "random_inpainting"] + it,
         GS_ITERS),
        ("pnp_gs_hqs_sr_bicubic_fp32",
         gs + ["algo", "hqs", "problem", "superresolution_bicubic",
               "max_iter", str(GS_SR_ITERS)], GS_SR_ITERS),
    )
    out = {}
    for name, extra, iters in runs:
        torch.cuda.empty_cache()
        with phase(f"main_path/{name}"):
            r = cli_run(torch, extra, iters, method="pnp_gs", lpips=False)
        expect = only(groupnorm_swish=GN_SITES_64 * iters)
        check(r["launches"] == expect,
              f"{name}: launches {r['launches']}, expected {expect}")
        r["seconds_per_iteration"] = r["time_per_batch"] / iters
        r["iterations"] = iters
        emit({"main_path": name, **r})
        out[name] = r
    p10 = out["pnp_gs_pgd_fp32_10it"]["max_memory_allocated"]
    pn = out["pnp_gs_pgd_fp32"]["max_memory_allocated"]
    emit({"pnp_gs_peak_after": {"10": p10, str(GS_ITERS): pn}})
    check(pn == p10, f"pnp_gs peak grows with iterations: {p10} at 10, "
          f"{pn} at {GS_ITERS}")
    return out


def train_gs_run(torch, batch):
    """``train True eval True`` with ``model gradient_step`` through the
    CLI: the flagship U-Net at 128x128 trained for GS_TRAIN_EPOCHS epochs
    over the synthetic split (SYNTHETIC_TRAIN images, batch ``batch``; fp32,
    ``fused_norm`` True), then GS_EVAL_ITERS pgd iterations of pnp_gs (FFT
    deblurring, GS_EVAL_BATCH images) restoring with the ``model_final.msgpack`` it
    wrote.  Checks the file set, the parameter count, finite losses, that
    the eval half loaded the checkpoint, and the exact launch counts (one
    forward a step and an iteration)."""
    from pnpflow_tpu_torch.main import main
    from pnpflow_tpu_torch.models.unet import VelocityUNet

    steps = GS_TRAIN_EPOCHS * (SYNTHETIC_TRAIN // batch)
    with tempfile.TemporaryDirectory() as out:
        opts = ["dataset", "synthetic", "dim_image", str(TRAIN_DIM),
                "model", "gradient_step", "train", "True",
                "num_epoch", str(GS_TRAIN_EPOCHS),
                "batch_size_train", str(batch), "eval", "True",
                "method", "pnp_gs", "algo", "pgd",
                "problem", "gaussian_deblurring_FFT",
                "max_iter", str(GS_EVAL_ITERS),
                "batch_size_ip", str(GS_EVAL_BATCH),
                "max_batch", "1", "save_results", "True",
                "compute_time", "True", "compute_memory", "True",
                "output_root", out]
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            args = main(["--opts"] + opts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        msgs = [str(w.message) for w in caught]
        d = os.path.join(out, "model", "synthetic", "gradient_step")
        res = os.path.join(out, "results", "synthetic", "gradient_step")
        for f in [f"gradient_step_denoiser_{e}.msgpack"
                  for e in range(GS_TRAIN_EPOCHS)] + [
                "gradient_step_denoiser_final.msgpack", "model_final.msgpack"]:
            check(os.path.exists(os.path.join(d, f)), f"train_gs: missing {f}")
        n_params = sum(p.numel() for p in VelocityUNet(
            **dict(FLAGSHIP, input_height=TRAIN_DIM)).parameters())
        with open(os.path.join(res, "model_info.txt")) as f:
            info = f.read().splitlines()
        check(info[:2] == ["PARAMETERS", f"Number of parameters: {n_params}"],
              f"train_gs model_info.txt: {info}")
        with open(os.path.join(res, "loss_training.txt")) as f:
            losses = [float(ln.rsplit(" ", 1)[1]) for ln in f]
        with open(os.path.join(res, "losses_gradient_step.txt")) as f:
            epochs = f.read().splitlines()
        with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
            f.readline()
            psnr = float(f.readline().split()[0])
        with open(os.path.join(args.save_path_ip, "time_stats.txt")) as f:
            tstat = f.readline().strip()
        with open(os.path.join(args.save_path_ip, "memory_stats.txt")) as f:
            mstat = f.readline().strip()
    stats = args.train_stats
    check(len(losses) == steps and all(map(math.isfinite, losses))
          and losses == stats["losses"] and len(epochs) == GS_TRAIN_EPOCHS,
          f"train_gs losses {losses} / {stats['losses']}, epochs {epochs}")
    check(not [m for m in msgs if "random init" in m or "Checkpoint at" in m],
          f"the eval half did not load the trained checkpoint: {msgs}")
    check(math.isfinite(psnr), f"PSNR not finite: {psnr}")
    expect = only(groupnorm_swish=gn_sites_at(TRAIN_DIM) * (
        steps + GS_EVAL_ITERS))
    check(launches == expect,
          f"train_gs: launches {launches}, expected {expect}")
    step_s = statistics.median(stats["step_seconds"][1:])
    return {"batch": batch, "image": TRAIN_DIM, "steps": steps,
            "seconds": seconds, "seconds_per_step": step_s,
            "images_per_s": batch / step_s,
            "step_seconds": stats["step_seconds"],
            "max_memory_allocated": stats["max_memory_allocated"],
            "losses": losses, "sigmas": stats["sigmas"],
            "num_params": n_params, "launches": launches,
            "final_psnr_rec": psnr, "eval_time_stats": tstat,
            "eval_memory_stats": mstat}


def train_gs_path(torch):
    torch.cuda.empty_cache()
    with phase("main_path/train_gs_fp32"):
        r = train_gs_run(torch, GS_TRAIN_BATCH)
    emit({"main_path": "train_gs_fp32", "batch_cut_from": TRAIN_BATCH, **r})
    return r


def save_diffunet_checkpoint(state, directory):
    """``state`` as the JAX package's msgpack envelope, the file a
    ``model diffusion`` run loads."""
    import types

    from pnpflow_tpu_torch.models.diffunet import DiffUNet
    from pnpflow_tpu_torch.models.registry import (
        model_fingerprint, save_params_file)
    from pnpflow_tpu_torch.utils.jax_params import (
        flax_from_diffunet_state_dict)

    path = os.path.join(directory, "diffusion.msgpack")
    args = types.SimpleNamespace(model="diffusion", dim_image=DIFF_DIM,
                                 num_channels=3)
    save_params_file(flax_from_diffunet_state_dict(state), path,
                     fingerprint=model_fingerprint(DiffUNet(), args))
    return path


def pnp_diff_path(torch, ckpt):
    """pnp_diff through the CLI: ``model diffusion dim_image 256`` (the
    full-width DiffUNet, float32, real-scale random weights from the
    msgpack ``ckpt``), 4 images: FFT deblurring at PNP_DIFF_STEPS,
    and box inpainting under laplace noise (the 100-iteration L1 dual prox
    a step) at PNP_DIFF_LAPLACE_STEPS.  No kernel of the repository runs."""
    diff = ["model", "diffusion", "dim_image", str(DIFF_DIM)]
    runs = (
        ("pnp_diff_fp32", diff + ["max_iter", str(PNP_DIFF_STEPS)],
         PNP_DIFF_STEPS),
        ("pnp_diff_inpainting_laplace_fp32",
         diff + ["problem", "inpainting", "noise_type", "laplace",
                 "max_iter", str(PNP_DIFF_LAPLACE_STEPS)],
         PNP_DIFF_LAPLACE_STEPS),
    )
    out = {}
    for name, extra, steps in runs:
        torch.cuda.empty_cache()
        with phase(f"main_path/{name}"):
            r = cli_run(torch, extra, steps, ckpt, method="pnp_diff")
        check(r["launches"] == only(),
              f"{name}: launches {r['launches']}, expected none")
        r["seconds_per_iteration"] = r["time_per_batch"] / steps
        r["iterations"] = steps
        emit({"main_path": name, **r})
        out[name] = r
    return out


# ----------------------------------------------- 5c/6c. the metric stack
def write_metric_weights(directory):
    """The synthetic Inception weights (seed 0, with the fc head) and the
    seeded LPIPS weights, written by the port's converters."""
    import numpy as np

    from pnpflow_tpu_torch.utils import inception_convert, lpips_convert

    os.makedirs(directory)
    inc = os.path.join(directory, "inception_fid.npz")
    inception_convert.main("--synthetic", inc)
    lp = os.path.join(directory, "lpips_alex.npz")
    np.savez(lp, **lpips_convert.synthetic_weights(0))
    METRIC_WEIGHTS.update({"inception_fid.npz": inc, "lpips_alex.npz": lp})


def metrics_parity(torch, dev):
    """The full-width FID InceptionV3 (synthetic weights) at 2 images of
    64x64 and 256x256, pool3 and probabilities, and LPIPS (seeded AlexNet)
    at 4 images of each size: the card against the CPU on the same inputs,
    within INCEPTION_TOL of max|pool3| (the probabilities 1e-5) and
    LPIPS_TOL relative; every output finite, with the feature scale (random
    0.05-std convs and identity BatchNorm across 94 layers) printed."""
    from pnpflow_tpu_torch.metrics.lpips import get_lpips_fn
    from pnpflow_tpu_torch.models.inception import get_inception_fns
    from pnpflow_tpu_torch.utils.config import CfgNode

    with tempfile.TemporaryDirectory() as root:
        link_metric_weights(root, inception=True)
        args = CfgNode(dict(output_root=root))
        inc = {d: get_inception_fns(args, device=d)[1] for d in ("cpu", dev)}
        lp = {d: get_lpips_fn(args, d) for d in ("cpu", dev)}
        g = torch.Generator().manual_seed(17)
        res = {}
        for dim in METRIC_DIMS:
            x = torch.rand(2, dim, dim, 3, generator=g)
            want = inc["cpu"](x)
            t0 = time.perf_counter()
            got = [t.cpu() for t in inc[dev](x.to(dev))]
            seconds = time.perf_counter() - t0
            scale = float(want[0].abs().max())
            p3 = float((got[0] - want[0]).abs().max()) / scale
            pr = float((got[1] - want[1]).abs().max())
            y = torch.rand(4, dim, dim, 3, generator=g) * 2 - 1
            z = (y + 0.2 * torch.randn(y.shape, generator=g)).clamp(-1, 1)
            with torch.inference_mode():
                lw = float(lp["cpu"](y, z))
                lg = float(lp[dev](y.to(dev), z.to(dev)))
            finite = all(bool(torch.isfinite(t).all()) for t in got) and \
                math.isfinite(lg)
            res[dim] = {"pool3_max": scale,
                        "pool3_mean_abs": float(want[0].abs().mean()),
                        "pool3_err_of_max": p3, "probs_max_err": pr,
                        "probs_max": float(want[1].max()),
                        "lpips_cpu": lw, "lpips_card": lg,
                        "lpips_rel_err": abs(lg - lw) / abs(lw),
                        "inception_first_call_s": seconds}
            check(finite, f"metric networks at {dim}: non-finite output")
            check(p3 <= INCEPTION_TOL and pr <= 1e-5,
                  f"Inception at {dim}: pool3 {p3:.3e} of max, probs {pr:.3e}")
            check(abs(lg - lw) <= LPIPS_TOL * abs(lw),
                  f"LPIPS at {dim}: card {lg} vs CPU {lw}")
        res["inception_chunk"] = inception_chunk_ms(torch, dev, g)
    emit({"model_parity": "metrics", **{str(k): v for k, v in res.items()}})


def inception_chunk_ms(torch, dev, g):
    """One sampling chunk (METRIC_BATCH images, 64x64 resized to 299x299)
    through the Inception: the CUDA-event median of FORWARD_REPS calls with
    TF32 off (the port's float32) and on, beside the operation bound of its
    convs and fc at the fp32 and TF32 peaks (counted from the output shapes
    of one call)."""
    from pnpflow_tpu_torch.device import set_fp32_parity_mode
    from pnpflow_tpu_torch.models.inception import (
        InceptionFID, load_inception_params)

    x = torch.rand(METRIC_BATCH, 64, 64, 3, generator=g).to(dev)
    net = InceptionFID(load_inception_params(
        METRIC_WEIGHTS["inception_fid.npz"])).to(dev).eval()
    flops = []

    def count(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            flops.append(2 * out.numel() * mod.in_channels
                         * mod.kernel_size[0] * mod.kernel_size[1])
        elif isinstance(mod, torch.nn.Linear):
            flops.append(2 * out.numel() * mod.in_features)

    hooks = [m.register_forward_hook(count) for m in net.modules()]
    with torch.inference_mode():
        net.outputs(x)
        for h in hooks:
            h.remove()
        ms = {}
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            ms["tf32" if tf32 else "fp32"] = cuda_median_ms(
                torch, lambda: net.outputs(x))
    set_fp32_parity_mode()
    total = sum(flops)
    return {"images": METRIC_BATCH, "ms": ms, "flop": total,
            "bound_ms": {"fp32": total / PEAK["float32"] * 1e3,
                         "tf32": total / PEAK["tf32"] * 1e3}}


def compute_metrics_path(torch):
    """``compute_metrics True`` through the CLI with the flagship U-Net at
    64x64 ("conv" by the restoration default): METRIC_N samples by Euler in
    METRIC_STEPS steps against METRIC_N test images on the synthetic
    Inception features, then 10 PnP steps; the metrics.txt line must name
    the weights' provenance and hold finite FID, KID, IS, Vendi and SW with
    wall_s and peak memory, each within METRIC_REL_TOL of its value
    recomputed on the CPU.  Then one dopri5 chunk (metric_n 50, the
    default sampler) and a 1-step restoration: its nfe is the conv3x3_gn
    launches over the sites less that one step."""
    out = {}
    chunks = -(-METRIC_N // METRIC_BATCH)
    for name, extra, steps in (
            ("compute_metrics", ["compute_metrics", "True", "metric_n",
                                 str(METRIC_N), "metric_steps",
                                 str(METRIC_STEPS), "metric_sampler",
                                 "euler"], 10),
            ("compute_metrics_dopri5", ["compute_metrics", "True",
                                        "metric_n", str(METRIC_BATCH)], 1)):
        torch.cuda.empty_cache()
        with phase(f"main_path/{name}"):
            r = cli_run(torch, extra, steps, metrics=True)
        line = r["metrics_line"]
        check(line["features"] == "inception_2048[synthetic_random_init_seed0]"
              and all(math.isfinite(float(line[k])) for k in
                      ("FID", "KID", "KID_std", "Vendi", "SW", "IS",
                       "IS_std", "wall_s", "peak_mem_MiB"))
              and line["peak_mem_src"] == "torch.cuda.max_memory_allocated",
              f"{name}: metrics.txt {line}")
        forwards, rem = divmod(r["launches"]["conv3x3_gn"], CONV_SITES)
        check(rem == 0 and r["launches"] == only(
            conv3x3_gn=r["launches"]["conv3x3_gn"]),
            f"{name}: launches {r['launches']}")
        r["metric_forwards"] = forwards - steps
        if name == "compute_metrics":
            check(r["metric_forwards"] == chunks * METRIC_STEPS,
                  f"{name}: {r['metric_forwards']} sampling forwards")
        else:
            r["dopri5_nfe"] = r["metric_forwards"]
        emit({"main_path": name, **r})
        out[name] = r
    return out


def fid_curve(torch, args, out, steps):
    """The FM trainer's FID curve on the checkpoint a ``train True`` run
    wrote to ``out``: ``_fid_checkpoint`` at n = METRIC_N (cut from 5000)
    on the EMA weights of the resume state, then once more after one more
    step.  Each call appends one finite ``epoch fid`` row to FID_5k.txt,
    the second with another value from freshly sampled chunks (the JAX
    cache would repeat the first), and launches groupnorm_swish at each
    128x128 site in each of its 200 Euler forwards."""
    from pnpflow_tpu_torch.data import DataLoaders
    from pnpflow_tpu_torch.training.flow_matching import FlowMatchingTrainer

    link_metric_weights(out, inception=True)
    args.compute_metrics = True
    tr = FlowMatchingTrainer(args)
    state, done, resumed = tr.restore_state(tr.init_state(0))
    check(resumed and state.step == steps,
          f"fid_curve: resume state at step {state.step}, epoch {done}")
    loaders = DataLoaders("synthetic", 500, 500, dim_image=TRAIN_DIM,
                          num_channels=3, test_n=METRIC_N).load_data()
    expect = only(groupnorm_swish=gn_sites_at(TRAIN_DIM) * METRIC_STEPS
                  * -(-METRIC_N // METRIC_BATCH))
    calls = []
    for epoch in (done, done + 1):
        if epoch > done:
            g = torch.Generator(device="cuda").manual_seed(7)
            x0, x1 = (torch.randn(8, TRAIN_DIM, TRAIN_DIM, 3, generator=g,
                                  device="cuda") for _ in range(2))
            tr.train_step(state, x0, x1, g)
        reset_counts()
        t0 = time.perf_counter()
        res = tr._fid_checkpoint(state, epoch, loaders, n=METRIC_N)
        torch.cuda.synchronize()
        calls.append({"epoch": epoch, "seconds": time.perf_counter() - t0,
                      "launches": read_counts(), **res})
        check(calls[-1]["launches"] == expect,
              f"fid_curve: launches {calls[-1]['launches']}, "
              f"expected {expect}")
    with open(os.path.join(tr.model_dir, "FID_5k.txt")) as f:
        rows = [line.split() for line in f]
    check([int(r[0]) for r in rows] == [done, done + 1]
          and all(math.isfinite(float(r[1])) for r in rows)
          and float(rows[0][1]) != float(rows[1][1])
          and calls[1]["resumed_chunks"] == 0,
          f"fid_curve: FID_5k.txt {rows}, calls {calls}")
    return {"rows": rows, "calls": calls, "launches": {
        k: sum(c["launches"][k] for c in calls) for k in KERNELS}}


def remat_run(torch, name, opts, kernel, rect_ckpt):
    """One differentiated method, fp32, FFT deblurring, DIFF_BATCH images,
    solved with ``remat`` False and True on the same inputs: the results
    within 1e-5 of max, and each run's peak memory (from a reset after the
    model is built, so both hold the weights), seconds and launches; under
    remat the forwards that a gradient reaches run again (flow_priors: the
    whole JVP), so ``kernel`` launches more.  Both solves take cuDNN's
    deterministic algorithms: its default ones may add with atomics, in an
    order that changes from run to run, and the NCSN++ flow_priors solve
    on random weights (PSNR about 4.5 dB) grows that rounding to 3e-3 of
    max, which says nothing of remat."""
    from pnpflow_tpu_torch.data import DataLoaders
    from pnpflow_tpu_torch.models.registry import build_model_bundle
    from pnpflow_tpu_torch.ops.degradations import make_degradation
    from pnpflow_tpu_torch.solvers.base import measure
    from pnpflow_tpu_torch.solvers.factory import build_solver
    from pnpflow_tpu_torch.utils.config import load_full_config

    dev = torch.device("cuda")
    dim = int(opts[opts.index("dim_image") + 1])
    clean_np = next(iter(DataLoaders(
        "synthetic", DIFF_BATCH, DIFF_BATCH, dim_image=dim,
        num_channels=3).load_data()["test"]))[0]
    res = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as root:
        if "rectified" in opts:
            ck = os.path.join(root, "model", "synthetic", "rectified")
            os.makedirs(ck)
            os.symlink(rect_ckpt, os.path.join(ck, "model_final.pt"))
        for remat in (False, True):
            args = load_full_config(
                ["dataset", "synthetic", "problem", "gaussian_deblurring_FFT",
                 "batch_size_ip", str(DIFF_BATCH), "remat", str(remat),
                 "output_root", root] + opts, root=HERE)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # the random-init warning
                bundle = build_model_bundle(args, device=dev)
            check(bundle.remat == remat, "remat not read")
            deg, sigma = make_degradation(args, device=dev)
            clean = torch.as_tensor(clean_np, device=dev)
            noisy = measure(deg.H, clean, sigma, "gaussian", 0)
            solver = build_solver(bundle, args)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with solver.grad_mode():
                x, _ = solver.solve_batch(clean, noisy, deg, sigma, 0)
            torch.cuda.synchronize()
            res[remat] = {"x": x, "seconds": time.perf_counter() - t0,
                          "max_memory_allocated":
                              torch.cuda.max_memory_allocated(),
                          "launches": read_counts(), "fir_roles": fir_roles()}
            del bundle, solver, deg
    torch.backends.cudnn.deterministic = deterministic
    a, b = res[False].pop("x"), res[True].pop("x")
    err = float((b - a).abs().max()) / float(a.abs().max())
    check(err <= 1e-5, f"remat {name}: {err:.3e} of max")
    fewer = res[False]["launches"][kernel]
    check(res[True]["launches"][kernel] > fewer > 0,
          f"remat {name}: launches {res}")
    return {"options": opts, "err_of_max": err, "remat_false": res[False],
            "remat_true": res[True],
            "peak_saved_bytes": res[False]["max_memory_allocated"]
            - res[True]["max_memory_allocated"],
            "time_ratio": res[True]["seconds"] / res[False]["seconds"],
            "launches": res[True]["launches"],
            "fir_roles": res[True]["fir_roles"]}


def remat_path(torch, rect_ckpt):
    """``remat`` False against True on every method that differentiates the
    model: the flagship U-Net at 64x64 (``fused_norm`` True, the methods'
    default) with ot_ode at REMAT_OT_STEPS steps, d_flow at one step of
    REMAT_LBFGS_ITER LBFGS iterations and pnp_gs (``model
    gradient_step``) at REMAT_GS_ITERS iterations, and the NCSN++ 256^2
    with flow_priors at N = RECT_FP_N.  The peaks do not depend on the
    iterations (a step holds one graph), so the runs are short."""
    unet = ["dim_image", "64"]
    runs = (
        ("ot_ode", unet + ["model", "ot", "method", "ot_ode", "steps_ode",
                           str(REMAT_OT_STEPS)], "groupnorm_swish"),
        ("d_flow", unet + ["model", "ot", "method", "d_flow", "max_iter",
                           "1", "LBFGS_iter", str(REMAT_LBFGS_ITER)],
         "groupnorm_swish"),
        ("pnp_gs", unet + ["model", "gradient_step", "method", "pnp_gs",
                           "max_iter", str(REMAT_GS_ITERS)],
         "groupnorm_swish"),
        ("rect_flow_priors", ["model", "rectified", "dim_image",
                              str(RECT_DIM), "method", "flow_priors", "N",
                              str(RECT_FP_N)], "upfirdn2d"),
    )
    out = {}
    for name, opts, kernel in runs:
        torch.cuda.empty_cache()
        with phase(f"main_path/remat_{name}_fp32"):
            r = remat_run(torch, name, opts, kernel, rect_ckpt)
        emit({"main_path": f"remat_{name}_fp32", **r})
        out[f"remat_{name}_fp32"] = r
    return out


def serve_path(torch):
    """``Restorer(method="pnp_flow", problem="gaussian_deblurring_FFT")``
    with the flagship U-Net at 64x64 ("conv", seeded random weights) and 4
    images: ``warmup``, then two ``restore`` calls with the same seed, which
    must be equal bit for bit, finite, and leave the output root empty."""
    import numpy as np

    from pnpflow_tpu_torch.data import DataLoaders
    from pnpflow_tpu_torch.serve import Restorer

    with tempfile.TemporaryDirectory() as root:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the random-init warning
            r = Restorer(method="pnp_flow",
                         problem="gaussian_deblurring_FFT", dim_image=64,
                         batch_size=4, output_root=root,
                         overrides={"steps_pnp": SERVE_STEPS})
        clean = next(iter(DataLoaders("synthetic", 4, 4, dim_image=64,
                                      num_channels=3).load_data()["test"]))[0]
        y = r.degrade(clean, seed=0)
        reset_counts()
        t0 = time.perf_counter()
        r.warmup()
        times, outs = [time.perf_counter() - t0], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(r.restore(y, seed=1))     # numpy: synchronised
            times.append(time.perf_counter() - t0)
        launches = read_counts()
        left = os.listdir(root)
    a, b = outs
    check(np.array_equal(a, b) and np.isfinite(a).all(),
          "serve: two restores with one seed differ")
    check(not left, f"serve wrote {left}")
    expect = only(conv3x3_gn=CONV_SITES * SERVE_STEPS * 3)
    check(launches == expect, f"serve: launches {launches}, expected {expect}")
    return {"steps": SERVE_STEPS, "images": 4, "warmup_seconds": times[0],
            "seconds_per_restore": times[1:], "launches": launches}


# ------------------------------------------------- 6c. the rectified-flow zoo
def _real_scale(torch, m, seed):
    """Every trainable parameter of ``m`` at a real scale (as
    :func:`randomized_ncsnpp_state`): GroupNorm scales near 1, other vectors
    small, weights ~ 1/sqrt(fan_in); frozen ones and buffers kept."""
    import torch.nn as nn

    norms = {id(mod.weight) for mod in m.modules()
             if isinstance(mod, nn.GroupNorm)}
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if not p.requires_grad:
                continue
            if id(p) in norms:
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                fan_in = p.shape[0] if name.endswith(".W") else p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
    return m


def _grad_parity(torch, gw, gg, what):
    """Each gradient within 1e-4 of its tensor's max, under the NOISE_FLOOR
    rule of the training parity; returns the worst relative error."""
    floor = NOISE_FLOOR * max(float(v.abs().max()) for v in gw.values())
    worst = 0.0
    for k, w in gw.items():
        scale = float(w.abs().max())
        if scale < floor:
            check(float(gg[k].abs().max()) < floor, f"{what}: {k} noise")
            continue
        err = float((gg[k] - w).abs().max()) / scale
        check(math.isfinite(err) and err <= 1e-4,
              f"{what}: {k} gradient rel err {err}")
        worst = max(worst, err)
    return worst


def _rf_loss_and_grads(torch, rf, z0, x1, t):
    from pnpflow_tpu_torch.training.flow_matching import make_fm_loss

    loss = make_fm_loss(rf)(z0, x1, t)
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu()
                         for n, p in rf.named_parameters()
                         if p.grad is not None}


def rf_step_parity(torch, dev, rect_state):
    """One rf_main train step's loss and gradients (the flow-matching loss
    through ``RFModel``, t * 999) of the CelebA-HQ NCSN++ 256^2 at batch 1
    on the card (upfirdn2d forward and adjoint) against the CPU (plain FIR),
    with the same real-scale weights, z0 and t: loss within 1e-5 relative,
    every gradient within 1e-4 of its max."""
    from pnpflow_tpu_torch.config.rf_configs import get_config
    from pnpflow_tpu_torch.rf_main import _model

    cfg = get_config(RF_CONFIG)
    g = torch.Generator().manual_seed(41)
    z0 = torch.randn(1, RECT_DIM, RECT_DIM, 3, generator=g)
    x1 = torch.tanh(torch.randn(z0.shape, generator=g))
    t = torch.tensor([0.37])
    out = {}
    for d in ("cpu", dev):
        rf = _model(cfg, torch.device(d))
        # the config's sigmas table (num_scales 2000) is the module's own;
        # the Fourier embedding never reads it
        rf.model.load_state_dict(dict(rect_state, sigmas=rf.model.sigmas))
        reset_counts()
        out[str(d)] = _rf_loss_and_grads(torch, rf, z0.to(d), x1.to(d),
                                         t.to(d))
        if d == dev:
            torch.cuda.synchronize()
            launches, roles = read_counts(), fir_roles()
        del rf
    (lw, gw), (lg, gg) = out["cpu"], out[str(dev)]
    rel = abs(lg - lw) / abs(lw)
    check(math.isfinite(lg) and rel <= 1e-5,
          f"rf step parity: loss {lg} vs {lw}, rel {rel}")
    worst = _grad_parity(torch, gw, gg, "rf step parity")
    check(launches == only(upfirdn2d=RECT_FIR_SITES + RECT_FIR_TRAIN_ADJOINT)
          and roles == {"forward": RECT_FIR_SITES,
                        "adjoint": RECT_FIR_TRAIN_ADJOINT, "tangent": 0},
          f"rf step parity launches {launches}, roles {roles}")
    emit({"rf_zoo": "step_parity", "config": RF_CONFIG, "batch": 1,
          "loss": lg, "loss_rel_err": rel, "grad_worst_rel_err": worst,
          "tolerances": {"loss_rel": 1e-5, "grad_rel_of_tensor_max": 1e-4,
                         "noise_floor_of_max_grad": NOISE_FLOOR},
          "launches": launches, "fir_roles": roles})
    torch.cuda.empty_cache()


def rf_run(torch, name, argv, expect_fir):
    """One ``python -m pnpflow_tpu_torch.rf_main`` call in-process, every
    count set to 0 just before and read just after: host seconds to its end
    (it ends reading the device), peak memory, launches, FIR roles and
    paths, and the mode's own statistics.  ``expect_fir(stats)`` gives the
    NCSN++ forwards, backwards to the weights and tangents the run must have
    launched the FIR kernel for (RECT_FIR_SITES, RECT_FIR_TRAIN_ADJOINT and
    RECT_FIR_SITES launches each), none on the general path."""
    from pnpflow_tpu_torch.rf_main import main

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    stats = main(argv)
    torch.cuda.synchronize()
    r = {"seconds": time.perf_counter() - t0,
         "max_memory_allocated": torch.cuda.max_memory_allocated(),
         "launches": read_counts(), "fir_roles": fir_roles(),
         "fir_paths": fir_paths(), **stats}
    fwd, bwd, tan = expect_fir(stats)
    want = {"forward": RECT_FIR_SITES * fwd,
            "adjoint": RECT_FIR_TRAIN_ADJOINT * bwd,
            "tangent": RECT_FIR_SITES * tan}
    check(r["launches"] == only(upfirdn2d=sum(want.values()))
          and r["fir_roles"] == want and r["fir_paths"]["general"] == 0,
          f"rf_zoo/{name}: launches {r['launches']}, roles "
          f"{r['fir_roles']}, paths {r['fir_paths']}, expected {want}")
    emit({"rf_zoo": name, "argv": argv, **r})
    return r


def rf_likelihood(torch, dev, wd):
    """bits/dim of RF_BPD_BATCH synthetic images under the trained state:
    RF_BPD_STEPS midpoint steps, one Rademacher probe, each a
    ``torch.func.jvp`` (the FIR kernel on the tangent)."""
    from pnpflow_tpu_torch.config.rf_configs import get_config
    from pnpflow_tpu_torch.data.datasets import synthetic_images
    from pnpflow_tpu_torch.ops.likelihood import bits_per_dim
    from pnpflow_tpu_torch.rf_main import _load_or_init, _model

    rf = _model(get_config(RF_CONFIG), dev)
    _load_or_init(rf, wd)
    x = torch.from_numpy(synthetic_images(RF_BPD_BATCH, RECT_DIM, 3,
                                          seed=5)).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    bpd = bits_per_dim(rf, x, torch.Generator(device=dev).manual_seed(0),
                       steps=RF_BPD_STEPS, n_probes=1).cpu()
    seconds = time.perf_counter() - t0
    r = {"seconds": seconds, "batch": RF_BPD_BATCH, "steps": RF_BPD_STEPS,
         "probes": 1, "bits_per_dim": bpd.tolist(),
         "max_memory_allocated": torch.cuda.max_memory_allocated(),
         "launches": read_counts(), "fir_roles": fir_roles()}
    check(bool(torch.isfinite(bpd).all()), f"bits/dim not finite: {bpd}")
    # a step: the velocity at its start, then one JVP at its midpoint
    want = {"forward": 2 * RECT_FIR_SITES * RF_BPD_STEPS, "adjoint": 0,
            "tangent": RECT_FIR_SITES * RF_BPD_STEPS}
    check(r["fir_roles"] == want, f"likelihood roles {r['fir_roles']}")
    emit({"rf_zoo": "likelihood", **r})
    del rf
    return r


def rf_small_parity(torch, dev):
    """The smaller configurations, card against CPU within RF_REL_TOL of
    max: the cifar10_rf_gaussian_ddpmpp loss and gradients at
    CIFAR_PARITY_BATCH images (no FIR: fir False), the DDPM of score_sde's
    ``configs/vp/ddpm/cifar10.py`` (nf 128, mult 1,2,2,2, 2 blocks,
    attention at 16, 32x32) and the NCSNv2 of ncsnv2's
    ``configs/celeba.yml`` (ngf 128, 64x64, 500 noise scales): one forward
    each; every parameter at a real scale."""
    from pnpflow_tpu_torch.config.rf_configs import get_config
    from pnpflow_tpu_torch.models.zoo import create_model, init_model
    from pnpflow_tpu_torch.rf_main import RFModel

    res = {}
    cfg = get_config("cifar10_rf_gaussian_ddpmpp")
    state = _real_scale(torch, create_model(cfg), 51).state_dict()
    g = torch.Generator().manual_seed(52)
    z0 = torch.randn(CIFAR_PARITY_BATCH, 32, 32, 3, generator=g)
    x1 = torch.tanh(torch.randn(z0.shape, generator=g))
    t = torch.rand(CIFAR_PARITY_BATCH, generator=g)
    out = {}
    for d in ("cpu", dev):
        m = create_model(cfg)
        m.load_state_dict(state)
        reset_counts()
        out[str(d)] = _rf_loss_and_grads(torch, RFModel(m).to(d).eval(),
                                         z0.to(d), x1.to(d), t.to(d))
        del m
    launches = read_counts()
    (lw, gw), (lg, gg) = out["cpu"], out[str(dev)]
    rel = abs(lg - lw) / abs(lw)
    check(rel <= RF_REL_TOL, f"cifar10 ddpmpp loss rel err {rel}")
    res["cifar10_ddpmpp_step"] = {
        "batch": CIFAR_PARITY_BATCH, "loss_rel_err": rel,
        "grad_worst_rel_err": _grad_parity(torch, gw, gg, "cifar10 ddpmpp"),
        "launches": launches}
    check(launches == only(), f"cifar10 ddpmpp launches {launches}")
    del out, gw, gg

    ddpm = get_config("cifar10_rf_gaussian_ddpmpp")
    ddpm.model.update(dict(name="ddpm", ch_mult=(1, 2, 2, 2),
                           num_res_blocks=2, dropout=0.1,
                           scale_by_sigma=False, ema_rate=0.9999))
    ncsnv2 = get_config("cifar10_rf_gaussian_ddpmpp")
    ncsnv2.data.update(dict(image_size=64, centered=False))
    ncsnv2.model.update(dict(name="ncsnv2_64", nf=128,
                             normalization="InstanceNorm++",
                             nonlinearity="elu", sigma_max=90.0,
                             sigma_min=0.01, num_scales=500))
    for name, cfg, n, dim, labels, real in (
            ("ddpm_cifar10", ddpm, 16, 32, 1000, True),
            ("ncsnv2_64_celeba", ncsnv2, 8, 64, 500, False)):
        m = init_model(create_model(cfg), seed=53)
        if real:
            _real_scale(torch, m, 54)
        g = torch.Generator().manual_seed(55)
        x = torch.rand(n, dim, dim, 3, generator=g) * 2 - 1
        y = torch.randint(0, labels, (n,), generator=g)
        with torch.inference_mode():
            want = m.eval()(x, y)
            t0 = time.perf_counter()
            got = m.to(dev)(x.to(dev), y.to(dev)).cpu()
            seconds = time.perf_counter() - t0
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        check(bool(torch.isfinite(got).all()) and scale > 1e-3
              and err <= RF_REL_TOL, f"{name} card vs CPU: rel err {err}")
        res[name] = {"batch": n, "image": dim, "rel_err": err,
                     "max_abs_out": scale, "first_forward_seconds": seconds,
                     "num_params": sum(p.numel() for p in m.parameters())}
        del m
    emit({"rf_zoo": "small_configs", "rel_tol": RF_REL_TOL, **res})
    torch.cuda.empty_cache()
    return res


def rf_zoo_path(torch, dev, rect_state):
    """``rf_main`` on the CelebA-HQ NCSN++ 256^2 (nf 128,
    mult 1,1,2,2,2,2,2, 2 blocks, attention at 16, FIR [1,3,3,1]): the
    batch-1 step parity, ``--mode train`` at RF_BATCH for RF_TRAIN_STEPS on
    synthetic data from the seeded init, ``sample`` (rk45, ode_tol 1e-5) from
    the state it wrote, ``reflow`` (train_reflow and train_online_reflow),
    ``generate_pairs`` and bits/dim; then the smaller configurations.
    Returns the runs, for the kernels line."""
    runs = {}
    with phase("rf_zoo/step_parity"):
        rf_step_parity(torch, dev, rect_state)
    with tempfile.TemporaryDirectory() as wd:
        base = ["--config", RF_CONFIG, "--workdir", wd]
        opts = ["--opts", "training.batch_size", str(RF_BATCH),
                "sampling.sample_N", str(RF_SAMPLE_N)]
        with phase("rf_zoo/train"):
            r = rf_run(torch, "train", base + [
                "--mode", "train", "--n_iters", str(RF_TRAIN_STEPS)] + opts,
                lambda st: (RF_TRAIN_STEPS, RF_TRAIN_STEPS, 0))
        check(len(r["losses"]) == RF_TRAIN_STEPS
              and all(map(math.isfinite, r["losses"]))
              and os.path.exists(os.path.join(wd, "state.msgpack")),
              f"rf train: {r['losses']}")
        step_s = statistics.median(r["step_seconds"][1:])
        r.update(batch=RF_BATCH, seconds_per_step=step_s,
                 images_per_s=RF_BATCH / step_s)
        emit({"rf_zoo": "train_summary", "batch": RF_BATCH,
              "seconds_per_step": step_s, "images_per_s": RF_BATCH / step_s,
              "max_memory_allocated": r["max_memory_allocated"]})
        runs["rf_train"] = r

        with phase("rf_zoo/sample"):
            r = rf_run(torch, "sample", base + [
                "--mode", "sample", "--n_samples", str(RF_SAMPLES)] + opts,
                lambda st: (st["nfe"], 0, 0))
        import numpy as np

        samples = np.load(os.path.join(wd, "samples.npz"))["samples"]
        check(samples.shape == (RF_SAMPLES, RECT_DIM, RECT_DIM, 3)
              and np.isfinite(samples).all()
              and os.path.exists(os.path.join(wd, "samples.png")),
              f"rf sample: {samples.shape}")
        runs["rf_sample"] = r

        reflow = ["training.batch_size", str(RF_REFLOW_BATCH),
                  "reflow.reflow_loss", "l2"]
        with phase("rf_zoo/reflow"):
            runs["rf_reflow"] = rf_run(torch, "reflow", base + [
                "--mode", "reflow", "--n_iters", str(RF_REFLOW_ITERS)]
                + opts + reflow + ["reflow.reflow_type", "train_reflow",
                                   "reflow.reflow_t_schedule", "uniform"],
                lambda st: (RF_REFLOW_ITERS * (RF_SAMPLE_N + 1),
                            RF_REFLOW_ITERS, 0))
        with phase("rf_zoo/online_reflow"):
            runs["rf_online_reflow"] = rf_run(torch, "online_reflow", base + [
                "--mode", "reflow", "--n_iters", str(RF_REFLOW_ITERS)]
                + opts + reflow + ["reflow.reflow_type",
                                   "train_online_reflow",
                                   "reflow.reflow_t_schedule", "t0"],
                lambda st: (RF_REFLOW_ITERS * (RF_ONLINE_GEN + 1),
                            RF_REFLOW_ITERS, 0))
        for k in ("rf_reflow", "rf_online_reflow"):
            check(all(map(math.isfinite, runs[k]["losses"])),
                  f"{k}: losses {runs[k]['losses']}")
        with phase("rf_zoo/pairs"):
            runs["rf_pairs"] = rf_run(torch, "pairs", base + [
                "--mode", "generate_pairs"] + opts + [
                "reflow.total_number_of_samples", str(RF_PAIRS)],
                lambda st: (RF_SAMPLE_N, 0, 0))
        pairs = np.load(os.path.join(wd, "reflow_pairs.npz"))
        check(pairs["z0"].shape == pairs["x1"].shape == (
            RF_PAIRS, RECT_DIM, RECT_DIM, 3) and np.isfinite(
                pairs["x1"]).all(), "rf pairs: shapes or values")
        with phase("rf_zoo/likelihood"):
            runs["rf_likelihood"] = rf_likelihood(torch, dev, wd)

    with tempfile.TemporaryDirectory() as wd:
        with phase("rf_zoo/cifar10_train"):
            r = rf_run(torch, "cifar10_train", [
                "--config", "cifar10_rf_gaussian_ddpmpp", "--workdir", wd,
                "--mode", "train", "--n_iters", "3"], lambda st: (0, 0, 0))
        step_s = statistics.median(r["step_seconds"][1:])
        r.update(batch=CIFAR_BATCH, seconds_per_step=step_s,
                 images_per_s=CIFAR_BATCH / step_s)
        check(all(map(math.isfinite, r["losses"])), "cifar10 train losses")
        runs["rf_cifar10_train"] = r
    with phase("rf_zoo/small_configs"):
        rf_small_parity(torch, dev)
    emit({"rf_zoo": "cuts", "config": RF_CONFIG,
          "reduced": {"training.batch_size": [64, RF_BATCH],
                      "train steps": RF_TRAIN_STEPS,
                      "samples": RF_SAMPLES,
                      "reflow iterations": RF_REFLOW_ITERS,
                      "reflow training.batch_size": [64, RF_REFLOW_BATCH],
                      "sampling.sample_N": [1000, RF_SAMPLE_N],
                      "reflow.total_number_of_samples": RF_PAIRS,
                      "likelihood steps": [100, RF_BPD_STEPS],
                      "likelihood images": RF_BPD_BATCH,
                      "weights": "seeded init (train, sample, reflow, "
                                 "pairs, likelihood); real-scale random "
                                 "(parity)"}})
    return runs


# --------------------------------------------------------------- 7. timing
# ------------------------------------------------------------ 6d. parallel
PAR_FM_BATCH = TRAIN_BATCH   # the FM step at 128^2, batch_size_train
PAR_GS_BATCH = GS_TRAIN_BATCH
PAR_STEPS = 2
PAR_SERVE_STEPS = 10         # pnp_flow steps of the sharding comparison
PAR_METRIC_N = 100           # compute_metrics samples with the fan-out
PAR_BACKEND_BATCH = 16       # grain + orbax CLI runs at 128^2
PAR_BACKEND_IMAGES = 40      # the generated CelebA-layout folder
PAR_PROFILE_STEPS = 3
# the restorations that couple a batch's images, sharded as one solver with
# its network fanned out: (name, model, Restorer keywords), cut to depth
PAR_COUPLED = (
    ("d_flow", "ot", dict(method="d_flow", problem="denoising",
                          overrides={"max_iter": 1, "LBFGS_iter": 1,
                                     "steps_euler": 3})),
    ("ot_ode_bicubic", "ot", dict(method="ot_ode",
                                  problem="superresolution_bicubic",
                                  overrides={"steps_ode": 5})),
    ("pnp_gs_hqs_deblur", "gradient_step", dict(
        method="pnp_gs", problem="gaussian_deblurring_FFT",
        overrides={"algo": "hqs", "max_iter": 3})),
)


@contextlib.contextmanager
def nccl_world_of_one(torch):
    """The default process group over NCCL at world size 1, brought up by
    ``parallel.mesh.init_distributed`` from torchrun's variables, which are
    removed again afterwards (a later CLI run must not find them)."""
    import socket

    import torch.distributed as dist

    from pnpflow_tpu_torch.parallel import mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    os.environ.update(env)
    try:
        check(mesh.init_distributed("cuda") and dist.get_backend() == "nccl"
              and mesh.world_size() == 1, "no NCCL process group")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


def _par_fm_steps(torch, sd, batches):
    """PAR_STEPS precoupled flow-matching steps (Adam lr 1e-4 + EMA, fp32,
    ``fused_norm`` True) of the 128^2 flagship from ``sd``: losses, device
    seconds a step, peak, launches, and the parameters and EMA on the
    host."""
    from pnpflow_tpu_torch.models.unet import VelocityUNet
    from pnpflow_tpu_torch.training import flow_matching as fm

    m = VelocityUNet(**dict(FLAGSHIP, input_height=TRAIN_DIM),
                     fused_norm=True)
    m.load_state_dict(sd)
    st = fm.new_state(m.cuda(), 1e-4)
    step = fm.make_fm_train_step_precoupled(ema_decay=0.999)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    clock = fm._StepClock(torch.device("cuda"))
    clock.mark()
    losses = []
    for x0, x1, t in batches:
        losses.append(step(st, x0.cuda(), x1.cuda(), t=t.cuda()))
        clock.mark()
    out = {"losses": torch.stack(losses).cpu(), "launches": read_counts(),
           "step_seconds": clock.seconds(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "params": {k: v.detach().cpu() for k, v in
                      m.named_parameters()},
           "ema": {k: v.cpu() for k, v in st.ema.items()}}
    del st, m
    torch.cuda.empty_cache()
    return out


def _par_gs_steps(torch, sd, batches, root):
    """PAR_STEPS gradient-step denoiser steps (second order through the
    GroupNorm kernel) of the 128^2 flagship at PAR_GS_BATCH from ``sd``."""
    from pnpflow_tpu_torch.models.unet import VelocityUNet
    from pnpflow_tpu_torch.training import denoiser as td
    from pnpflow_tpu_torch.training.flow_matching import _StepClock
    from pnpflow_tpu_torch.utils.config import CfgNode

    m = VelocityUNet(**dict(FLAGSHIP, input_height=TRAIN_DIM),
                     fused_norm=True)
    tr = td.GradientStepTrainer(CfgNode({
        "dataset": "synthetic", "model": "gradient_step",
        "dim_image": TRAIN_DIM, "num_channels": 3, "lr": 1e-4,
        "num_epoch": 1, "seed": 0, "output_root": root,
        "batch_size_train": PAR_GS_BATCH, "device": "cuda"}), model=m)
    st = tr.init_state()
    m.load_state_dict(sd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    clock = _StepClock(torch.device("cuda"))
    clock.mark()
    losses = []
    for y, sigma, u in batches:
        losses.append(tr.train_step(st, y.cuda(), sigma, u=u.cuda())[0])
        clock.mark()
    out = {"losses": torch.stack(losses).cpu(), "launches": read_counts(),
           "step_seconds": clock.seconds(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "params": {k: v.detach().cpu() for k, v in
                      m.named_parameters()}}
    del st, m, tr
    torch.cuda.empty_cache()
    return out


def _bit_equal(torch, a, b, what):
    check(torch.equal(a["losses"], b["losses"]),
          f"{what}: losses {a['losses'].tolist()} / {b['losses'].tolist()}")
    for key in ("params", "ema"):
        for n, v in a.get(key, {}).items():
            check(torch.equal(v, b[key][n]), f"{what}: {key} {n} differ")


def _summary(r, batch):
    step_s = statistics.median(r["step_seconds"])
    return {"losses": r["losses"].tolist(), "step_seconds": r["step_seconds"],
            "seconds_per_step": step_s, "images_per_s": batch / step_s,
            "max_memory_allocated": r["max_memory_allocated"],
            "launches": r["launches"]}


def parallel_trainers(torch):
    """Both trainers' steps at full width (the 128^2 flagship, fused_norm
    True) without a process group and under ``init_distributed`` at world
    size 1 over NCCL, from the same weights on the same data: equal bit for
    bit (the mean over one rank is the identity)."""
    import numpy as np

    from pnpflow_tpu_torch.ops.ot import host_ot_pair

    sd = {k: v.cpu() for k, v in randomized_unet(
        torch, "cpu", True, seed=31, input_height=TRAIN_DIM)
        .state_dict().items()}
    rng = np.random.default_rng(5)
    g = torch.Generator().manual_seed(5)
    fm_batches = []
    for _ in range(PAR_STEPS):
        x1 = np.tanh(rng.standard_normal(
            (PAR_FM_BATCH, TRAIN_DIM, TRAIN_DIM, 3))).astype(np.float32)
        x0 = rng.standard_normal(x1.shape, dtype=np.float32)
        i0, i1 = host_ot_pair(x0, x1, rng)
        fm_batches.append((torch.from_numpy(x0[i0]),
                           torch.from_numpy(x1[i1]),
                           torch.rand(PAR_FM_BATCH, generator=g)))
    gs_batches = [(torch.from_numpy(np.tanh(rng.standard_normal(
        (PAR_GS_BATCH, TRAIN_DIM, TRAIN_DIM, 3))).astype(np.float32)),
        float(rng.uniform(0, 0.25)),
        torch.randn((PAR_GS_BATCH, TRAIN_DIM, TRAIN_DIM, 3), generator=g))
        for _ in range(PAR_STEPS)]
    gn = gn_sites_at(TRAIN_DIM)
    out = {}
    # cuDNN's default backward algorithms may add with atomics, in an order
    # that differs between two runs of the same step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as root:
        for name, run, batches, batch in (
                ("fm", _par_fm_steps, fm_batches, PAR_FM_BATCH),
                ("gs", _par_gs_steps, gs_batches, PAR_GS_BATCH)):
            args = (torch, sd, batches) + ((root,) if name == "gs" else ())
            plain = run(*args)
            with nccl_world_of_one(torch):
                dp = run(*args)
            _bit_equal(torch, plain, dp, f"parallel/{name}")
            for r in (plain, dp):
                check(r["launches"] == only(groupnorm_swish=gn * PAR_STEPS),
                      f"parallel/{name}: launches {r['launches']}")
            out[f"{name}_plain"] = dict(_summary(plain, batch), batch=batch)
            out[f"{name}_nccl_world1"] = dict(_summary(dp, batch),
                                              batch=batch)
            del plain, dp
    torch.backends.cudnn.deterministic = deterministic
    return out


def parallel_serve(torch):
    """``Restorer(shard=True, n_devices=1)`` against ``shard=False`` on one
    request (pnp_flow, the 64^2 flagship, "conv", 4 images), bit for bit;
    then two shards on the one card (``devices=["cuda:0"] * 2``: each
    shard's thread and its slice of the batch's noise) within 1e-4 of
    max (cuDNN may pick other algorithms at 2 images than at 4).  Each
    restore is timed on its second call."""
    import numpy as np

    from pnpflow_tpu_torch.serve import Restorer

    kw = dict(method="pnp_flow", problem="gaussian_deblurring_FFT",
              dim_image=64, batch_size=4,
              overrides={"steps_pnp": PAR_SERVE_STEPS})
    out = {}
    with tempfile.TemporaryDirectory() as root:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the random-init warning
            plain = Restorer(**kw, output_root=root)
            one = Restorer(**kw, output_root=root, shard=True, n_devices=1)
            two = Restorer(**kw, output_root=root, shard=True,
                           devices=["cuda:0", "cuda:0"])
        clean = np.tanh(np.random.default_rng(3).normal(
            size=(4, 64, 64, 3))).astype(np.float32)
        y = plain.degrade(clean, seed=4).cpu()
        want = plain.restore(y, seed=5)
        t0 = time.perf_counter()
        plain.restore(y, seed=5)
        out["unsharded_seconds"] = time.perf_counter() - t0
        for name, r in (("n_devices_1", one), ("two_shards_one_card", two)):
            r.restore(y, seed=6)        # first calls plan the new shapes
            reset_counts()
            t0 = time.perf_counter()
            got = r.restore(y, seed=5)
            seconds = time.perf_counter() - t0
            launches = read_counts()
            err = float(np.abs(got - want).max() / np.abs(want).max())
            # a shard launches each of its forwards' kernels
            n = CONV_SITES * PAR_SERVE_STEPS * len(r.devices)
            check(launches == only(conv3x3_gn=n),
                  f"parallel/serve {name}: launches {launches}, {n}")
            check(np.isfinite(got).all() and (
                err == 0.0 if name == "n_devices_1" else err <= 1e-4),
                f"parallel/serve {name}: {err} of max from unsharded")
            out[name] = {"rel_err": err, "seconds": seconds,
                         "launches": launches, "steps": PAR_SERVE_STEPS}
    return out


def _coupled_checkpoint(torch, root, model, seed):
    """The 64^2 flagship with every parameter random, as the msgpack
    checkpoint that ``Restorer(model=model, output_root=root)`` reads."""
    from pnpflow_tpu_torch.models.registry import (
        model_fingerprint, save_params_file)
    from pnpflow_tpu_torch.utils.config import CfgNode
    from pnpflow_tpu_torch.utils.jax_params import flax_from_state_dict

    m = randomized_unet(torch, "cpu", True, seed=seed)
    args = CfgNode({"model": model, "dim_image": 64, "num_channels": 3})
    save_params_file(flax_from_state_dict(m.state_dict()), os.path.join(
        root, "model", "synthetic", model, "model_final.msgpack"),
        fingerprint=model_fingerprint(m, args))


def _coupled_restore(torch, r, y):
    """One restore (the first of its Restorer), its seconds and its
    launches, the GroupNorm kernel's also by card."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = r.restore(y, seed=5)          # numpy: synchronised
    return out, {"seconds": time.perf_counter() - t0,
                 "launches": read_counts(),
                 "gn_by_card": dict(launch_counters()["groupnorm_swish"]
                                    .cards)}


def parallel_coupled(torch, gn_sites):
    """The restorations that couple a batch's images, ``Restorer(shard=
    True)`` as one solver on the first card with its network fanned out
    (``parallel/mesh.py:ShardedModel``): the 64^2 flagship (``fused_norm``
    True, their default) at 4 images, fp32, two shards on card 0, and on
    cards 0 and 1 where two are visible, against ``shard=False`` on the
    same request within 1e-4 of max, both with cuDNN's deterministic
    algorithms (as the remat runs).  d_flow runs one LBFGS iteration (from
    the second on, torch's LBFGS turns rounding into other steps) and
    restores denoising: on FFT deblurring the dopri5 inversion of these
    random weights takes 259 evaluations and turns a change of 1e-7
    relative in the measurement into 2e-3 to 5e-3 of max, which no
    sharding can stay within 1e-4 of (``tests/test_torch_gpu.py`` holds it
    to three times that spread there).  Each shard launches the GroupNorm kernel on its
    card: twice the unsharded count for ot_ode and pnp_gs, and for d_flow
    136 a shard for each forward the wrapper counted; on each of those
    cards the kernel matches its plain version at every 64^2 site at a
    shard's batch."""
    import numpy as np

    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_swish_reference, groupnorm_swish_fwd)
    from pnpflow_tpu_torch.serve import Restorer

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    layouts = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() > 1:
        layouts.append(["cuda:0", "cuda:1"])
    per_forward = gn_sites_at(64)
    clean = np.tanh(np.random.default_rng(7).normal(
        size=(4, 64, 64, 3))).astype(np.float32)
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as root:
        for model, seed in (("ot", 41), ("gradient_step", 42)):
            _coupled_checkpoint(torch, root, model, seed)
        for name, model, kw in PAR_COUPLED:
            kw = dict(kw, model=model, dim_image=64, batch_size=4,
                      output_root=root)
            plain = Restorer(**kw)
            y = plain.degrade(clean, seed=4).cpu()
            want, base = _coupled_restore(torch, plain, y)
            del plain
            out[f"{name}_unsharded"] = base
            for devs in layouts:
                r = Restorer(**kw, shard=True, devices=devs)
                w = r.solver.model.model
                got, run = _coupled_restore(torch, r, y)
                forwards = w.forwards
                err = rel(got, want)
                where = f"parallel/coupled {name} on {devs}"
                check(np.isfinite(got).all() and err <= 1e-4,
                      f"{where}: {err} of max from unsharded")
                del r
                n = (per_forward * len(devs) * forwards
                     if name == "d_flow"
                     else len(devs) * base["launches"]["groupnorm_swish"])
                check(run["launches"] == only(groupnorm_swish=n),
                      f"{where}: launches {run['launches']}, {n}")
                cards = Counter(torch.device(d).index for d in devs)
                check(run["gn_by_card"] == {
                    k: v * n // len(devs) for k, v in cards.items()},
                    f"{where}: GroupNorm launches by card "
                    f"{run['gn_by_card']}")
                key = ("two_shards_one_card" if len(cards) == 1
                       else "cards_0_1")
                out[f"{name}_{key}"] = dict(run, rel_err=err, devices=devs,
                                            wrapper_forwards=forwards)
    torch.backends.cudnn.deterministic = deterministic
    # not counted: the kernel against its plain version on each card
    for d in sorted({d for devs in layouts for d in devs}):
        for i, (h, c, swish) in enumerate(sorted(set(gn_sites))):
            x, s, b = gn_inputs(torch, torch.device(d), 2, h, c,
                                torch.float32, 500 + i)
            got = groupnorm_swish_fwd(x, s, b, 32, 1e-6, swish)
            want = gn_swish_reference(x, s, b, 32, 1e-6, swish)
            e = float((got - want).abs().max())
            check(got.device == x.device and e <= 1e-4,
                  f"parallel/coupled: groupnorm_swish on {d} at "
                  f"{(2, h, c, swish)}: err {e}")
    out["gn_parity_cards"] = sorted({d for devs in layouts for d in devs})
    return out


def parallel_metrics(torch):
    """``ComputeMetric`` with the fan-out: the metric sampler and the
    Inception chunker over two copies on the one card (two threads), the
    64^2 flagship ("conv"), n PAR_METRIC_N by Euler in 5 steps; its
    samples against the one-device sampler's, and a finite line."""
    from pnpflow_tpu_torch.metrics.generative import ComputeMetric
    from pnpflow_tpu_torch.models.registry import build_model_bundle
    from pnpflow_tpu_torch.utils.config import load_full_config
    from pnpflow_tpu_torch.data import DataLoaders

    with tempfile.TemporaryDirectory() as out:
        link_metric_weights(out, inception=True, lpips=False)
        args = load_full_config(["dataset", "synthetic", "model", "ot",
                                 "dim_image", "64", "output_root", out,
                                 "seed", "0", "eval_split", "test"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the random-init warning
            bundle = build_model_bundle(args, device="cuda")
        with torch.no_grad():                   # a field that moves samples
            for p in bundle.model.parameters():
                p.add_(0.01 * torch.randn_like(p))
        loaders = DataLoaders("synthetic", 50, 50, dim_image=64,
                              num_channels=3, test_n=PAR_METRIC_N).load_data()
        fan = ComputeMetric(loaders, bundle, args,
                            devices=["cuda:0", "cuda:0"])
        single = ComputeMetric(loaders, bundle, args)
        x0 = torch.randn((METRIC_BATCH, 64, 64, 3), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
        with torch.inference_mode():
            a = fan._sample_batch(x0, 5, "euler")
            b = single._sample_batch(x0, 5, "euler")
        err = float((a - b).abs().max() / b.abs().max())
        check(err <= 1e-4, f"parallel/metrics: samples {err} of max apart")
        reset_counts()
        res = fan.compute_metrics(PAR_METRIC_N, steps=5, sampler="euler",
                                  cache=False)
        launches = read_counts()
    check(all(math.isfinite(res[k]) for k in ("fid", "kid", "vendi", "sw")),
          f"parallel/metrics: {res}")
    check(res["features"].startswith("inception_2048")
          and launches["conv3x3_gn"] > 0, f"parallel/metrics: {launches}")
    return {"sample_rel_err": err, "n": PAR_METRIC_N, "fid": res["fid"],
            "wall_s": res["wall_s"], "seconds": res["seconds"],
            "launches": launches, "devices": 2}


def _celeba_folder(root, n):
    """A CelebA-layout tree under root/data (178x178 JPEGs, the partition
    csv: all but 8 in train) and root/config linked to the checkout's."""
    import numpy as np
    from PIL import Image

    d = os.path.join(root, "data", "celeba", "img_align_celeba")
    os.makedirs(d)
    rng = np.random.default_rng(7)
    rows = ["image_id,partition"]
    for i in range(n):
        name = f"{i:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, size=(178, 178, 3),
                                     dtype=np.uint8)).save(
            os.path.join(d, name))
        rows.append(f"{name},{0 if i < n - 8 else 2}")
    with open(os.path.join(root, "data", "celeba",
                           "list_eval_partition.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    os.symlink(os.path.join(HERE, "config"), os.path.join(root, "config"))


def parallel_backends(torch):
    """``train True`` through the CLI at 128^2 (CelebA's geometry, the
    flagship, fused_norm True) on a generated CelebA-layout folder read by
    ``data_backend grain`` (4 worker processes), with ``ckpt_backend
    orbax``: 2 epochs of one step, then a resume to 4 epochs; the step
    directories, the retention of the newest 3 and the resumed step."""
    import contextlib as cl
    import io

    from pnpflow_tpu_torch.main import main

    out = {}
    with tempfile.TemporaryDirectory() as root:
        _celeba_folder(root, PAR_BACKEND_IMAGES)
        d = os.path.join(root, "out", "model", "celeba", "ot", "orbax")
        for epochs in (2, 4):
            opts = ["dataset", "celeba", "dim_image", str(TRAIN_DIM),
                    "root", root, "train", "True",
                    "num_epoch", str(epochs), "max_iters_per_epoch", "1",
                    "batch_size_train", str(PAR_BACKEND_BATCH),
                    "data_backend", "grain", "ckpt_backend", "orbax",
                    "eval", "False", "output_root",
                    os.path.join(root, "out")]
            reset_counts()
            log = io.StringIO()
            t0 = time.perf_counter()
            with cl.redirect_stdout(log):
                args = main(["--opts"] + opts)
            seconds = time.perf_counter() - t0
            steps = sorted(int(s) for s in os.listdir(d))
            out[f"epochs_{epochs}"] = {
                "seconds": seconds, "losses": args.train_stats["losses"],
                "orbax_steps": steps, "launches": read_counts()}
            check(all(map(math.isfinite, args.train_stats["losses"])),
                  f"parallel/backends: losses {args.train_stats['losses']}")
        check(out["epochs_2"]["orbax_steps"] == [1, 2]
              and out["epochs_4"]["orbax_steps"] == [2, 3, 4]
              and "Resumed from step 2 (epoch 2)" in log.getvalue()
              and len(out["epochs_4"]["losses"]) == 2,
              f"parallel/backends: {out} {log.getvalue()[-400:]}")
    gn = gn_sites_at(TRAIN_DIM)
    check(out["epochs_4"]["launches"] == only(groupnorm_swish=gn * 2),
          f"parallel/backends: launches {out['epochs_4']['launches']}")
    return out


def parallel_norm_variants(torch, dev):
    """One forward of the random 64^2 flagship per new ``fused_norm``
    variant ("dot", "tview", "bf16stats", plain PyTorch) at the main-path
    batch, fp32 and bf16, against ``False`` on the same weights (fp32:
    1e-4 of max; bf16: 3e-2, the bf16 bound of the U-Net modes), and its
    CUDA-event time (median of FORWARD_REPS)."""
    x = torch.randn((MAIN_BATCH, 64, 64, 3), device=dev,
                    generator=torch.Generator(dev).manual_seed(8))
    t = torch.rand((MAIN_BATCH,), device=dev,
                   generator=torch.Generator(dev).manual_seed(9))
    base = randomized_unet(torch, dev, False, seed=12)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        base.dtype = dtype
        with torch.no_grad():
            want = base(x, t)
            plain_ms = cuda_median_ms(torch, lambda: base(x, t))
        row = {"False_ms": plain_ms}
        for mode in ("dot", "tview", "bf16stats"):
            m = randomized_unet(torch, dev, mode, seed=12)
            m.dtype = dtype
            with torch.no_grad():
                got = m(x, t)
                row[f"{mode}_ms"] = cuda_median_ms(torch, lambda: m(x, t))
            err = float((got - want).abs().max() / want.abs().max())
            row[f"{mode}_rel_err"] = err
            check(math.isfinite(err) and err <= (
                1e-4 if dtype == torch.float32 else 3e-2),
                f"parallel/norm_variants {mode} {dtype}: {err}")
            del m
        out[str(dtype).split(".")[1]] = row
    return {"batch": MAIN_BATCH, "image": 64, **out}


def parallel_profile(torch):
    """A ``jax_profile`` restoration through the CLI (pnp_flow, the 64^2
    flagship, "conv", PAR_PROFILE_STEPS steps) and the report's top ops
    (``utils/profile_report.py``) from the trace it wrote."""
    from pnpflow_tpu_torch.main import main
    from pnpflow_tpu_torch.utils import profile_report

    with tempfile.TemporaryDirectory() as out:
        prof = os.path.join(out, "prof")
        reset_counts()
        main(["--opts", "dataset", "synthetic", "model", "ot", "eval",
              "True", "method", "pnp_flow", "problem",
              "gaussian_deblurring_FFT", "batch_size_ip", "4", "max_batch",
              "1", "num_samples", "5", "steps_pnp", str(PAR_PROFILE_STEPS),
              "save_results", "False", "output_root", out,
              "jax_profile", prof])
        launches = read_counts()
        rows = profile_report.report(prof, 25)
    check(launches == only(conv3x3_gn=CONV_SITES * PAR_PROFILE_STEPS),
          f"parallel/profile: launches {launches}")
    check(any("conv3x3_gn_kernel" in r["op"] for r in rows),
          f"parallel/profile: no conv3x3_gn kernel among {rows}")
    return {"steps": PAR_PROFILE_STEPS, "top_ops": rows[:10],
            "launches": launches}


def parallel_demos(torch):
    """The three demos through their entry points at shrunk knobs, on the
    card: the 2-D toy (200 steps), demo.py (1 epoch of 2 steps, 10 PnP
    steps) and the Dirichlet demos (10 PnP steps x 2 draws, 5 training
    iterations, 1 LBFGS iteration)."""
    from pnpflow_tpu_torch.demos import demo, dirichlet, toy_example

    out = {}
    with tempfile.TemporaryDirectory() as d:
        env = {"DIRI_STEPS": "10", "DIRI_MC": "2", "DIRI_TRAIN_ITERS": "5",
               "DIRI_DFLOW_ITERS": "1", "DIRI_OUT": os.path.join(d, "diri")}
        os.environ.update(env)
        try:
            for name, run in (
                    ("toy", lambda: toy_example.main(
                        ["--steps", "200", "--out", d])),
                    ("demo", lambda: demo.main(
                        ["--epochs", "1", "--steps-per-epoch", "2",
                         "--pnp-steps", "10", "--out", d])),
                    ("dirichlet", lambda: dirichlet.main([]))):
                reset_counts()
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                out[name] = {"seconds": time.perf_counter() - t0,
                             "launches": read_counts()}
                if name == "demo":
                    check(bool(torch.isfinite(res).all()),
                          "parallel/demos: demo.py restored non-finite")
                if name == "dirichlet":
                    check(all(bool(torch.isfinite(a).all()
                                   & torch.isfinite(b).all())
                              for a, b in res.values()),
                          "parallel/demos: dirichlet non-finite")
        finally:
            for k in env:
                os.environ.pop(k, None)
    for name in ("demo", "dirichlet"):
        check(out[name]["launches"]["groupnorm_swish"] > 0,
              f"parallel/demos: {name} launched {out[name]['launches']}")
    return out


def _par_runs(name, r):
    """The runs of a parallel result that carry ``launches``, by name."""
    if "launches" in r:
        return {name: r}
    return {f"{name}_{k}": v for k, v in r.items()
            if isinstance(v, dict) and "launches" in v}


def parallel_path(torch, dev, gn_sites):
    """The ``parallel`` phase: every run read right after it."""
    if torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} cards visible; the parallel "
              "phase still runs at world size 1", flush=True)
    runs = {}
    for name, fn in (("trainers", lambda: parallel_trainers(torch)),
                     ("serve", lambda: parallel_serve(torch)),
                     ("coupled", lambda: parallel_coupled(torch, gn_sites)),
                     ("metrics", lambda: parallel_metrics(torch)),
                     ("backends", lambda: parallel_backends(torch)),
                     ("norm_variants",
                      lambda: parallel_norm_variants(torch, dev)),
                     ("demos", lambda: parallel_demos(torch))):
        torch.cuda.empty_cache()
        with phase(f"parallel/{name}"):
            r = fn()
        emit({"parallel": name, **r})
        runs[name] = r
    return runs


def cuda_median_ms(torch, fn, reps=FORWARD_REPS, warmup=1):
    """The median of ``reps`` CUDA-event times of single calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


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


def time_gn(torch, dev, gn_sites, dtype, n=BENCH_BATCH, bm=False):
    import torch.nn.functional as F
    from pnpflow_tpu_torch.ops.gn_swish import (
        gn_swish_reference, groupnorm_swish_fwd)
    from pnpflow_tpu_torch.ops.gn_swish_bm import groupnorm_swish_bm_fwd

    fwd = groupnorm_swish_bm_fwd if bm else groupnorm_swish_fwd
    item = torch.finfo(dtype).bits // 8
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


GN_KERNEL_NAMES = ("gn_cluster_kernel", "gn_moments_kernel",
                   "gn_normalize_kernel")


def device_ms_each(torch, fns, names, reps=10, sessions=3):
    """Device time of one call of each of ``fns``, from one torch.profiler
    session: ``reps`` calls of each in turn, each launching one kernel whose
    name contains one of ``names``; the kernels, in the order they ran,
    belong to the calls in the order they were made.  The profiler now and
    then loses a kernel's record (2479 of 2480 once), which would shift
    every attribution after it: such a session is taken again, up to
    ``sessions`` in all, and each loss is printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and any(name in ev.name for name in names)),
                     key=lambda ev: ev.time_range.start)
        if len(evs) == reps * len(fns):
            break
        emit({"profiler_lost_records": {"session": session,
                                        "recorded": len(evs),
                                        "expected": reps * len(fns)}})
    check(len(evs) == reps * len(fns),
          f"torch.profiler recorded {len(evs)} kernels named {names}, "
          f"expected {reps * len(fns)}")
    return [sum(ev.time_range.elapsed_us()
                for ev in evs[i * reps:(i + 1) * reps]) / 1e3 / reps
            for i in range(len(fns))]


def time_gn_bm(torch, dev, gn_sites, dtype, n=BENCH_BATCH):
    return time_gn(torch, dev, gn_sites, dtype, n=n, bm=True)


def conv_bounds_ms(site, n, dtype):
    """(bytes, operations) bound of one conv3x3_gn launch at n images: x,
    w, the residual and y once each, and the f32 vectors; 2 flops a product
    of the 9*C*CO per pixel.  In float32 the operations bound is the least
    time for fp32-accurate products: the CUDA cores' rate, or three TF32
    tensor-core products per product (3xTF32), whichever is less."""
    h, cin, cout, pro, sb, res = site
    item = dtype.itemsize
    px = n * h * h
    nbytes = (px * cin + 9 * cin * cout + px * cout * (2 if res else 1)) \
        * item + 4 * (n * 2 * cout + (2 * n * cin if pro else 0)
                      + (n * cout if sb else 0) + cout)
    flop = 2 * px * 9 * cin * cout
    ops = (flop / PEAK["bfloat16"] if item == 2
           else min(flop / PEAK["float32"], 3 * flop / PEAK["tf32"]))
    return 1e3 * nbytes / MEM_BW, 1e3 * ops


def time_conv(torch, dev, conv_sites, dtype, n=BENCH_BATCH):
    """Per-forward times at batch n, and by site: launches, then the
    kernel's, the library call's and the bound's ms for all of that site's
    launches."""
    import torch.nn.functional as F
    from pnpflow_tpu_torch.ops.fused_conv_gn import (
        conv3x3_gn, conv3x3_gn_reference)

    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0, "by_site": {}}
    for site, k in Counter(conv_sites).items():
        args, kw = conv_inputs(torch, dev, n, site, dtype, 0)
        x, w, b = args
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        b_lib = b.to(dtype)
        ms = cuda_ms(torch, lambda: conv3x3_gn(*args, **kw), 3)
        lib_ms = cuda_ms(
            torch, lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1))
        bytes_ms, ops_ms = (k * v for v in conv_bounds_ms(site, n, dtype))
        # (h, cin, cout, prologue, sample bias, residual)
        tot["by_site"]["/".join(str(int(v)) for v in site)] = [
            k, k * ms, k * lib_ms, max(bytes_ms, ops_ms)]
        tot["ms"] += k * ms
        tot["plain_ms"] += k * cuda_ms(
            torch, lambda: conv3x3_gn_reference(*args, **kw), 2)
        tot["library_ms"] += k * lib_ms
        tot["bytes_ms"] += bytes_ms
        tot["ops_ms"] += ops_ms
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


def fir_site_key(site):
    """h x w x c, "up" or "down": the by-site key of an NCSN++ FIR site."""
    h, w, c, up = site[:4]
    return f"{h}x{w}x{c} {'up' if up > 1 else 'down'}"


def adjoint_site(site):
    """The upfirdn2d site that computes the gradient of ``site``'s input:
    its output's shape in, the adjoint geometry."""
    import numpy as np
    from pnpflow_tpu_torch.ops.upfirdn import adjoint_geometry

    h, w, c, up, down, p0, p1, taps = site
    kk = len(taps)
    oh = (h * up + p0 + p1 - kk) // down + 1
    ow = (w * up + p0 + p1 - kk) // down + 1
    k, up_a, down_a, (q0, q1), crop = adjoint_geometry(
        h, w, np.asarray(taps, np.float32), up, down, (p0, p1))
    check(crop is None, f"adjoint of {site[:7]} needs a crop")
    return (oh, ow, c, up_a, down_a, q0, q1,
            tuple(tuple(float(v) for v in row) for row in k))


def fir_bounds_ms(site, n, item):
    """(bytes, operations) bound of one launch at n images: one read of x
    and one write of y; 2 flops for each tap on a non-zero input."""
    h, w, c, up, down, p0, p1, taps = site
    kk = len(taps)
    oh = (h * up + p0 + p1 - kk) // down + 1
    ow = (w * up + p0 + p1 - kk) // down + 1
    out = n * oh * ow * c
    return (1e3 * (n * h * w * c + out) * item / MEM_BW,
            1e3 * 2 * (kk // up) ** 2 * out / PEAK["float32"])


def time_fir(torch, dev, firs, dtype, n=MAIN_BATCH):
    """Per NCSN++ forward (or, given the adjoint sites, per VJP) at n
    images, and by site: launches, then the kernel's, the bound's and the
    library call's ms for all of that site's launches."""
    from pnpflow_tpu_torch.ops.upfirdn import upfirdn2d, upfirdn2d_reference

    item = torch.finfo(dtype).bits // 8
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0, "by_site": {}}
    for site, cnt in Counter(firs).items():
        x, k, kw = fir_inputs(torch, dev, n, site, dtype, 0)
        lib = fir_library(torch, x, k, **kw)
        y = upfirdn2d(x, k, **kw)
        d = float((lib().permute(0, 2, 3, 1).float() - y.float())
                  .abs().max())
        check(d <= (1e-5 if dtype == torch.float32 else 5e-2),
              f"library call disagrees at {site[:7]}: {d}")
        ms = cnt * cuda_ms(torch, lambda: upfirdn2d(x, k, **kw))
        lib_ms = cnt * cuda_ms(torch, lib)
        bytes_ms, ops_ms = (cnt * b for b in fir_bounds_ms(site, n, item))
        tot["by_site"][fir_site_key(site)] = [cnt, ms, max(bytes_ms, ops_ms),
                                              lib_ms]
        tot["ms"] += ms
        tot["plain_ms"] += cnt * cuda_ms(
            torch, lambda: upfirdn2d_reference(x, k, **kw), 2)
        tot["library_ms"] += lib_ms
        tot["bytes_ms"] += bytes_ms
        tot["ops_ms"] += ops_ms
    return tot


def kernel_rows(torch, dev, sites, launches, err, runs):
    """One row per kernel; ``launches`` counts the main-path run that drives
    it, ``launches_by_run`` every run of the script's main paths that
    launched it (and, for upfirdn2d, ``roles_by_run``: forward, adjoint and
    tangent launches)."""
    kernels = []
    for name, fn, key, route, src, repl, batch in (
        ("conv3x3_gn", time_conv, "conv", "cuda",
         "pnpflow_tpu_torch/ops/csrc/conv3x3_gn.cu",
         "pnpflow_tpu/ops/fused_conv_gn.py:87", BENCH_BATCH),
        ("groupnorm_swish", time_gn, "gn", "cuda",
         "pnpflow_tpu_torch/ops/csrc/gn_swish.cu",
         "pnpflow_tpu/ops/pallas_kernels.py:140", BENCH_BATCH),
        ("groupnorm_swish_bm", time_gn_bm, "gn", "cuda",
         "pnpflow_tpu_torch/ops/csrc/gn_swish.cu",
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
            "launches_by_run": {r: v["launches"][name]
                                for r, v in runs.items()
                                if v["launches"][name]},
        })
        if name == "upfirdn2d":
            kernels[-1]["roles_by_run"] = {
                r: v["fir_roles"] for r, v in runs.items()
                if v.get("fir_roles") and v["launches"][name]}
            # its backward: the same kernel at each site's adjoint geometry,
            # per NCSN++ VJP at the differentiated methods' batch
            adj_sites = [adjoint_site(site) for site in sites[key]]
            with phase("timing/upfirdn2d_adjoint"):
                adj = {}
                for dtype in (torch.float32, torch.bfloat16):
                    with torch.inference_mode():
                        adj[str(dtype)[6:]] = time_fir(
                            torch, dev, adj_sites, dtype, n=DIFF_BATCH)
            a = adj["float32"]
            kernels[-1]["adjoint"] = {
                "batch": DIFF_BATCH,
                "launches": sum(v["fir_roles"]["adjoint"]
                                for v in runs.values()
                                if v.get("fir_roles")),
                "ms": a["ms"], "plain_ms": a["plain_ms"],
                "bound_ms": max(a["bytes_ms"], a["ops_ms"]),
                "library_ms": a["library_ms"]}
            emit({"kernel_timing": "upfirdn2d_adjoint", "per_vjp": True,
                  "launches_per_vjp": len(adj_sites), "batch": DIFF_BATCH,
                  **adj})
        emit({"kernel_timing": name, "per_forward": True,
              "launches_per_forward": len(sites[key]), "batch": batch,
              **{dt: {k: v for k, v in d.items()} for dt, d in per.items()}})
        if key in ("conv", "gn"):
            with phase(f"timing/{name}_main_batch"):
                main = {}
                for dtype in (torch.float32, torch.bfloat16):
                    with torch.inference_mode():
                        main[str(dtype)[6:]] = fn(
                            torch, dev, sites[key], dtype, n=MAIN_BATCH)
            emit({"kernel_timing": name, "per_forward": True,
                  "launches_per_forward": len(sites[key]),
                  "batch": MAIN_BATCH, **main})
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
                fwd[f"{fused}/{str(dtype)[6:]}"] = cuda_median_ms(
                    torch, lambda: m(x, t))
            del m
    emit({"unet_forward_ms": fwd, "batch": BENCH_BATCH,
          "median_of": FORWARD_REPS})

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
    ("gn_cluster_kernel", "gn_swish"), ("gn_moments_kernel", "gn_swish"),
    ("gn_normalize_kernel", "gn_swish"),
    ("GroupNorm", "group_norm"), ("conv", "conv"), ("cudnn", "conv"),
    ("xmma", "conv"), ("fft", "conv"), ("winograd", "conv"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("softmax", "softmax"),
    ("elementwise", "elementwise"), ("reduce", "reduce"), ("copy", "copy"),
)
# CUPTI's own buffer-management records, which key_averages lists beside
# the kernels
CUPTI_RECORDS = ("Buffer Flush", "Activity Buffer Request",
                 "Command Buffer Full")


def profile_forward(torch, dev, key, m, x, t):
    """Device time of one model forward by kernel, from
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
    emit({key: {
        "dtype": str(m.dtype)[6:], "batch": x.shape[0], "wall_ms": wall_ms,
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


MARK_RUNS = (2, 4, 6, 8, 10)  # spin kernels at each boundary of a step
PROFILE_ATTEMPTS = 3          # train-step sessions until every boundary shows


def _marked_parts(evs, names):
    """Split kernel events (in device order) at the runs of marker kernels:
    boundary k is a run of MARK_RUNS[k] spin kernels, or one fewer, so a
    boundary is still known if the profiler drops one of its kernels.
    Returns [(part name, events)]; parts between boundaries that were not
    found are merged under their joined names."""
    runs, i = [], 0
    while i < len(evs):
        if "spin_kernel" not in evs[i].name:
            i += 1
            continue
        j = i
        while j + 1 < len(evs) and "spin_kernel" in evs[j + 1].name:
            j += 1
        runs.append((i, j))
        i = j + 1
    bounds = {}
    for a, b in runs:
        k = next((k for k, m in enumerate(MARK_RUNS) if b - a + 1 in (m, m - 1)),
                 None)
        if k is not None:
            bounds[k] = (a, b)
    found = sorted(bounds)
    return [("+".join(names[k1:k2]), evs[bounds[k1][1] + 1:bounds[k2][0]])
            for k1, k2 in zip(found, found[1:])], found


def profile_train_step(torch, dev, batch):
    """torch.profiler of one train step of the 128x128 flagship (seeded
    init, ``fused_norm`` True) at ``batch``, after one warm-up step: the
    parts of ``apply_updates`` (forward with the loss, backward, Adam, EMA)
    are told apart by runs of marker kernels (``torch.cuda._sleep``)
    launched between them on the same stream, and each part's kernels are
    grouped by name.  The busy share is the kernels' device time over the
    step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pnpflow_tpu_torch.models.unet import VelocityUNet, init_weights
    from pnpflow_tpu_torch.training.flow_matching import (
        ema_step, make_fm_loss, new_state)

    m = init_weights(VelocityUNet(**dict(FLAGSHIP, input_height=TRAIN_DIM),
                                  fused_norm=True), 0).to(dev)
    state = new_state(m, 1e-4)
    g = torch.Generator(device=dev).manual_seed(10)
    x0, x1 = (torch.randn(batch, TRAIN_DIM, TRAIN_DIM, 3, generator=g,
                          device=dev) for _ in range(2))
    t = torch.rand(batch, generator=g, device=dev)
    named = list(m.named_parameters())
    ema, params = [state.ema[n] for n, _ in named], [p for _, p in named]
    parts = ("forward", "backward", "adam", "ema")

    def step(mark):
        mark(0)
        loss = make_fm_loss(m)(x0, x1, t)
        mark(1)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark(2)
        state.optimizer.step()
        mark(3)
        ema_step(ema, params, 0.999)
        mark(4)

    def mark(k):
        for _ in range(MARK_RUNS[k]):
            torch.cuda._sleep(1000)

    step(lambda k: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # a session can miss kernels launched as it starts or ends, markers
    # included: one kernel and a pause come before the first marker and
    # after the last, and a session that lost a boundary is taken again
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t.sum()
            torch.cuda.synchronize()
            time.sleep(0.05)
            t0 = time.perf_counter()
            step(mark)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            t.sum()
            torch.cuda.synchronize()
            time.sleep(0.05)
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and ev.name not in CUPTI_RECORDS),
                     key=lambda ev: ev.time_range.start)
        split, found = _marked_parts(evs, parts)
        if len(found) == len(MARK_RUNS):
            break
    peak = torch.cuda.max_memory_allocated(dev)
    out, total = {}, 0.0
    for part, part_evs in split:
        groups, names = Counter(), Counter()
        for ev in part_evs:
            ms = ev.time_range.elapsed_us() / 1e3
            groups[next((k for w, k in TRAIN_PROFILE_GROUPS if w in ev.name),
                        "other")] += ms
            names[ev.name[:90]] += ms
        ms = sum(groups.values())
        total += ms
        out[part] = {"device_ms": ms, "kernels": len(part_evs),
                     "groups_ms": dict(groups),
                     "top": [[k, v] for k, v in names.most_common(6)]}
    check(total > 0, f"train-step profile: no kernel between markers "
          f"{found} of {len(evs)} kernels")
    emit({"train_step_profile": {
        "image": TRAIN_DIM, "batch": batch, "wall_ms": wall_ms,
        "device_ms": total, "device_busy_share": total / wall_ms,
        "max_memory_allocated": peak, "boundaries_found": found,
        "attempts": attempt, "parts": out}})


# keyword -> group of a train step's kernels, first match wins
TRAIN_PROFILE_GROUPS = (
    ("gn_cluster_kernel", "gn_swish"), ("gn_moments_kernel", "gn_swish"),
    ("gn_normalize_kernel", "gn_swish"), ("multi_tensor_apply", "foreach"),
    ("dgrad", "conv"), ("wgrad", "conv"), ("complex", "conv"),
) + PROFILE_GROUPS


# ------------------------------------------------------------- 8. profiles
def profiles(torch, dev, gn_sites, firs, rect_state, train_batch):
    """torch.profiler readings, taken last: once the profiler has run,
    later launches can cost the host more, so no timing above follows it.
    From one profiler session, the GroupNorm kernels' device time per U-Net
    forward for both entries at both batches and the upfirdn2d kernels' per
    NCSN++ forward by site; then kernel breakdowns of one U-Net forward with
    ``fused_norm`` True per dtype, of one float32 NCSN++ 256^2 forward and
    of one train step of the 128x128 flagship."""
    from pnpflow_tpu_torch.ops.gn_swish import groupnorm_swish_fwd
    from pnpflow_tpu_torch.ops.gn_swish_bm import groupnorm_swish_bm_fwd

    from pnpflow_tpu_torch.ops.upfirdn import upfirdn2d

    # the GroupNorm and FIR kernels' device times come from one profiler
    # session, which keeps the profiler's starts and stops few: every site
    # of both GroupNorm entries at both batches (the flagship sites all take
    # the one-kernel cluster path) and every NCSN++ FIR site, per dtype
    calls, rows = [], []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            for n in (BENCH_BATCH, MAIN_BATCH):
                for (h, c, swish), k in Counter(gn_sites).items():
                    x, s, b = gn_inputs(torch, dev, n, h, c, dtype, 0)
                    for name, fwd in (
                            ("groupnorm_swish", groupnorm_swish_fwd),
                            ("groupnorm_swish_bm", groupnorm_swish_bm_fwd)):
                        calls.append(functools.partial(fwd, x, s, b, 32,
                                                       1e-6, swish))
                        rows.append(("gn", f"{name}/{n}/{dt}", k, None))
            for site, k in Counter(firs).items():
                x, taps, kw = fir_inputs(torch, dev, MAIN_BATCH, site, dtype,
                                         0)
                calls.append(functools.partial(upfirdn2d, x, taps, **kw))
                rows.append(("fir", dt, k, site, MAIN_BATCH))
                # the same site's backward in an NCSN++ VJP at the
                # differentiated methods' batch: the kernel on dy in the
                # adjoint geometry
                adj = adjoint_site(site)
                dy, taps_a, kw_a = fir_inputs(torch, dev, DIFF_BATCH, adj,
                                              dtype, 1)
                calls.append(functools.partial(upfirdn2d, dy, taps_a, **kw_a))
                rows.append(("fir_adjoint", dt, k, adj, DIFF_BATCH))
        each = device_ms_each(torch, calls, GN_KERNEL_NAMES + ("upfirdn2d",))
    gn, fir = {}, {"fir": {}, "fir_adjoint": {}}
    for (kind, key, k, site, *n), ms in zip(rows, each):
        if kind == "gn":
            gn[key] = gn.get(key, 0.0) + k * ms
            continue
        res = fir[kind].setdefault(key, {"ms": 0.0, "bound_ms": 0.0,
                                         "by_site": {}})
        item = 4 if key == "float32" else 2
        bound = k * max(fir_bounds_ms(site, n[0], item))
        res["by_site"][fir_site_key(site)] = [k, k * ms, bound]
        res["ms"] += k * ms
        res["bound_ms"] += bound
    emit({"gn_device_ms_per_forward": gn})
    emit({"fir_device_ms_per_forward": fir["fir"], "batch": MAIN_BATCH,
          "by_site": "[launches per forward, device ms, bound ms]"})
    emit({"fir_adjoint_device_ms_per_vjp": fir["fir_adjoint"],
          "batch": DIFF_BATCH,
          "by_site": "[launches per VJP, device ms, bound ms] keyed by the "
                     "adjoint launch's own input and kind"})

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(BENCH_BATCH, 64, 64, 3, generator=g, device=dev)
    t = torch.rand(BENCH_BATCH, generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        profile_forward(torch, dev, "unet_profile",
                        randomized_unet(torch, dev, True, dtype=dtype), x, t)

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(MAIN_BATCH, RECT_DIM, RECT_DIM, 3, generator=g,
                    device=dev)
    t = torch.rand(MAIN_BATCH, generator=g, device=dev) * 999.0 + 1.0
    profile_forward(torch, dev, "ncsnpp_profile",
                    ncsnpp(torch, dev, rect_state), x, t)
    del x, t
    torch.cuda.empty_cache()
    profile_train_step(torch, dev, train_batch)
    return fir["fir_adjoint"]["float32"]


def conv_functions(sass):
    """Each conv3x3_gn kernel function this run launched (by tile key):
    its launches and SASS counts.  Fails if one has no HGMMA (it would not
    be on wgmma) or no TMA load."""
    launched = {k: v for k, v in launch_counters()["conv3x3_gn"].tiles.items()
                if v}
    check(launched, "no conv3x3_gn launch was counted by kernel function")
    rows = {}
    for key, count in sorted(launched.items()):
        got = sass.get(key)
        check(got is not None, f"conv3x3_gn {key}: not in the library's SASS")
        check(got["HGMMA"] > 0 and got["UTMALDG"] > 0,
              f"conv3x3_gn {key}: SASS holds {got}")
        rows[key] = dict(got, launches=count)
    return rows


def left_running():
    """The processes this script started that still run, as
    ``pid: command`` (zombies aside), after the grain workers' forkserver
    and resource tracker are stopped as they are at exit."""
    from pnpflow_tpu_torch.data.grain_loader import stop_worker_servers

    stop_worker_servers()
    parent, cmd = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd[int(d)] = f.read().replace(b"\0", b" ").decode()[:200]
        except OSError:
            continue
        if state != "Z":
            parent[int(d)] = int(ppid)
    ours = {os.getpid()}
    grew = True
    while grew:
        kids = {p for p, pp in parent.items() if pp in ours} - ours
        grew = bool(kids)
        ours |= kids
    return {p: cmd.get(p, "") for p in sorted(ours - {os.getpid()})}


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
        sass = build()
    with phase("sites"):
        gn_sites, conv_sites = unet_sites(torch, dev)
        train_sites = unet_sites(torch, dev, TRAIN_DIM)
        firs = fir_sites(torch, dev)
        rect_state = randomized_ncsnpp_state(torch)
    sites = {"gn": gn_sites, "conv": conv_sites, "fir": firs}
    with phase("kernel_parity"):
        err, gn_plans = kernel_parity(torch, dev, gn_sites, conv_sites,
                                      firs, train_sites)
    with phase("kernel_parity/autodiff"):
        autodiff_kernel_parity(torch, dev, firs, gn_sites)
    with phase("model_parity"):
        model_parity(torch, dev, rect_state)
    with phase("model_parity/training"):
        training_parity(torch, dev)
    with phase("model_parity/autodiff"):
        autodiff_model_parity(torch, dev, rect_state)
    with phase("model_parity/gs"):
        gs_model_parity(torch, dev)
    diff_state = randomized_diffunet_state(torch, 21)
    with phase("model_parity/diffunet"):
        diffunet_parity(torch, dev, diff_state)
    with tempfile.TemporaryDirectory() as tmp:
        write_metric_weights(os.path.join(tmp, "metric_weights"))
        with phase("model_parity/metrics"):
            metrics_parity(torch, dev)
        rect_ckpt = os.path.join(tmp, "rectified.pt")
        # a RectifiedFlow-layout checkpoint: {model, ema, optimizer, step}
        torch.save({"model": {"module." + k: v for k, v in rect_state.items()},
                    "ema": None, "optimizer": {}, "step": 0}, rect_ckpt)
        diff_ckpt = save_diffunet_checkpoint(diff_state, tmp)
        del diff_state
        launches, runs = main_path(torch, rect_ckpt)
        runs.update(compute_metrics_path(torch))
        train = train_path(torch)
        runs["train_fp32"] = train
        runs["fid_curve"] = train["fid_curve"]
        runs.update(differentiated_path(torch, rect_ckpt))
        runs.update(remat_path(torch, rect_ckpt))
        runs.update(pnp_gs_path(torch))
        runs["train_gs_fp32"] = train_gs_path(torch)
        runs.update(pnp_diff_path(torch, diff_ckpt))
        with phase("main_path/serve"):
            runs["serve"] = serve_path(torch)
        emit({"main_path": "serve", **runs["serve"]})
        with phase("parallel"):
            par = parallel_path(torch, dev, gn_sites)
    with phase("rf_zoo"):
        runs.update(rf_zoo_path(torch, dev, rect_state))
    launches["groupnorm_swish"] += train["launches"]["groupnorm_swish"]
    # the parallel phase's runs: each launched its kernels (checked there)
    runs.update({f"parallel_{k}": v for name, r in par.items()
                 for k, v in _par_runs(name, r).items()})
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    kernels = kernel_rows(torch, dev, sites, launches, err, runs)
    with phase("timing/unet"):
        time_unet(torch, dev)
    with phase("timing/rectified"):
        time_rectified(torch, dev, rect_state)
    with phase("profiles"):
        adjoint = profiles(torch, dev, gn_sites, firs, rect_state,
                           train["batch"])
    next(k for k in kernels if k["name"] == "groupnorm_swish")[
        "plans_under_gradient"] = gn_plans
    fir_row = next(k for k in kernels if k["name"] == "upfirdn2d")
    fir_row["adjoint_device_ms_per_vjp"] = adjoint["ms"]
    fir_row["adjoint_bound_ms"] = adjoint["bound_ms"]
    # after the profiles: a second profiler session in the process loses
    # a few kernel records of the one after it
    with phase("parallel/profile"):
        prof = parallel_profile(torch)
    emit({"parallel": "profile", **prof})
    next(k for k in kernels if k["name"] == "conv3x3_gn")[
        "launches_by_run"]["parallel_profile"] = \
        prof["launches"]["conv3x3_gn"]
    conv_row = next(k for k in kernels if k["name"] == "conv3x3_gn")
    conv_row["sass"] = conv_functions(sass)
    left = left_running()
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    check(not left, f"processes left running (killed): {left}")
    emit({"kernels": kernels})
    emit({"seconds": time.perf_counter() - t_all})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
