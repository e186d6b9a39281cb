"""Closed-loop restoration traffic through the port's serving API.

Set-up builds ``serve.Restorer`` for the traffic's method and problem,
loads weights drawn from the seed, and warms the cell's one shape with
``warmup_solves`` one-step solves.  The window is one client sending
requests back to back: each a fresh batch of ``batch`` clean images drawn
from the seed and degraded by the benchmark's own blur and noise, restored
by ``PnPFlow.solve_batch`` of the Restorer's solver with a report callback,
as the CLI drives it.  At each report point the callback keeps the state;
the first report point at or after the deadline ends the window, and one
synchronisation closes it.  The rate is the batch times the PnP steps run
over the steps of a request and over the window's seconds: one request of
the large model outlasts any window, so whole requests would count
nothing.

The check, once the window has closed, its peak read and the program
freed: the plain reference (``reference/``, weights drawn again from the
seed) runs the first request from its measurement to its first report
point, the first step (``start_gap``), and one later stage drawn from the
seed from the program's state at a report point to the next one, ten
steps (``stage_gap``).  Each gap is max|program - reference| /
max|reference|.  A window that reaches no second report point after the
first request's first has no stage to compare and reads NaN.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import inputs, port
from portbench.reference.pnp_flow import FFTBlur, PnPFlow
from portbench.trace import Profiled


class _Stop(Exception):
    """Raised by the report callback to end a request at the deadline."""


def meta_model(run):
    """The reference's parameters, shapes only: what the weights are drawn
    for."""
    with torch.device("meta"):
        return run.reference().Model(run.config)


def reference(run, meta, wseed, dev):
    ref = run.reference().Model(run.config).to(dev).eval()
    load_weights(ref, inputs.make_weights(meta, run.config, wseed, dev))
    return ref


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_restorer(run, dev, root):
    from pnpflow_tpu_torch.serve import Restorer

    cfg, tr = run.config, run.traffic
    over = {k: tr[k] for k in ("steps_pnp", "num_samples", "lr_pnp",
                               "gamma_style", "alpha") if k in tr}
    if "fused_norm" in tr:
        over["fused_norm"] = tr["fused_norm"]
    r = Restorer(method=tr["method"], problem=tr["problem"],
                 model=cfg["model"], dim_image=cfg["image_size"],
                 num_channels=cfg["num_channels"],
                 sigma_noise=tr["sigma_noise"], batch_size=tr["batch"],
                 overrides=over, device=dev, output_root=root)
    deg = r.degradation
    if (float(deg.sigma), int(deg.kernel_size)) != (
            float(tr["sigma_blur"]), int(tr["kernel_size"])):
        raise RuntimeError(f"the program blurs with sigma {deg.sigma}, "
                           f"size {deg.kernel_size}; the traffic states "
                           f"{tr['sigma_blur']}, {tr['kernel_size']}")
    return r


def load_weights(module, weights):
    """Load the benchmark's weights; only buffers may be left as they
    are."""
    target = getattr(module, "model", module)
    missing, unexpected = target.load_state_dict(weights, strict=False)
    buffers = {n for n, _ in target.named_buffers()}
    if unexpected or set(missing) - buffers:
        raise RuntimeError(f"the program's model differs from the "
                           f"configuration: missing {missing}, unexpected "
                           f"{unexpected}")


def run(run):
    dev = torch.device(run.device)
    from pnpflow_tpu_torch.ops import _build

    if dev.type == "cuda":
        _build.build(run.traffic["kernels"])
    run.phase("kernels")
    root = tempfile.mkdtemp(prefix="portbench-")
    try:
        _run(run, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(run, dev, root):
    cfg, tr = run.config, run.traffic
    restorer = build_restorer(run, dev, root)
    run.phase("restorer")
    meta = meta_model(run)
    wseed = run.subseed(0)
    weights = inputs.make_weights(meta, cfg, wseed, dev)
    load_weights(restorer.bundle.model, weights)
    del weights
    run.phase("weights")
    if run.control == "reference-tf32":
        # the control: the reference in the program's place, in TF32
        restorer.solver.model.model = reference(run, meta, wseed, dev)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    solver, deg = restorer.solver, restorer.degradation
    blur = FFTBlur(tr["sigma_blur"], tr["kernel_size"], cfg["image_size"],
                   dev)
    b, size, ch = tr["batch"], cfg["image_size"], cfg["num_channels"]
    steps = int(tr["steps_pnp"])

    def request(k):
        gen = torch.Generator(device=dev).manual_seed(run.subseed(1, k + 1))
        clean = inputs.clean_images(gen, b, size, ch, dev)
        y = blur.H(clean)
        return y + tr["sigma_noise"] * torch.randn(
            y.shape, generator=gen, device=dev)

    def first_point(x, r):
        raise _Stop

    with solver.grad_mode():
        y = request(-1)
        for i in range(int(tr["warmup_solves"])):
            try:
                solver.solve_batch(y, y, deg, restorer.sigma_noise, i,
                                   report_cb=first_point)
            except _Stop:
                pass
    del y
    sync(dev)
    run.phase("warm-up")
    run.window_opened()

    records, state = [], {"stop": False, "deadline": 0.0}

    def make_cb(rec):
        def cb(x, r):
            rec["states"][r] = x
            rec["steps"] = r + 1
            if time.perf_counter() >= state["deadline"]:
                state["stop"] = True
                raise _Stop
        return cb

    before = port.launch_counts(tr["counters"])
    with Profiled(run.traced) as prof:
        t_start = time.perf_counter()
        state["deadline"] = t_start + run.seconds
        k = 0
        while not state["stop"]:
            y = request(k)
            rec = {"k": k, "batch": run.subseed(2, k) % 2 ** 40, "y": y,
                   "states": {}, "steps": 0}
            records.append(rec)
            with record_function("portbench.request"), solver.grad_mode():
                try:
                    out, _ = solver.solve_batch(
                        y, y, deg, restorer.sigma_noise, rec["batch"],
                        report_cb=make_cb(rec))
                    rec["states"][steps - 1] = out
                    rec["steps"] = steps
                except _Stop:
                    pass
            if time.perf_counter() >= state["deadline"]:
                state["stop"] = True
            k += 1
        sync(dev)
        t_end = time.perf_counter()
    launches = port.since(tr["counters"], before)
    run.trace = prof.trace
    done = sum(r["steps"] for r in records)
    run.rate[tr["rate_metric"]] = b * done / steps / (t_end - t_start)
    run.attempted = len(records)
    run.peak_bytes = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0)
    run.facts.update(
        forwards=done, images_per_forward=b * int(tr["num_samples"]),
        window_s=t_end - t_start,
        launches=launches)
    del restorer, solver, deg, prof
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    check(run, dev, records, blur, wseed)
    run.facts["check_s"] = time.perf_counter() - t


def gap(prog, ref) -> float:
    return float((prog.float() - ref).abs().max() / ref.abs().max())


@torch.no_grad()
def check(run, dev, records, blur, wseed):
    tr = run.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pnp = PnPFlow(reference(run, meta_model(run), wseed, dev), blur, tr)
    first = records[0]
    point = min(first["states"])
    x = pnp.run(first["y"], pnp.start(first["y"]), first["batch"], 0, point)
    start = gap(first["states"][point], x)
    run.check("start_gap", start)
    failed = int(not start <= run.limits["start_gap"])
    segments = [(rec, a, z) for rec in records
                for a, z in zip(sorted(rec["states"]),
                                sorted(rec["states"])[1:])
                if a >= point]
    # a window that reached no later stage has nothing to compare there
    stage = float("nan")
    if segments:
        rng = np.random.default_rng(run.subseed(3))
        rec, a, z = segments[int(rng.integers(len(segments)))]
        x = pnp.run(rec["y"], rec["states"][a].clone(), rec["batch"], a + 1,
                    z)
        stage = gap(rec["states"][z], x)
        run.facts["stage"] = (rec["k"], a, z)
    run.check("stage_gap", stage)
    run.failed = failed + int(not stage <= run.limits["stage_gap"])
