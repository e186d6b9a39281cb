"""Flow-matching training through the port's own trainer.

Set-up builds ``FlowMatchingTrainer`` as the CLI does (``train True``, one
epoch with no iteration cap) and a pool of ``pool_batches`` batches of
clean images drawn from the seed, held in host memory as a loader would
hold a decoded dataset.  One call of ``FlowMatchingTrainer.train`` then runs
everything, with its host OT pairing and its prefetch thread: the loader
hands it batches of a seeded permutation of the pool, pass after pass.  Its
first ``warmup_steps`` steps are set-up, and the window is the steps after
them: the benchmark wraps the trainer's step to synchronise once after the
last warm-up step and once after the first step that ends at or after the
deadline (and not before the step the check replays), and then stops the
loader.  The rate is the batch times the window's steps over its seconds.
The trainer's checkpoint writes after the window are skipped (about 1.7 GB
a run).

The check follows the first three steps, which the same ``train`` call
made on distinct rows: the plain reference (``reference/fm_train.py``)
draws the same init from the trainer's seed, pairs the same batches and
steps them.  Compared: the relative gap of each step's loss, and for the
first gradient (from Adam's first moment after step 1) and the change of
the parameters and of the EMA after step 3, the median over leaves of the
gap between the two norms of a leaf against the larger of that leaf's and
the median leaf's reference norm (leaves whose reference gradient is under
a thousandth of the median leaf's are left out of the changes: they move
by round-off alone).  Not the worst leaf: the trainer's init leaves the
last conv at 1e-10 of its scale, which brings every gradient behind it
down to the rounding residue of the leaves whose gradient is nought (a
bias ahead of a GroupNorm of one channel a group), so that residue sets
the worst leaf.

Then one step of the window, drawn from the seed among its first
``probe_span``: the benchmark keeps the program's parameters, Adam moments
and EMA before it, and the reference, its draws advanced past the steps
before, makes that step from them on the same rows, with the bias
correction of that step's count (the ``window_*`` gaps, read as above; the
program's gradient from its first moment before and after the step).
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import inputs, port
from portbench.reference import fm_train as ref_train
from portbench.trace import Profiled

CHECKED = 3


class Pool:
    """A seeded permutation of the pool's rows a pass; stops once
    ``stop`` is set."""

    def __init__(self, images: np.ndarray, batch: int, seed: int,
                 keep: int):
        self.images, self.batch, self.seed, self.keep = (images, batch,
                                                          seed, keep)
        self.stop = threading.Event()
        self.issued = []

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            perm = rng.permutation(len(self.images))
            for j in range(len(self.images) // self.batch):
                if self.stop.is_set():
                    return
                rows = perm[j * self.batch:(j + 1) * self.batch]
                if len(self.issued) < self.keep:
                    self.issued.append(rows)
                yield self.images[rows], np.zeros(self.batch, np.int64)


def leaf_norms(tensors):
    """The norm of each tensor, left on its device."""
    return torch.stack([t.float().norm() for t in tensors])


def moment(opt, p, key):
    """Adam's moment ``key`` of ``p``, zeros before its first step."""
    return opt[p][key] if key in opt[p] else torch.zeros_like(p)


def adam_moments(opt, params):
    """Clones of each parameter's two Adam moments."""
    return [[moment(opt, p, k).detach().clone() for p in params]
            for k in ("exp_avg", "exp_avg_sq")]


def leaf_gaps(prog, ref, keep=None):
    """|prog - ref| / max(ref, median(ref)) of each kept leaf's norm."""
    keep = np.ones(len(ref), bool) if keep is None else keep
    floor = np.median(ref)
    return (np.abs(prog - ref) / np.maximum(ref, floor))[keep]


def trainer_args(run, root, seed, dev):
    from pnpflow_tpu_torch.serve import CONFIG_ROOT
    from pnpflow_tpu_torch.utils.config import load_full_config

    cfg, tr = run.config, run.traffic
    opts = {"dataset": "synthetic", "model": cfg["model"], "train": True,
            "eval": False, "dim_image": cfg["image_size"],
            "num_channels": cfg["num_channels"],
            "batch_size_train": tr["batch"], "lr": tr["lr"],
            "ema_decay": tr["ema_decay"], "ot_method": tr["ot_method"],
            "fused_norm": tr["fused_norm"], "num_epoch": 1,
            "max_iters_per_epoch": 0, "compute_metrics": False,
            "seed": seed, "output_root": root, "device": str(dev)}
    flat = [str(v) for kv in opts.items() for v in kv]
    return load_full_config(flat, root=CONFIG_ROOT)


def run(run):
    dev = torch.device(run.device)
    from pnpflow_tpu_torch.ops import _build, ot
    from pnpflow_tpu_torch.training import flow_matching as fm

    if dev.type == "cuda":
        _build.build(run.traffic["kernels"])
    ot.load_lap()
    run.phase("kernels")
    root = tempfile.mkdtemp(prefix="portbench-")
    real = fm.host_ot_pair

    def ot_pair(*a, **k):
        with record_function("portbench.ot_pair"):
            return real(*a, **k)

    # a span around the trainer's host pairing, for the trace's idle gaps
    fm.host_ot_pair = ot_pair
    try:
        _run(run, dev, root)
    finally:
        fm.host_ot_pair = real
        shutil.rmtree(root, ignore_errors=True)


def _run(run, dev, root):
    from pnpflow_tpu_torch.device import set_fp32_parity_mode
    from pnpflow_tpu_torch.training.flow_matching import FlowMatchingTrainer

    cfg, tr = run.config, run.traffic
    ref_model = run.reference().Model
    set_fp32_parity_mode()
    seed = run.subseed(0) % 2 ** 62
    args = trainer_args(run, root, seed, dev)
    model = None
    if run.control == "reference-tf32":
        # the control: the reference in the program's place, in TF32
        model = ref_model(cfg)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    trainer = FlowMatchingTrainer(args, model=model, device=dev)
    with torch.device("meta"):
        shapes = {n: tuple(p.shape)
                  for n, p in ref_model(cfg).named_parameters()}
    if {n: tuple(p.shape) for n, p in trainer.model.named_parameters()
            } != shapes:
        raise RuntimeError("the trainer's model differs from the "
                           "configuration")
    # the resume point and the checkpoints, written after the window
    trainer.save_state = trainer.save_preemption = lambda *a, **k: None
    trainer._save_sample_plot = lambda *a, **k: None
    run.phase("trainer")

    warm = int(tr["warmup_steps"])
    # the window's step that the check replays
    probe = warm + 1 + run.subseed(4) % int(tr["probe_span"])
    gen = torch.Generator(device=dev).manual_seed(run.subseed(1))
    n = tr["batch"] * tr["pool_batches"]
    pool = Pool(inputs.clean_images(gen, n, cfg["image_size"],
                                    cfg["num_channels"], dev).cpu().numpy(),
                tr["batch"], run.subseed(2), keep=probe)
    run.phase("pool")
    seen = {"n": 0, "end": None}
    prof = Profiled(run.traced)
    inner = trainer.train_step
    params = list(trainer.model.parameters())

    def step(state, *a, **k):
        seen["n"] += 1
        i = seen["n"]
        opt = state.optimizer.state
        if i == 1:
            seen["p0"] = [p.detach().clone() for p in params]
        if i == probe:
            # the program's state before the replayed step, on the card
            seen["before"] = {
                "params": [p.detach().clone() for p in params],
                "moments": adam_moments(opt, params),
                "ema": [state.ema[nm].clone() for nm in trainer.names]}
        with record_function("portbench.train_step"):
            loss = inner(state, *a, **k)
        if i <= warm:
            run.phase(f"step {i}")
        if i == 1:
            seen["grad"] = leaf_norms([moment(opt, p, "exp_avg") / 0.1
                                       for p in params])
        if i == CHECKED:
            seen["change"] = leaf_norms(
                [p.detach() - q for p, q in zip(params, seen["p0"])])
            seen["ema"] = leaf_norms(
                [state.ema[nm] - q for nm, q in zip(trainer.names,
                                                    seen["p0"])])
            del seen["p0"]
        if i == probe:
            b = seen["before"]
            seen["window"] = {
                "grad": leaf_norms([(moment(opt, p, "exp_avg") - 0.9 * m0)
                                    / 0.1 for p, m0 in
                                    zip(params, b["moments"][0])]),
                "change": leaf_norms([p.detach() - q for p, q in
                                      zip(params, b["params"])]),
                "ema": leaf_norms([state.ema[nm] - q for nm, q in
                                   zip(trainer.names, b["ema"])])}
        if i == warm:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seen["peak0"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
            run.window_opened()
            seen["counts"] = port.launch_counts(tr["counters"])
            prof.__enter__()
            seen["t0"] = time.perf_counter()
            seen["deadline"] = seen["t0"] + run.seconds
        elif i >= probe and seen["end"] is None \
                and time.perf_counter() >= seen["deadline"]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seen["end"] = time.perf_counter()
            seen["steps"] = i - warm
            prof.__exit__(None, None, None)
            seen["launches"] = port.since(tr["counters"], seen["counts"])
            pool.stop.set()
        return loss

    trainer.train_step = step
    trainer.train({"train": pool})
    if seen["end"] is None:
        raise RuntimeError("the loader ended before the window did")
    stats = trainer.stats
    window = seen["end"] - seen["t0"]
    run.rate[tr["rate_metric"]] = tr["batch"] * seen["steps"] / window
    run.trace = prof.trace
    run.attempted = seen["n"]
    run.peak_bytes = max(seen["peak0"], stats.get("max_memory_allocated", 0))
    pairs = stats["pair_seconds"][warm:warm + seen["steps"]]
    run.facts.update(train_steps=seen["steps"], window_s=window,
                     images_per_step=tr["batch"],
                     launches=seen["launches"], probe=probe,
                     ot_pair_s=float(np.mean(pairs)) if pairs else None)
    losses = stats["losses"]
    rows = pool.issued
    del trainer, step, inner, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    check(run, dev, seed, pool.images, rows, losses, seen)
    run.facts["check_s"] = time.perf_counter() - t


def numpy(norms):
    return norms.cpu().numpy()


def compare(run, prefix, prog, grad, change, ema):
    """The median-leaf gaps of one step's gradient and of one stretch's
    change of the parameters and of the EMA; leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the changes."""
    grad, change, ema = numpy(grad), numpy(change), numpy(ema)
    moved = grad >= 1e-3 * np.median(grad)
    gaps = {"grad": leaf_gaps(numpy(prog["grad"]), grad),
            "change": leaf_gaps(numpy(prog["change"]), change, moved),
            "ema": leaf_gaps(numpy(prog["ema"]), ema, moved)}
    # the median leaf: the worst one is a bias ahead of a GroupNorm of one
    # channel a group, whose gradient is nought and reads rounding alone
    for key, g in gaps.items():
        run.check(f"{prefix}{key}_gap", float(np.median(g)))
    run.facts[f"{prefix}worst_leaf"] = {k: float(g.max())
                                        for k, g in gaps.items()}


def loss_gap(prog, ref):
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def check(run, dev, seed, images, rows, losses, seen):
    cfg, tr = run.config, run.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = run.reference()
    model = arch.Model(cfg).to(dev)
    arch.init_vs(model, seed)
    p0 = [p.detach().clone() for p in model.parameters()]
    ref = ref_train.Trainer(model, seed, dev, tr["lr"], tr["ema_decay"],
                            tr["ref_rows"])
    ref_losses = []
    for k in range(CHECKED):
        loss, grads = ref.step(images[rows[k]])
        ref_losses.append(loss)
        if k == 0:
            grad = leaf_norms(grads)
    run.check("loss_gap", loss_gap(losses[:CHECKED], ref_losses))
    compare(run, "", seen, grad,
            leaf_norms([p.detach() - q for p, q in zip(ref.params, p0)]),
            leaf_norms([e - q for e, q in zip(ref.ema, p0)]))
    del p0, grads

    # one step of the window, from the program's state before it
    probe = run.facts["probe"]
    b = seen.pop("before")
    ref = ref_train.Trainer(model, seed, dev, tr["lr"], tr["ema_decay"],
                            tr["ref_rows"])
    ref.skip(probe - 1, images[rows[0]].shape)
    ref.load(b["params"], *b["moments"], b["ema"])
    loss, grads = ref.step(images[rows[probe - 1]])
    run.check("window_loss_gap", loss_gap(losses[probe - 1:probe], [loss]))
    compare(run, "window_", seen["window"], leaf_norms(grads),
            leaf_norms([p.detach() - q for p, q in
                        zip(ref.params, b["params"])]),
            leaf_norms([e - q for e, q in zip(ref.ema, b["ema"])]))
    run.failed = sum(not v <= lim for v, lim in run.checks.values())
