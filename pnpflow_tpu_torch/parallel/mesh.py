"""Data parallelism over several cards (port of ``pnpflow_tpu/parallel/mesh.py``).

JAX's mesh is single-controller: one program holds the global batch, the
batch dimension is sharded over the chips and XLA inserts the collectives.
PyTorch's idiom is one process per card, so the port has two forms, one per
use the JAX package makes of its mesh:

(a) **The trainers**, one process per card, as ``torchrun`` launches them.
    :func:`init_distributed` reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
    and ``MASTER_PORT`` and brings up the default process group (NCCL on
    the card, gloo on the CPU); without them it does nothing, as JAX's does
    on a single host.  Every rank holds the same parameters and sees the
    same global batch; :func:`process_batch_slice` names its rows.  Each
    rank normalises its loss by the global batch, so the sum of the ranks'
    gradients, :func:`all_reduce_grads`, is the full-batch gradient that
    JAX's psum gives, and every rank takes the same Adam step.
(b) **Inference fan-out** inside one process over a list of devices
    (sharded serving, metric sampling, the Inception chunker):
    :func:`devices`, :func:`replicate`, :func:`shard_batch`, :func:`gather`
    and :func:`fan_out`, which runs one thread per device so that the
    shards run at the same time.
(c) **One solver, its network fanned out**: :class:`ShardedModel` splits
    each forward's batch over the devices and runs a replica on each, with
    no thread, so that a solver whose steps couple the batch's images (a
    line search, a backtracking, GMRES) stays one solver on the first
    device, as JAX's ``jit`` keeps those decisions global when it shards
    the batch.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from pnpflow_tpu_torch.device import resolve_device

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# rank 0 alone scores the FID curve and writes the checkpoints while the
# other ranks wait in their next collective: NCCL's default 10 minutes is
# shorter than a FID at n 5000
TIMEOUT = datetime.timedelta(hours=2)


# ---------------------------------------------------------------------------
# (a) one process per card


def is_distributed() -> bool:
    """Whether a default process group is up."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(device=None) -> bool:
    """Bring up the default process group from ``torchrun``'s environment
    (idempotent); returns :func:`is_distributed`.  ``device`` (``cuda``
    unless asked otherwise) picks the backend: NCCL on the card, each rank
    on the card ``LOCAL_RANK`` names, gloo on the CPU.  Without the
    environment it does nothing and the run is one process."""
    if is_distributed():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", timeout=TIMEOUT,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def rank_device(device=None) -> torch.device:
    """``device`` (``cuda`` unless asked otherwise) with its index: under
    a process group, the card ``LOCAL_RANK`` names, which
    :func:`init_distributed` made current; otherwise the current card.  A
    bare ``cuda`` means card 0 in any thread that did not set its own, such
    as a prefetch thread, so a rank's work names its card."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if is_distributed():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cuda", torch.cuda.current_device())


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_writer() -> bool:
    """Rank 0 writes the files; one process is rank 0."""
    return rank() == 0


def barrier():
    if is_distributed():
        dist.barrier()


def process_batch_slice(global_batch: int) -> tuple[int, int]:
    """``(start, size)`` of this rank's rows of the global batch; one
    process: the whole batch."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"the global batch of {global_batch} does not "
                         f"divide over {n} ranks")
    per = global_batch // n
    return rank() * per, per


def all_reduce_grads(params) -> None:
    """Sum every parameter's gradient over the ranks, in place: one flat
    buffer in the parameters' order (a missing gradient counts as zeros),
    one all-reduce.  A no-op without a process group."""
    if not is_distributed():
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor); ``t`` itself without
    a process group."""
    if not is_distributed():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


# ---------------------------------------------------------------------------
# (b) fan-out over the devices of one process


def devices(n=None, device=None) -> list:
    """The first ``n`` devices of ``device``'s kind (all of them by
    default): the visible cards, or the one CPU.  More than are visible
    raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device("cpu")]
    n = len(visible) if n is None else int(n)
    if not 1 <= n <= len(visible):
        raise ValueError(f"n_devices {n}: {len(visible)} {dev.type} "
                         f"device(s) visible")
    return visible[:n]


def replicate(module: torch.nn.Module, devs) -> list:
    """One copy of ``module`` per device; the module itself serves the
    first device where it already lies there."""
    out = []
    for i, d in enumerate(devs):
        p = next(iter(module.parameters()), None)
        here = p is None or p.device == torch.device(d)
        out.append(module if i == 0 and here
                   else copy.deepcopy(module).to(d))
    return out


def batch_rows(batch: int, n: int) -> list:
    """``(start, stop)`` of each of ``n`` equal shards of ``batch`` rows."""
    if batch % n:
        raise ValueError(f"a batch of {batch} does not divide over {n} "
                         f"devices")
    per = batch // n
    return [(i * per, (i + 1) * per) for i in range(n)]


def shard_batch(x: torch.Tensor, devs) -> list:
    """``x`` split along its first dimension into equal shards, one on each
    device; a batch that does not divide raises."""
    return [x[a:b].to(d, non_blocking=True)
            for (a, b), d in zip(batch_rows(x.shape[0], len(devs)), devs)]


def gather(parts, device) -> torch.Tensor:
    """The shards concatenated on ``device``."""
    return torch.cat([p.to(device) for p in parts])


def on(device):
    """A context that makes ``device`` the current card (nothing on the
    CPU), for work run in a :func:`fan_out` thread."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def fan_out(fn, items, threads: bool = True) -> list:
    """``[fn(i, item) ...]`` with one thread per item, so that shards on
    several cards run at the same time; one item, or ``threads=False``,
    runs in this thread, one item after the other (forward-mode autodiff
    keeps its dual levels in process-wide state, so two threads must not
    take JVPs at once).  A shard's exception is raised here."""
    items = list(items)
    if len(items) == 1 or not threads:
        return [fn(i, it) for i, it in enumerate(items)]
    with ThreadPoolExecutor(max_workers=len(items)) as pool:
        futures = [pool.submit(fn, i, it) for i, it in enumerate(items)]
        return [f.result() for f in futures]


# ---------------------------------------------------------------------------
# (c) one solver, its network fanned out


class ShardedModel(torch.nn.Module):
    """``forward(x, t)`` of a per-image network with the batch split over
    ``devices``: shard k's rows of x (and of t where t has a batch
    dimension) are copied to card k (``non_blocking``), run through
    ``replicas[k]`` there, and the outputs are concatenated on the first
    device, the home.  The network must be per image (GroupNorm per
    sample, attention over space), so the result is the whole-batch
    forward's.

    No thread: CUDA launches are asynchronous, so card k computes while
    the host issues card k+1's work, and grad mode, ``torch.func`` levels
    and forward-AD levels stay in the caller's thread.  Gradients are
    plain autograd through the copies.  Where a checkpoint encloses this
    module and its shards span cards (d_flow checkpoints each step), run
    the backward under ``torch.autograd.set_multithreading_enabled(False)``,
    as ``serve.Restorer`` does: the engine's per-card threads would
    otherwise recompute that one checkpoint from two threads at once, which
    ``torch.utils.checkpoint`` does not allow.  With ``remat``, wherever autograd records, each
    shard's replica runs under one non-reentrant ``torch.utils.checkpoint``
    on its card (``ModelBundle.grad_forward`` does not checkpoint this
    module again).  A replica whose parameters lie elsewhere than its
    device, or a batch that does not divide, raises.  ``forwards`` counts
    the calls."""

    def __init__(self, replicas, devices, remat: bool = False):
        super().__init__()
        if len(replicas) != len(devices) or not devices:
            raise ValueError(f"{len(replicas)} replicas for "
                             f"{len(devices)} devices")
        self.devices = [torch.device(d) for d in devices]
        for k, (m, d) in enumerate(zip(replicas, self.devices)):
            for p in m.parameters():
                if p.device != d:
                    raise ValueError(f"replica {k} has a parameter on "
                                     f"{p.device}, not on {d}")
        self.replicas = torch.nn.ModuleList(replicas)
        self.home = self.devices[0]
        self.remat = bool(remat)
        self.forwards = 0

    def forward(self, x, t):
        self.forwards += 1
        rows = batch_rows(x.shape[0], len(self.devices))
        per_row = t.dim() > 0 and t.shape[0] == x.shape[0]
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for (a, b), d, m in zip(rows, self.devices, self.replicas):
            xs = x[a:b].to(d, non_blocking=True)
            ts = (t[a:b] if per_row else t).to(d, non_blocking=True)
            # the kernels launch on the current card without a switch
            with on(d):
                y = (checkpoint(m, xs, ts, use_reentrant=False) if remat
                     else m(xs, ts))
            outs.append(y.to(self.home, non_blocking=True))
        return torch.cat(outs)
