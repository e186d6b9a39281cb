"""Flow-matching trainer (port of ``pnpflow_tpu/training/flow_matching.py``).

The reference ``FLOW_MATCHING`` trainer (train_flow_matching.py:40-264), as
the JAX package redesigned it:

  * per-batch minibatch-OT coupling (``model ot``) or independent coupling
    (``model indep``): exact OT on the host between steps (the C++
    assignment solver, ``ops/ot.py``), or Sinkhorn on the device;
  * x_t = t x1 + (1 - t) x0 and the loss sum((v - (x1 - x0))^2) / B;
  * Adam with optax's defaults (betas 0.9 / 0.999, eps 1e-8, no weight
    decay) and a fixed-decay EMA of the parameters, d e + (1 - d) p;
  * checkpoints every ``save_every`` epochs and at the end, and a full
    resume state, all in the JAX package's msgpack layout, so a checkpoint
    or a resume state written by either package is read by the other;
  * ``max_iters_per_epoch`` (default 21, the reference's
    ``iteration > 20: break``).

The model is the port's U-Net in float32 with ``fused_norm`` from the
arguments, ``True`` by default: every GroupNorm through the
``groupnorm_swish`` kernel, whose backward is the plain copy of the JAX
VJP.  ``"conv"`` is forward-only and refused.

The steps take ``t`` and ``x0`` as arguments or draw them from explicit
``torch.Generator``s, so a test can hand both packages the same ones.
``apply_flow_matching`` samples by Euler or by adaptive dopri5 at rtol =
atol = 1e-5.  Under ``compute_metrics`` every ``save_every`` epoch appends
an ``epoch fid`` row to ``FID_5k.txt``: the EMA weights, Euler in 10 steps,
5000 samples (``_fid_checkpoint``).  Where JAX prints "FID checkpoint
skipped" on any error, the port lets it propagate: a swallowed failure
would hide a broken metric path.

Data parallelism (``parallel/mesh.py``): under ``torchrun --nproc_per_node
N -m pnpflow_tpu_torch --opts train True ...`` each rank is one process on
one card.  The coupling stays global, as in JAX's single-controller step:
every rank loads the same global batch (the loaders are seeded), draws x0
and t for the whole of it from the same seeded generators, pairs it (the
exact OT on the host or Sinkhorn on its card, the same pairs on every rank)
and keeps only its :func:`~pnpflow_tpu_torch.parallel.mesh.
process_batch_slice` of the pairs.  Its loss is normalised by the global
batch, so the ranks' gradients summed by ``all_reduce_grads`` are the
full-batch gradient and every rank takes the same Adam and EMA step; the
logged loss is the all-reduced one.  Rank 0 alone writes
``loss_training.txt``, the checkpoints, the resume state and ``FID_5k.txt``;
the others meet it at a barrier at the end.

The resume state goes through one checkpointer
(``training/checkpoint.py``): by default
:class:`~pnpflow_tpu_torch.training.checkpoint.FileCheckpointer`, the single
``train_state.msgpack``; under ``ckpt_backend orbax``
:class:`~pnpflow_tpu_torch.training.checkpoint.OrbaxCheckpointer`, versioned
step directories under ``model_dir/orbax`` written asynchronously.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from pnpflow_tpu_torch.data.prefetch import prefetch, to_device
from pnpflow_tpu_torch.metrics.generative import ComputeMetric
from pnpflow_tpu_torch.models.registry import (
    checked_state_dict, define_model, model_fingerprint, save_params_file)
from pnpflow_tpu_torch.models.unet import init_weights
from pnpflow_tpu_torch.ops.ode import odeint_dopri5
from pnpflow_tpu_torch.ops.ot import host_ot_pair, ot_pair_indices
from pnpflow_tpu_torch.parallel import mesh
from pnpflow_tpu_torch.solvers.base import ModelBundle
from pnpflow_tpu_torch.training.checkpoint import (
    FileCheckpointer, OrbaxCheckpointer)
from pnpflow_tpu_torch.utils.jax_params import (
    adam_state_dict_from_flax, flax_adam_state, flax_from_state_dict,
    state_dict_from_flax)

STATE_KEYS = {"params", "opt_state", "ema", "step"}


@dataclass
class TrainState:
    """What a train step updates: the model's parameters (in place), its
    Adam state, the EMA (name -> tensor, the model's layout) and the
    count of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Adam
    ema: dict
    step: int = 0


def new_state(model: nn.Module, lr: float) -> TrainState:
    """A fresh state around ``model``'s current parameters: Adam with
    optax's defaults, the EMA starting at the parameters."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=0.0)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model, opt, ema, 0)


def make_fm_loss(model: nn.Module, remat: bool = False):
    """Flow-matching loss ``(x0, x1, t, batch=None) -> sum((v - (x1 -
    x0))^2) / batch`` on an already-coupled pair batch; ``batch`` is x1's
    unless given (a rank's rows are normalised by the global batch).
    ``remat`` recomputes the model's activations in the backward
    (non-reentrant ``torch.utils.checkpoint``), as ``jax.checkpoint``
    does, trading a forward for memory."""

    def apply(xt, t):
        if remat:
            return checkpoint(model, xt, t, use_reentrant=False)
        return model(xt, t)

    def loss_fn(x0, x1, t, batch=None):
        tb = t[:, None, None, None]
        xt = tb * x1 + (1.0 - tb) * x0
        v = apply(xt, t)
        # the reference normalizes by the batch size only
        return ((v - (x1 - x0)) ** 2).sum() / (batch or x1.shape[0])

    return loss_fn


@torch.no_grad()
def ema_step(ema: list, params: list, decay: float):
    """``e = d e + (1 - d) p`` over lists of tensors, as the JAX step."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))


def apply_updates(state: TrainState, loss: torch.Tensor, ema_decay: float):
    """Backward, the gradients summed over the ranks (under a process
    group), one Adam step, the EMA, the step count; returns the loss summed
    over the ranks, detached and left on its device."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mesh.all_reduce_grads(state.model.parameters())
    state.optimizer.step()
    named = list(state.model.named_parameters())
    ema_step([state.ema[n] for n, _ in named], [p for _, p in named],
             ema_decay)
    state.step += 1
    return mesh.all_reduce_sum(loss.detach())


def local_rows(*tensors):
    """This rank's rows of each global-batch tensor (all of them without a
    process group)."""
    start, size = mesh.process_batch_slice(tensors[0].shape[0])
    return [a[start:start + size] for a in tensors]


def _uniform_t(x1, generator):
    return torch.rand(x1.shape[0], generator=generator, dtype=x1.dtype,
                      device=x1.device)


def make_fm_train_step(*, coupling: str = "ot", ema_decay: float = 0.999,
                       ot_method: str = "sinkhorn", remat: bool = False):
    """The step ``(state, x1, generator, x0=None, t=None) -> loss`` with the
    coupling computed inside it (``indep``, or ``ot`` by ``ot_method``).
    ``x0`` ~ N(0, I) and ``t`` ~ U[0, 1) come from ``generator`` (on x1's
    device) unless given.  ``x1`` is the global batch: under a process
    group every rank couples all of it and trains on its rows."""

    def train_step(state, x1, generator, x0=None, t=None):
        batch = x1.shape[0]
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                             device=x1.device)
        if t is None:
            t = _uniform_t(x1, generator)
        if coupling == "ot":
            i0, i1 = ot_pair_indices(x0, x1, generator, method=ot_method)
            x0, x1 = x0[i0], x1[i1]
        x0, x1, t = local_rows(x0, x1, t)
        loss = make_fm_loss(state.model, remat)(x0, x1, t, batch)
        return apply_updates(state, loss, ema_decay)

    return train_step


def make_fm_train_step_precoupled(*, ema_decay: float = 0.999,
                                  remat: bool = False):
    """The step ``(state, x0, x1, generator=None, t=None) -> loss`` for
    already-coupled pairs (the host-side exact OT pairing) of the global
    batch; ``t`` ~ U[0, 1) comes from ``generator`` unless given.  Under a
    process group each rank trains on its rows."""

    def train_step(state, x0, x1, generator=None, t=None):
        batch = x1.shape[0]
        if t is None:
            t = _uniform_t(x1, generator)
        x0, x1, t = local_rows(x0, x1, t)
        loss = make_fm_loss(state.model, remat)(x0, x1, t, batch)
        return apply_updates(state, loss, ema_decay)

    return train_step


def _normal(shape, generator, device, noise):
    if noise is not None:
        return torch.tensor(np.asarray(noise), dtype=torch.float32,
                            device=device)
    return torch.randn(shape, generator=generator, device=device)


@torch.no_grad()
def euler_sample(model, shape, steps: int = 100, generator=None,
                 noise=None, device=None):
    """Euler integration of dx/dt = v(x, t) from t = 0 (noise) to 1.  The
    starting noise is ``noise`` if given, else drawn from ``generator``."""
    x = _normal(shape, generator, device, noise)
    dt = 1.0 / steps
    for i in range(steps):
        t = torch.full((shape[0],), float(np.float32(i) * np.float32(dt)),
                       device=x.device)
        x = x + dt * model(x, t)
    return x


@torch.no_grad()
def euler_sample_stochastic(model, shape, steps: int = 100,
                            sigma_var: float = 0.0, noise_scale: float = 1.0,
                            eps: float = 1e-3, generator=None, noise=None,
                            step_noise=None, device=None):
    """Stochastic Euler: the flow ODE as a diffusion with the same marginals,
    sigma_t = (1 - t) sigma_var; ``sigma_var = 0`` is plain Euler over t in
    [eps, 1].  ``noise`` (the start, before ``noise_scale``) and
    ``step_noise`` (``steps`` draws of ``shape``) replace the draws from
    ``generator``."""
    x = noise_scale * _normal(shape, generator, device, noise)
    return euler_stochastic_from(model, x, steps, sigma_var, noise_scale,
                                 eps, generator, step_noise)


@torch.no_grad()
def euler_stochastic_from(model, x, steps: int = 100, sigma_var: float = 0.0,
                          noise_scale: float = 1.0, eps: float = 1e-3,
                          generator=None, step_noise=None):
    """:func:`euler_sample_stochastic`'s integration from a given start
    ``x``; ``noise_scale`` still sets the drift's correction."""
    shape = tuple(x.shape)
    dt = 1.0 / steps
    # the scalars in float32, operation by operation, as the JAX sampler
    # computes them
    f32 = np.float32
    for i in range(steps):
        num_t = f32(i) / f32(steps) * f32(1.0 - eps) + f32(eps)
        one_m = f32(1.0) - num_t
        sigma_t = one_m * f32(sigma_var)
        coef = sigma_t ** 2 / (f32(2.0 * noise_scale ** 2) * one_m ** 2)
        pred = model(x, torch.full((shape[0],), float(num_t),
                                   device=x.device))
        pred_sigma = pred + float(coef) * (
            float(f32(0.5) * num_t * one_m) * pred
            - float(f32(0.5) * (f32(2.0) - num_t)) * x)
        z = _normal(shape, generator, x.device,
                    None if step_noise is None else step_noise[i])
        x = x + pred_sigma * dt + float(sigma_t * np.sqrt(f32(dt))) * z
    return x


class _StepClock:
    """Seconds between the ends of consecutive train steps as the device
    sees them.  On a CUDA device an event is recorded on the stream after
    each step, without synchronising, and read when the epoch's losses
    are; on the CPU the host clock is read."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list:
        """The step times since the first mark; clears the marks."""
        m, self.marks = self.marks, []
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


class FlowMatchingTrainer:
    """The reference-compatible trainer (train_flow_matching.py:40-249) on
    ``args.device`` (default ``cuda``), one card per rank under a process
    group (see the module's notes)."""

    def __init__(self, args, model=None, device=None):
        backend = getattr(args, "ckpt_backend", "msgpack")
        if backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown ckpt_backend {backend!r}: msgpack or "
                             "orbax")
        self.args = args
        self.device = mesh.rank_device(
            getattr(args, "device", None) if device is None else device)
        self.model = (model if model is not None
                      else define_model(args, train=True)).to(self.device)
        self.names = [n for n, _ in self.model.named_parameters()]
        if self.names != list(self.model.state_dict()):
            raise ValueError("the trainer needs a model whose state_dict is "
                             "its parameters (no buffers)")
        self.coupling = "ot" if args.model == "ot" else "indep"
        self.lr = float(args.lr)
        self.num_epoch = int(args.num_epoch)
        self.save_every = int(getattr(args, "save_every", 50) or 50)
        # the reference breaks after 21 iterations an epoch
        self.max_iters_per_epoch = int(
            getattr(args, "max_iters_per_epoch", 21) or -1)
        self.ema_decay = float(getattr(args, "ema_decay", 0.999) or 0.999)
        self.model_dir = os.path.join(args.output_root, "model",
                                      args.dataset, args.model)
        os.makedirs(self.model_dir, exist_ok=True)
        self.checkpointer = (
            OrbaxCheckpointer(os.path.join(self.model_dir, "orbax"))
            if backend == "orbax" else FileCheckpointer(self._state_path()))
        self.ot_method = getattr(args, "ot_method", "exact") or "exact"
        self.precoupled = self.coupling == "ot" and self.ot_method == "exact"
        remat = bool(getattr(args, "remat", False))
        if self.precoupled:
            self.train_step = make_fm_train_step_precoupled(
                ema_decay=self.ema_decay, remat=remat)
        else:
            self.train_step = make_fm_train_step(
                coupling=self.coupling, ema_decay=self.ema_decay,
                ot_method=self.ot_method, remat=remat)
        # what the last train() measured: device seconds per step, host
        # seconds of the exact OT pairing per step, the losses
        self.stats = {"step_seconds": [], "pair_seconds": [], "losses": []}

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """Seeded init of the model's parameters, fresh Adam and EMA."""
        init_weights(self.model, seed)
        return new_state(self.model, self.lr)

    def _state_path(self):
        return os.path.join(self.model_dir, "train_state.msgpack")

    def save_preemption(self, state, epochs_done: int = 0):
        """The resume point, in the JAX trainer's layout (``params``,
        ``opt_state``, ``ema``, ``step``, ``epochs_done``), tagged with the
        number of completed epochs and handed to the checkpointer.  Rank 0
        alone writes."""
        if not mesh.is_writer():
            return
        self.checkpointer.save({
            "params": flax_from_state_dict(
                dict(state.model.named_parameters())),
            "opt_state": flax_adam_state(state.optimizer, self.names),
            "ema": flax_from_state_dict(state.ema),
            "step": np.array(state.step, np.int32)}, epochs_done)

    def save_state(self, state, epoch=None, epochs_done: int = 0):
        """The resume point, then ``model_{epoch}`` / ``ema_model_{epoch}``
        (``_final`` without an epoch) with the architecture fingerprint.
        Rank 0 alone writes."""
        if not mesh.is_writer():
            return
        self.save_preemption(state, epochs_done)
        name = ("model_final.msgpack" if epoch is None
                else f"model_{epoch}.msgpack")
        fp = model_fingerprint(self.model, self.args)
        for params, fname in ((dict(state.model.named_parameters()), name),
                              (state.ema, "ema_" + name)):
            save_params_file(flax_from_state_dict(params),
                             os.path.join(self.model_dir, fname),
                             fingerprint=fp)

    def restore_state(self, state):
        """-> (state, epochs_done, resumed), from the checkpointer's newest
        resume state.  One that cannot be read or does not fit the model is
        ignored with a warning, and the state is left as it was."""
        try:
            tree, epochs_done, resumed = self.checkpointer.restore_latest()
            if not resumed:
                return state, 0, False
            if set(tree) != STATE_KEYS:
                raise ValueError(f"keys {sorted(tree)}")
            params = checked_state_dict(
                self.model, state_dict_from_flax(tree["params"]))
            ema = checked_state_dict(self.model,
                                     state_dict_from_flax(tree["ema"]))
            opt = adam_state_dict_from_flax(tree["opt_state"],
                                            state.optimizer, self.names)
            step = int(tree["step"])
        except (KeyError, ValueError, TypeError) as exc:
            warnings.warn(f"Ignoring incompatible resume state at "
                          f"{self.checkpointer.path} ({exc})")
            return state, 0, False
        state.model.load_state_dict(params)
        state.optimizer.load_state_dict(opt)
        state.ema = {n: ema[n].to(self.device) for n in self.names}
        state.step = step
        return state, epochs_done, True

    # -- loop ----------------------------------------------------------------
    def train(self, data_loaders):
        args = self.args
        seed = int(getattr(args, "seed", 0) or 0)
        dev = self.device
        # exact OT pairs on the host, so only the other couplings take the
        # batch to the device in the prefetch thread
        train_loader = prefetch(data_loaders["train"],
                                device=None if self.precoupled else dev)
        state = self.init_state(seed)
        state, start_epoch, resumed = self.restore_state(state)
        if resumed:
            print(f"Resumed from step {state.step} (epoch {start_epoch})")
            if start_epoch >= self.num_epoch:
                print(f"Training already complete ({start_epoch} epochs); "
                      f"delete {self.checkpointer.path} to retrain from "
                      f"scratch.")
                return state

        writer = mesh.is_writer()
        loss_file = os.path.join(self.model_dir, "loss_training.txt")
        n_params = sum(p.numel() for p in state.model.parameters())
        if writer:
            with open(os.path.join(self.model_dir, "model_info.txt"),
                      "w") as f:
                f.write(f"num_params {n_params}\n")

        gen = torch.Generator(device=dev).manual_seed(seed + start_epoch)
        host_rng = np.random.default_rng(seed + start_epoch)
        clock = _StepClock(dev)
        self.stats = {"step_seconds": [], "pair_seconds": [], "losses": []}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for epoch in range(start_epoch, self.num_epoch):
            t_ep = time.perf_counter()
            losses = []
            for iteration, (x1, _) in enumerate(train_loader):
                if (self.max_iters_per_epoch > 0
                        and iteration > self.max_iters_per_epoch - 1):
                    break
                if iteration == 0:
                    clock.mark()
                self._last_batch = x1
                if self.precoupled:
                    x1 = np.asarray(x1, dtype=np.float32)
                    t0 = time.perf_counter()
                    x0 = host_rng.standard_normal(x1.shape, dtype=np.float32)
                    i0, i1 = host_ot_pair(x0, x1, host_rng)
                    self.stats["pair_seconds"].append(
                        time.perf_counter() - t0)
                    loss = self.train_step(state, to_device(x0[i0], dev),
                                           to_device(x1[i1], dev), gen)
                else:
                    loss = self.train_step(state, x1, gen)
                losses.append(loss)
                clock.mark()
            losses = torch.stack(losses).tolist() if losses else []
            self.stats["step_seconds"] += clock.seconds()
            self.stats["losses"] += losses
            if writer:
                with open(loss_file, "a") as f:
                    f.writelines(f"{v}\n" for v in losses)
            epoch_s = time.perf_counter() - t_ep
            print("epoch {} loss {:.4f} ({:.2f}s)".format(
                epoch, float(np.mean(losses)) if losses else float("nan"),
                epoch_s))
            # the resume point: "auto" writes once the compute since the
            # last write reaches the measured cost of one write, so slow
            # storage costs at most about half the wall time; an integer
            # preempt_every writes every N epochs
            preempt_every = getattr(args, "preempt_every", "auto") or "auto"
            if str(preempt_every) == "auto":
                self._compute_since_write = (
                    getattr(self, "_compute_since_write", 0.0) + epoch_s)
                if self._compute_since_write >= getattr(
                        self, "_resume_write_s", 0.0):
                    t_w = time.perf_counter()
                    self.save_preemption(state, epochs_done=epoch + 1)
                    self._resume_write_s = time.perf_counter() - t_w
                    self._compute_since_write = 0.0
            elif (epoch + 1) % int(preempt_every) == 0:
                self.save_preemption(state, epochs_done=epoch + 1)
            if epoch % self.save_every == 0:
                self.save_state(state, epoch, epochs_done=epoch + 1)
                if writer:
                    self._save_sample_plot(state, epoch)
                    self._fid_checkpoint(state, epoch, data_loaders)
        self.save_state(state, epochs_done=self.num_epoch)
        self.checkpointer.wait_until_finished()
        # the other ranks return once rank 0 has written the final files
        mesh.barrier()
        if dev.type == "cuda":
            self.stats["max_memory_allocated"] = \
                torch.cuda.max_memory_allocated(dev)
        return state

    # -- sampling ------------------------------------------------------------
    @contextlib.contextmanager
    def _weights(self, state, use_ema: bool = True):
        """The model with the EMA in its parameters (``use_ema``) for the
        duration, the trained ones restored after."""
        if not use_ema:
            yield state.model
            return
        params = [p for _, p in state.model.named_parameters()]
        kept = [p.detach().clone() for p in params]
        with torch.no_grad():
            torch._foreach_copy_(params, [state.ema[n] for n in self.names])
        try:
            yield state.model
        finally:
            with torch.no_grad():
                torch._foreach_copy_(params, kept)

    def apply_flow_matching(self, state, n: int, generator=None,
                            steps: int = 100, use_ema: bool = True,
                            method: str = "euler", z=None):
        """Sample n images by integrating the flow from noise, with the EMA
        weights (``use_ema``) or the trained ones: ``method "euler"`` in
        ``steps`` fixed steps, ``"dopri5"`` adaptively at rtol = atol =
        1e-5, as the reference's odeint (train_flow_matching.py:131-150).
        The start is ``z`` if given, else drawn from ``generator``."""
        if method not in ("euler", "dopri5"):
            raise ValueError(f"unknown sampler {method!r}: euler or dopri5")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        dim, c = self.args.dim_image, self.args.num_channels
        shape = (n, dim, dim, c)
        with self._weights(state, use_ema) as model:
            if method == "euler":
                return euler_sample(model, shape, steps=steps,
                                    generator=generator, noise=z,
                                    device=self.device)
            x = _normal(shape, generator, self.device, z)

            def vfield(x, t):
                return model(x, torch.full((x.shape[0],), t,
                                           dtype=torch.float32,
                                           device=x.device))

            with torch.no_grad():
                return odeint_dopri5(vfield, x, 0.0, 1.0, rtol=1e-5,
                                     atol=1e-5)

    def _fid_checkpoint(self, state, epoch, data_loaders, n: int = 5000):
        """The FID-5k training curve (reference train_flow_matching.py:
        117-129): n samples of the EMA weights by Euler in 10 steps, scored
        against the test split (the train split where there is none), one
        ``epoch fid`` row appended to ``FID_5k.txt``.  Runs only under
        ``compute_metrics``; an error propagates.  The generated chunks are
        not cached: each call scores new weights, so none could be read
        again.  Returns the metrics."""
        args = self.args
        if not getattr(args, "compute_metrics", False):
            return None
        if not getattr(args, "eval_split", None):
            args.eval_split = "test"
        split = args.eval_split
        test = data_loaders.get(split) or data_loaders.get("train")
        with self._weights(state) as model:
            out = ComputeMetric(
                {split: test},
                ModelBundle(model=model, device=self.device, kind=args.model),
                args).compute_metrics(n, steps=10, sampler="euler",
                                      cache=False)
        with open(os.path.join(self.model_dir, "FID_5k.txt"), "a") as f:
            f.write("{} {}\n".format(epoch, out["fid"]))
        return out

    def _save_sample_plot(self, state, epoch):
        """Model samples beside training samples (reference save_samples,
        utils.py:399-430); skipped without matplotlib, as in JAX."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        samples = self.apply_flow_matching(state, 16, steps=10).cpu().numpy()
        samples = np.clip((samples + 1.0) / 2.0, 0, 1)
        train = getattr(self, "_last_batch", None)
        if isinstance(train, torch.Tensor):
            train = train.cpu().numpy()
        ncols = 8 if train is not None else 4
        fig, axes = plt.subplots(4, ncols, figsize=(1.5 * ncols, 6))
        for i in range(16):
            r, c = i % 4, i // 4
            img = samples[i]
            axes[r][c].imshow(img[..., 0] if img.shape[-1] == 1 else img,
                              cmap="gray")
            axes[r][c].axis("off")
            if train is not None and i < len(train):
                timg = np.clip((train[i] + 1.0) / 2.0, 0, 1)
                axes[r][c + 4].imshow(
                    timg[..., 0] if timg.shape[-1] == 1 else timg,
                    cmap="gray")
            if train is not None:
                axes[r][c + 4].axis("off")
        fig.suptitle("model samples | training samples")
        fig.savefig(os.path.join(self.model_dir, f"samples_{epoch}.png"))
        plt.close(fig)
