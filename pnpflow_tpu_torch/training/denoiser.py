"""Gradient-step denoiser (Hurault's PnP-GS): the denoiser and its trainer.

Port of ``pnpflow_tpu/training/denoiser.py``.  The denoiser is

    D(x) = x - Dg(x),   Dg(x) = x - N(x) - J_N(x)^T (x - N(x))

with N the velocity U-Net evaluated at t = sigma; the VJP is
``torch.autograd.grad(N, x, grad_outputs=x - N)``, the upstream
``train_denoiser.py:39-57`` form.  With ``fused_norm True`` every GroupNorm
of N runs the ``groupnorm_swish`` kernel forward; its backward is plain
PyTorch, so under ``create_graph=True`` autograd records it and the trainer
differentiates it again (second order), through both N and the cotangent
x - N, as ``jax.vjp`` inside ``jax.value_and_grad`` does.

Training: sigma ~ U[0, 0.25] per step from Python's ``random.Random(seed)``
(the JAX trainer's generator, so the sigma sequence is the same), Gaussian
noise u from an explicit ``torch.Generator`` (or given), the per-image MSE,
Adam at a constant learning rate.  The reference builds a MultiStepLR
([300, 600, 900, 1200] x 0.5) and never steps it, so it trains at constant
lr, as the JAX trainer documents; ``lr_milestone_steps N`` opts in to the
x0.5 decay at N x {300, 600, 900, 1200} steps with optax's
``piecewise_constant_schedule`` boundaries (the decay applies from the
update whose count equals the boundary).  The optional Jacobian
spectral-norm penalty (``jacobian_loss_weight`` > 0; off by default) runs a
power iteration on J_Dg^T, a VJP of Dg, one order higher still, and is
differentiated through every iteration, as in JAX.  Checkpoints are the
parameters in the JAX package's msgpack envelope with the ``gradient_step``
fingerprint, so each package reads the other's.

Data parallelism (``parallel/mesh.py``), as in the flow-matching trainer:
under ``torchrun`` every rank sees the same global batch and the same
sigma, draws the noise u (and the power iteration's start) for the whole
of it from the same seeded generator, keeps its rows, and normalises its
loss and MSE by the global batch; ``all_reduce_grads`` then sums the
ranks' gradients into the full-batch gradient.  The trainer is not wrapped
in ``DistributedDataParallel``: its loss differentiates a
``torch.autograd.grad(..., create_graph=True)`` taken inside the forward,
which DDP's reducer hooks do not support.  Rank 0 alone writes.
"""

from __future__ import annotations

import os
import random as _pyrandom
from dataclasses import dataclass

import torch
import torch.nn as nn

from pnpflow_tpu_torch.data.prefetch import prefetch
from pnpflow_tpu_torch.models.registry import (
    define_model, model_fingerprint, save_params_file)
from pnpflow_tpu_torch.models.unet import init_weights
from pnpflow_tpu_torch.parallel import mesh
from pnpflow_tpu_torch.training.flow_matching import _StepClock, local_rows
from pnpflow_tpu_torch.utils.jax_params import flax_from_state_dict

LR_MILESTONES = (300, 600, 900, 1200)


def calculate_grad(model, x, sigma_vec, compute_g: bool = False,
                   create_graph: bool = False):
    """``(Dg, N[, g])`` with ``g = 0.5 * sum((x - N)^2)`` over the batch.

    Without ``create_graph`` the results carry no graph (the model's graph
    is freed by the VJP).  With it they stay differentiable with respect
    to the model's parameters and, where ``x`` requires a gradient, to x."""
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_()
        N = model(xg, sigma_vec)
        r = xg - N
        (JN,) = torch.autograd.grad(N, xg, grad_outputs=r,
                                    create_graph=create_graph)
        if not create_graph:
            N, r = N.detach(), r.detach()
        Dg = r - JN
    if compute_g:
        return Dg, N, 0.5 * (r ** 2).sum()
    return Dg, N


def denoiser_forward(model, x, sigma_vec, sigma_step: bool = False,
                     weight_Ds: float = 1.0, create_graph: bool = False):
    """``(D(x), Dg)`` with ``D(x) = x - weight_Ds [* sigma] * Dg``."""
    Dg, _ = calculate_grad(model, x, sigma_vec, create_graph=create_graph)
    if sigma_step:
        return x - weight_Ds * sigma_vec[:, None, None, None] * Dg, Dg
    return x - weight_Ds * Dg, Dg


def power_iteration(operator, x_like, v0=None, generator=None,
                    steps: int = 50):
    """Per-sample power iteration for the largest |eigenvalue| of
    ``operator``, a fixed ``steps`` (the reference's early exit is a
    static bound in JAX).  The start is ``v0`` or U[0, 1) draws from
    ``generator``."""
    def normalize(v):
        n = v.pow(2).sum(dim=(1, 2, 3), keepdim=True).sqrt()
        return v / n.clamp_min(1e-12)

    if v0 is None:
        v0 = torch.rand(x_like.shape, generator=generator,
                        device=x_like.device, dtype=x_like.dtype)
    vec = normalize(v0)
    for _ in range(steps):
        vec = normalize(operator(vec))
    new_vec = operator(vec)
    num = (vec * new_vec).sum(dim=(1, 2, 3)).abs()
    den = vec.pow(2).sum(dim=(1, 2, 3)).sqrt()
    return num / den.clamp_min(1e-12)


def jacobian_spectral_norm(model, x, sigma_vec, v0=None, generator=None,
                           steps: int = 50, create_graph: bool = False):
    """Spectral norm of d(Dg)/dx by power iteration on its transpose, each
    product a VJP of Dg (itself a VJP of the model).  With
    ``create_graph`` it is differentiable with respect to the parameters
    through every iteration."""
    with torch.enable_grad():
        z = x.detach().requires_grad_()
        Dg, _ = calculate_grad(model, z, sigma_vec, create_graph=True)

        def operator(vec):
            return torch.autograd.grad(Dg, z, grad_outputs=vec,
                                       retain_graph=True,
                                       create_graph=create_graph)[0]

        return power_iteration(operator, x, v0, generator, steps)


def milestone_lr(lr: float, milestone_steps: int, count: int) -> float:
    """The learning rate of the update after ``count`` updates: ``lr`` x
    0.5 for each boundary ``milestone_steps`` x {300, 600, 900, 1200} that
    ``count`` has reached (optax's ``piecewise_constant_schedule``);
    ``lr`` when ``milestone_steps`` is 0."""
    if milestone_steps <= 0:
        return lr
    return lr * 0.5 ** sum(count >= m * milestone_steps
                           for m in LR_MILESTONES)


@dataclass
class GSState:
    """The model (its parameters updated in place), its Adam and the count
    of updates."""
    model: nn.Module
    optimizer: torch.optim.Adam
    step: int = 0


class GradientStepTrainer:
    """The reference-compatible trainer (train_denoiser.py:162-256) on
    ``args.device`` (default ``cuda``), one card per rank under a process
    group (see the module's notes)."""

    def __init__(self, args, model=None, device=None):
        self.args = args
        self.device = mesh.rank_device(
            getattr(args, "device", None) if device is None else device)
        self.model = (model if model is not None
                      else define_model(args, train=True)).to(self.device)
        self.lr = float(args.lr)
        self.num_epoch = int(args.num_epoch)
        self.jacobian_loss_weight = float(
            getattr(args, "jacobian_loss_weight", -1) or -1)
        # "max", or anything else for "exp", as in JAX
        self.jacobian_loss_type = getattr(args, "jacobian_loss_type", "max")
        self.eps_jacobian_loss = 0.1
        self.power_iteration_steps = 50
        self.lr_milestone_steps = int(
            getattr(args, "lr_milestone_steps", 0) or 0)
        self.model_dir = os.path.join(args.output_root, "model",
                                      args.dataset, args.model)
        self.results_dir = os.path.join(args.output_root, "results",
                                        args.dataset, args.model)
        os.makedirs(self.model_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)
        self.stats = {"step_seconds": [], "losses": [], "sigmas": []}

    # -- step ----------------------------------------------------------------
    def loss_fn(self, y, sigma: float, u, v0=None, generator=None,
                batch=None):
        """``(loss, mse)`` at x = y + sigma u: the per-image MSE of D(x)
        against y, averaged, plus the Jacobian penalty when its weight is
        positive (its power iteration starts from ``v0`` or draws from
        ``generator``), and the batch MSE; both sums over y's images divided
        by ``batch`` images (y's unless given: a rank's rows are normalised
        by the global batch)."""
        batch = batch or y.shape[0]
        x = y + sigma * u
        sigma_vec = torch.full((y.shape[0],), sigma, dtype=torch.float32,
                               device=y.device)
        x_hat, _ = denoiser_forward(self.model, x, sigma_vec,
                                    create_graph=True)
        err = (x_hat - y) ** 2
        per_image = err.reshape(y.shape[0], -1).mean(dim=1)
        jw = self.jacobian_loss_weight
        if jw > 0:
            jn = jacobian_spectral_norm(
                self.model, x, sigma_vec, v0, generator,
                self.power_iteration_steps, create_graph=True)
            if self.jacobian_loss_type == "max":
                jloss = jn.clamp_min(1.0 - self.eps_jacobian_loss)
            else:
                jloss = torch.exp(jn - (1.0 + self.eps_jacobian_loss))
            per_image = per_image + jw * jloss.clamp(0.0, 1e3)
        return per_image.sum() / batch, err.sum() / (batch * err[0].numel())

    def train_step(self, state: GSState, y, sigma: float, generator=None,
                   u=None, v0=None):
        """One Adam update; returns ``(loss, psnr)``, detached and left on
        the device.  ``u`` ~ N(0, I) comes from ``generator`` unless given;
        the PSNR is the pre-update batch's against data range 2.  ``y`` is
        the global batch: under a process group each rank trains on its
        rows, and the loss and PSNR are the global batch's."""
        batch = y.shape[0]
        with torch.enable_grad():
            if u is None:
                u = torch.randn(y.shape, generator=generator,
                                dtype=y.dtype, device=y.device)
            if v0 is None and self.jacobian_loss_weight > 0:
                v0 = torch.rand(y.shape, generator=generator,
                                dtype=y.dtype, device=y.device)
            y, u = local_rows(y, u)
            if v0 is not None:
                (v0,) = local_rows(v0)
            loss, mse = self.loss_fn(y, sigma, u, v0, generator, batch)
            params = list(state.model.parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        for p, g in zip(params, grads):
            p.grad = g
        mesh.all_reduce_grads(params)
        loss = mesh.all_reduce_sum(loss.detach())
        mse = mesh.all_reduce_sum(mse.detach())
        for group in state.optimizer.param_groups:
            group["lr"] = milestone_lr(self.lr, self.lr_milestone_steps,
                                       state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        psnr = 10.0 * torch.log10(4.0 / mse.detach().clamp_min(1e-20))
        return loss.detach(), psnr

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int = 0) -> GSState:
        """Seeded init of the model's parameters and a fresh Adam with
        optax's defaults."""
        init_weights(self.model, seed)
        opt = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                               betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=0.0)
        return GSState(self.model, opt, 0)

    def save_params(self, state: GSState, name: str):
        save_params_file(
            flax_from_state_dict(dict(state.model.named_parameters())),
            os.path.join(self.model_dir, name),
            fingerprint=model_fingerprint(self.model, self.args))

    # -- loop ----------------------------------------------------------------
    def train(self, data_loaders):
        args = self.args
        seed = int(getattr(args, "seed", 0) or 0)
        dev = self.device
        state = self.init_state(seed)
        n_params = sum(p.numel() for p in state.model.parameters())
        writer = mesh.is_writer()
        if writer:
            with open(os.path.join(self.results_dir, "model_info.txt"),
                      "w") as f:
                f.write("PARAMETERS\n")
                f.write("Number of parameters: {}\n".format(n_params))
                f.write("Number of epochs: {}\n".format(args.num_epoch))
                f.write("Batch size: {}\n".format(args.batch_size_train))
                f.write("Learning rate: {}\n".format(self.lr))

        train_loader = prefetch(data_loaders["train"], device=dev)
        rng = _pyrandom.Random(seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        loss_file = os.path.join(self.results_dir, "loss_training.txt")
        epoch_file = os.path.join(self.results_dir,
                                  "losses_gradient_step.txt")
        clock = _StepClock(dev)
        self.stats = {"step_seconds": [], "losses": [], "sigmas": []}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for ep in range(self.num_epoch):
            iters, losses, psnr = [], [], None
            clock.mark()
            for iteration, (y, _) in enumerate(train_loader):
                if len(y) == 0:
                    continue
                sigma = rng.uniform(0, 0.25)
                loss, psnr = self.train_step(state, y, sigma, gen)
                iters.append(iteration)
                losses.append(loss)
                self.stats["sigmas"].append(sigma)
                clock.mark()
            values = torch.stack(losses).tolist() if losses else []
            self.stats["step_seconds"] += clock.seconds()
            self.stats["losses"] += values
            if not writer:
                continue
            with open(loss_file, "a") as f:
                f.writelines("Epoch: {}, iter: {}, Loss: {}\n".format(
                    ep, it, v) for it, v in zip(iters, values))
            self.save_params(state,
                             "gradient_step_denoiser_{}.msgpack".format(ep))
            with open(epoch_file, "a") as f:
                f.write("Epoch: {}, Loss: {}, PSNR: {}\n".format(
                    ep, values[-1] if values else float("nan"),
                    float(psnr) if psnr is not None else float("nan")))
        if writer:
            self.save_params(state, "gradient_step_denoiser_final.msgpack")
            # also under the registry's name, which the eval half loads
            self.save_params(state, "model_final.msgpack")
        # the other ranks return once rank 0 has written the final files
        mesh.barrier()
        if dev.type == "cuda":
            self.stats["max_memory_allocated"] = \
                torch.cuda.max_memory_allocated(dev)
        return state
