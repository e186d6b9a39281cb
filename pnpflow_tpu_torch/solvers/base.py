"""Shared solver machinery: model bundle, measurement protocol, batch loop.

Port of ``pnpflow_tpu/solvers/base.py``.  The outer loop iterates
``max_batch`` test batches, draws each measurement from a generator seeded
with the batch index, runs the solver, and reports metrics and time/memory
stats in the reference's result layout.  A split shorter than ``max_batch``
ends the loop gracefully.  ``--opts jax_profile <dir>`` (the CLI contract's
key) wraps the whole loop in ``torch.profiler.profile`` (CPU, and CUDA on
the card) and writes a Chrome trace into ``<dir>``, as JAX's
``start_trace`` / ``stop_trace`` bracket it; ``python -m
pnpflow_tpu_torch.utils.profile_report <dir>`` tabulates it.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

import pnpflow_tpu_torch.utils.reporting as reporting
from pnpflow_tpu_torch.parallel.mesh import ShardedModel
from pnpflow_tpu_torch.utils.config import get_save_path_ip


@dataclass
class ModelBundle:
    """A velocity model on its device: ``forward(x_nhwc, t_vec) -> v``.

    For ``kind == "rectified"`` the model is the NCSN++ behind its adapter,
    which already scales t by 999.  ``remat`` (``--opts remat True``) makes
    the solvers that differentiate through the model recompute its forward
    in the backward instead of keeping its activations, as JAX's
    ``jax.checkpoint`` around the apply does: :meth:`grad_forward` for a
    VJP; flow_priors checkpoints its whole ``torch.func.jvp`` instead."""

    model: torch.nn.Module
    device: torch.device = torch.device("cpu")
    kind: str = "ot"
    remat: bool = False

    def forward(self, x, t):
        return self.model(x, t)

    def grad_forward(self, x, t):
        """The forward that a VJP differentiates: under ``remat`` one
        non-reentrant ``torch.utils.checkpoint`` of the model, except for a
        ``ShardedModel``, which checkpoints each shard on its card."""
        if self.remat and not isinstance(self.model, ShardedModel):
            return checkpoint(self.model, x, t, use_reentrant=False)
        return self.model(x, t)


def draw_noise(shape, noise_type, generator, device, dtype):
    """Standard gaussian or laplace (scale 1: the difference of two unit
    exponentials) noise from ``generator``."""
    if noise_type == "gaussian":
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype)
    if noise_type == "laplace":
        e = torch.empty((2, *shape), device=device, dtype=dtype)
        e.exponential_(generator=generator)
        return e[0] - e[1]
    raise ValueError("Noise type not supported")


def draw_rows(draw, shape, rows=None, dim: int = 0):
    """``draw(shape)``; with ``rows = (start, stop, total)``, rows
    start:stop along ``dim`` of the draw for the whole batch of ``total``:
    a shard of a batch fanned out over several devices gets the very noise
    that the unsharded call gives those images."""
    if rows is None:
        return draw(tuple(shape))
    start, stop, total = rows
    full = list(shape)
    full[dim] = total
    return draw(tuple(full)).narrow(dim, start, stop - start)


def measure(H, clean, sigma_noise, noise_type, batch: int, noise=None):
    """y = H(clean) + sigma * noise, noise from a generator seeded
    ``batch`` on clean's device, or the given ``noise`` (the verification
    seam: both packages then see the same measurement)."""
    y = H(clean)
    if noise is None:
        gen = torch.Generator(device=clean.device).manual_seed(int(batch))
        noise = draw_noise(y.shape, noise_type, gen, y.device, y.dtype)
    return y + sigma_noise * noise


@contextlib.contextmanager
def profile_run(directory: str, device):
    """``torch.profiler.profile`` over the block, CPU activities and, on a
    CUDA device, the card's; the trace is written on exit to
    ``directory/trace_<pid>_<ns>.json`` (the profiler's ``trace_path``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(
        directory, "trace_{}_{}.json".format(os.getpid(), time.time_ns()))
    prof.export_chrome_trace(prof.trace_path)


def peak_memory_info(device) -> tuple:
    """``(bytes, source)``: on a CUDA device the allocator's peak since the
    last reset; on the CPU the process's peak resident set."""
    if torch.device(device).type == "cuda":
        return (int(torch.cuda.max_memory_allocated(device)),
                "torch.cuda.max_memory_allocated")
    import resource

    return (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "ru_maxrss")


class Solver:
    """Base class with the reference-compatible outer loop.

    ``differentiates`` marks a solver that differentiates through the
    model: its loop runs under ``torch.no_grad()`` (autograd refuses to
    save the inference tensors that ``torch.inference_mode()`` makes) and
    it opens ``torch.enable_grad()`` where it differentiates; the model's
    parameters are frozen, since the solvers differentiate with respect to
    the image or latent alone, as JAX does.  Other solvers run under
    ``torch.inference_mode()``, which spares the host autograd's
    bookkeeping."""

    differentiates = False
    # (start, stop, total): the rows of a batch that a fanned-out shard
    # restores (serve.py); its random draws are the whole batch's rows
    rows = None

    def __init__(self, model: ModelBundle, args):
        self.model = model
        self.args = args
        if self.differentiates:
            model.model.requires_grad_(False)

    def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                    batch: int, report_cb=None):
        raise NotImplementedError

    def run_method(self, data_loaders, degradation, sigma_noise):
        args = self.args
        folder = get_save_path_ip(args.dict_cfg_method)
        args.save_path_ip = os.path.join(args.save_path, folder)
        os.makedirs(args.save_path_ip, exist_ok=True)
        self.solve_ip(data_loaders[args.eval_split], degradation, sigma_noise)

    def grad_mode(self):
        """The autograd mode the solver runs in (see the class notes)."""
        return (torch.no_grad() if self.differentiates
                else torch.inference_mode())

    def solve_ip(self, test_loader, degradation, sigma_noise):
        profile_dir = getattr(self.args, "jax_profile", None)
        with (profile_run(str(profile_dir), self.model.device) if profile_dir
              else contextlib.nullcontext()) as prof, self.grad_mode():
            self._solve_ip(test_loader, degradation, sigma_noise)
        if profile_dir:
            print("profile trace:", prof.trace_path)

    def _solve_ip(self, test_loader, degradation, sigma_noise):
        args = self.args
        dev = self.model.device
        args.sigma_noise = sigma_noise
        on_cuda = dev.type == "cuda"
        if args.compute_memory and not on_cuda:
            warnings.warn("compute_memory reads the CUDA allocator; it is "
                          "skipped on the CPU")

        loader = iter(test_loader)
        batches_run = 0
        for batch in range(args.max_batch):
            try:
                clean_np, _ = next(loader)
            except StopIteration:
                break
            batches_run = batch + 1
            clean_img = torch.as_tensor(clean_np, device=dev)
            args.batch = batch

            noisy_img = measure(degradation.H, clean_img, sigma_noise,
                                args.noise_type, batch)

            def report_cb(x, iteration):
                for fn in (reporting.compute_psnr, reporting.compute_ssim,
                           reporting.compute_lpips):
                    fn(clean_img, noisy_img, x, args, degradation.H_adj,
                       iter=iteration)

            if on_cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            x, last_iter = self.solve_batch(
                clean_img, noisy_img, degradation, sigma_noise, batch,
                report_cb=report_cb if args.save_results else None,
            )
            if on_cuda:
                torch.cuda.synchronize(dev)
            if args.compute_time:
                reporting.save_time_use(
                    {"batch": batch,
                     "time_per_batch": time.perf_counter() - t0}, args)
            if args.compute_memory and on_cuda:
                peak, src = peak_memory_info(dev)
                reporting.save_memory_use(
                    {"batch": batch, "max_allocated": peak, "source": src},
                    args)

            if args.save_results:
                reporting.save_images(clean_img, noisy_img, x, args,
                                      degradation.H_adj, iter="final")
                report_cb(x, last_iter)

        # averaging reads per-batch files for range(max_batch); clamp to the
        # batches that actually ran so a short split still aggregates
        args.max_batch = batches_run

        if args.save_results and batches_run:
            reporting.compute_average_psnr(args)
            reporting.compute_average_ssim(args)
            reporting.compute_average_lpips(args)
        if args.compute_memory and on_cuda and batches_run:
            reporting.compute_average_memory(args)
        if args.compute_time and batches_run:
            reporting.compute_average_time(args)
