"""Shared solver machinery: model bundle, measurement protocol, batch loop.

Port of ``pnpflow_tpu/solvers/base.py``.  The outer loop iterates
``max_batch`` test batches, draws each measurement from a generator seeded
with the batch index, runs the solver, and reports metrics and time/memory
stats in the reference's result layout.  A split shorter than ``max_batch``
ends the loop gracefully.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass

import torch

import pnpflow_tpu_torch.utils.reporting as reporting
from pnpflow_tpu_torch.utils.config import get_save_path_ip


@dataclass
class ModelBundle:
    """A velocity model on its device: ``forward(x_nhwc, t_vec) -> v``."""

    model: torch.nn.Module
    device: torch.device = torch.device("cpu")

    def forward(self, x, t):
        return self.model(x, t)


def measure(H, clean, sigma_noise, noise_type, batch: int):
    """y = H(clean) + sigma * noise, noise from a generator seeded
    ``batch`` on clean's device."""
    gen = torch.Generator(device=clean.device).manual_seed(int(batch))
    y = H(clean)
    if noise_type == "gaussian":
        noise = torch.randn(y.shape, generator=gen, device=y.device,
                            dtype=y.dtype)
        return y + sigma_noise * noise
    if noise_type == "laplace":
        raise NotImplementedError(
            "laplace noise is not ported yet (ROADMAP queue 1, item 6)")
    raise ValueError("Noise type not supported")


def peak_memory_info(device) -> tuple:
    """``(bytes, source)``: the CUDA allocator's peak since the last reset."""
    return (int(torch.cuda.max_memory_allocated(device)),
            "torch.cuda.max_memory_allocated")


class Solver:
    """Base class with the reference-compatible outer loop."""

    def __init__(self, model: ModelBundle, args):
        self.model = model
        self.args = args

    def solve_batch(self, clean_img, noisy_img, degradation, sigma_noise,
                    batch: int, report_cb=None):
        raise NotImplementedError

    def run_method(self, data_loaders, degradation, sigma_noise):
        args = self.args
        folder = get_save_path_ip(args.dict_cfg_method)
        args.save_path_ip = os.path.join(args.save_path, folder)
        os.makedirs(args.save_path_ip, exist_ok=True)
        self.solve_ip(data_loaders[args.eval_split], degradation, sigma_noise)

    @torch.inference_mode()
    def solve_ip(self, test_loader, degradation, sigma_noise):
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
                reporting.compute_psnr(clean_img, noisy_img, x, args,
                                       iter=iteration)
                reporting.compute_ssim(clean_img, noisy_img, x, args,
                                       iter=iteration)
                reporting.compute_lpips(clean_img, noisy_img, x, args,
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
                                      iter="final")
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
