"""``method pnp_gs model gradient_step`` through the port's CLI on the CPU,
one run for each algorithm / problem branch: the full-width U-Net with its
seeded init, 2 iterations on one image (16x16, or 64x64 where the 61-wide
FFT blur kernel needs it).  Each run writes the reference file set, with
the method's keys in ``final_psnr.txt``'s header and finite PSNRs.  The
numbers are held to JAX in ``tests/test_torch_pnp_gs.py``."""

import os
import warnings

import numpy as np
import pytest
import torch

from pnpflow_tpu_torch.main import main


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("algo,problem,dim", [
    ("pgd", "denoising", 16),
    ("pgd", "gaussian_deblurring_FFT", 64),
    ("hqs", "gaussian_deblurring_FFT", 64),
    ("hqs", "random_inpainting", 16),
    ("hqs", "superresolution_bicubic", 16),
])
def test_cli_writes_the_reference_file_set(tmp_path, algo, problem, dim):
    out = str(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        args = main(["--opts", "dataset", "synthetic", "dim_image", str(dim),
                     "model", "gradient_step", "eval", "True", "method",
                     "pnp_gs", "algo", algo, "problem", problem,
                     "max_iter", "2", "batch_size_ip", "1", "max_batch", "1",
                     "compute_time", "True", "device", "cpu",
                     "output_root", out])
    ip = args.save_path_ip
    for f in ("psnr_rec_batch0.txt", "psnr_noisy_batch0.txt",
              "ssim_rec_batch0.txt", "psnr_rec_average.txt",
              "ssim_rec_average.txt", "time_stats.txt", "time_average.txt",
              f"{problem}_pnp_gs_batch0_final.png"):
        assert os.path.exists(os.path.join(ip, f)), f
    # reported after iteration 0 and at the end (max_iter - 1)
    rows = np.loadtxt(os.path.join(ip, "psnr_rec_batch0.txt"), ndmin=2)
    assert len(rows) == 2 and np.isfinite(rows).all()
    with open(os.path.join(args.save_path, "final_psnr.txt")) as f:
        header, row = f.readline().split(), f.readline().split()
    assert header == ["psnr_rec", "psnr_noisy", "max_iter", "lr_pnp",
                      "alpha", "algo", "sigma_factor"]
    assert np.isfinite(float(row[0])) and algo in row
