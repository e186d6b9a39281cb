"""Rehearsals of the benchmark on the host: every cell's code path at a
size the CPU runs in seconds, with the port's plain kernel versions.

Run from the repository root: ``python -m pytest portbench/tests -q``;
the card's tests (marker ``gpu``) with ``-m gpu`` on a machine with one."""

import copy

import pytest
import torch

from portbench.harness import ROOT, Run, load_json

# (config, traffic) overrides that make each cell a CPU rehearsal: the
# widths stay, the images shrink, the batch and the steps with them (at
# 64x64 the program blurs with sigma 3)
TINY = {
    "restore-unet128-deblur": ({"image_size": 64},
                               {"batch": 1, "num_samples": 2,
                                "steps_pnp": 20, "sigma_blur": 3.0}),
    "restore-ncsnpp256-deblur": ({"image_size": 64},
                                 {"batch": 1, "num_samples": 2,
                                  "steps_pnp": 20}),
    "train-unet128-fm-ot": ({"image_size": 16},
                            {"batch": 4, "ref_rows": 2}),
}
SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(cell, seconds=2.0, seed=SEED, device="cpu", bench=None,
             **kw):
    bench = copy.deepcopy(bench or load_json(ROOT / "BENCHMARK.json"))
    run = Run(bench, cell, seed, seconds, trace=False, device=device, **kw)
    cfg, tr = TINY[cell]
    run.config.update(cfg)
    run.traffic.update(tr)
    return run
