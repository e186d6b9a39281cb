"""A run with the timed path broken underneath (``faults.py``) reads
``correct`` false, for each fault a one-card cell can have: a step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest, and an answer altered where it is produced.  (No cell
spans cards, so no exchange between them can be left out.)  The harness's
look for a card is skipped: the rest of the run is the command's."""

import pytest
import torch

from portbench import faults
from portbench.harness import execute
from portbench.tests.conftest import tiny_run

CASES = [(cell, fault)
         for cell in ("restore-unet128-deblur", "restore-ncsnpp256-deblur")
         for fault in faults.RESTORE]
CASES += [("train-unet128-fm-ot", fault) for fault in faults.TRAIN]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    out = execute(tiny_run(cell, seconds=1.0))
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def late_ema(patch):
    """The EMA left where it is from the fourth step on."""
    from pnpflow_tpu_torch.training import flow_matching as fm

    real, calls = fm.ema_step, [0]

    def ema_step(ema, params, decay):
        calls[0] += 1
        if calls[0] <= 3:
            real(ema, params, decay)

    patch(fm, "ema_step", ema_step)


def late_bias_correction(patch):
    """Adam's bias correction stuck at the third step's count."""
    real = torch.optim.Adam.step

    def step(self, *a, **k):
        for s in self.state.values():
            if "step" in s and float(s["step"]) >= 3:
                s["step"].fill_(2)
        return real(self, *a, **k)

    patch(torch.optim.Adam, "step", step)


@pytest.mark.parametrize("fault", [late_ema, late_bias_correction],
                         ids=lambda f: f.__name__)
def test_a_fault_after_the_first_steps_fails_the_window_step(fault,
                                                             monkeypatch):
    fault(monkeypatch.setattr)
    out = execute(tiny_run("train-unet128-fm-ot", seconds=1.0))
    checks = out["checks"]
    first = ("loss_gap", "grad_gap", "change_gap", "ema_gap")
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in first)
    assert any(v["value"] > v["limit"] for k, v in checks.items()
               if k.startswith("window_")), checks
    assert not out["correct"]
