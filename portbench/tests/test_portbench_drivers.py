"""Each driver at a tiny size through the code its window runs: the line
it prints, its rate, its facts, and its check against the reference."""

import json

import pytest

from portbench.harness import execute
from portbench.tests.conftest import TINY, tiny_run


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_and_is_correct(cell):
    run = tiny_run(cell)
    out = execute(run)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert out["failed"] == 0 and out["attempted"] >= 1
    for name in ("setup_s", "peak_mem_gib", run.traffic["rate_metric"]):
        assert name in out["metrics"]
    assert out["metrics"][run.traffic["rate_metric"]]["value"] > 0
    assert set(out["checks"]) == set(run.limits)
    json.dumps(out)


def test_restore_window_counts_whole_steps():
    run = tiny_run("restore-unet128-deblur", seconds=3.0)
    execute(run)
    f = run.facts
    rate = run.rate["restore_img_per_s"]
    steps = run.traffic["steps_pnp"]
    assert f["forwards"] >= 1
    assert rate == pytest.approx(run.traffic["batch"] * f["forwards"]
                                 / steps / f["window_s"])
    k, a, z = f["stage"]
    assert 0 <= a < z < steps


def test_train_window_follows_warmup():
    run = tiny_run("train-unet128-fm-ot", seconds=1.0)
    execute(run)
    f = run.facts
    assert f["train_steps"] >= 1
    # the replayed step lies in the window, which runs on to it
    warm = run.traffic["warmup_steps"]
    assert warm < f["probe"] <= warm + run.traffic["probe_span"]
    assert f["probe"] <= warm + f["train_steps"]
    assert {"window_loss_gap", "window_grad_gap", "window_change_gap",
            "window_ema_gap"} <= set(run.checks)
    assert run.attempted >= run.traffic["warmup_steps"] + f["train_steps"]
    assert run.rate["train_img_per_s"] == pytest.approx(
        run.traffic["batch"] * f["train_steps"] / f["window_s"])
    assert f["ot_pair_s"] > 0
