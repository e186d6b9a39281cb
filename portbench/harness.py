"""One run of one cell: find its files by name, set up, measure, check,
print one JSON line.

Everything that belongs to one configuration, traffic mix, cell, driver,
per-layer metric or architecture is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the architecture, as run;
* ``traffic/<traffic>.json``: the traffic's parameters and the ``driver``
  that generates it;
* ``workloads/<cell>.json``: the limits of the cell's compared numbers;
* ``drivers/<driver>.py``: ``run(run)`` sets up, drives the window and
  checks, through the attributes of :class:`Run`;
* ``metrics/<metric>.py``: ``read(run)`` returns the per-layer metric, or
  None where the run holds nothing to read.  A metric split by the rate
  it moves (``<metric>.<part>``) is read by ``metrics/<metric>.py`` unless
  it has a reader of its own;
* ``flops/<arch>.py``: operation and byte counts of an architecture;
* ``reference/<arch>.py``: its plain model, ``Model(config)``.

A later cell, configuration, traffic or metric is new files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pnpflow_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result: it prints none."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module that reads a per-layer metric: ``metrics/<metric>.py``,
    else that of the name before its first dot."""
    if not (PKG / "metrics" / f"{metric}.py").is_file():
        metric = metric.split(".")[0]
    return plugin("metrics", metric)


def subseed(seed: int, *keys: int) -> int:
    """A 63-bit seed derived from the run's seed and ``keys``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                 *(int(k) for k in keys)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


class Run:
    """What a driver reads and fills in for one run of one cell."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda", t0: float | None = None,
                 control: str | None = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise BenchError(f"no workload {cell!r} in BENCHMARK.json")
        self.bench, self.name = bench, cell
        self.cell = cells[cell]
        conf = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = load_json(ROOT / conf["file"])
        self.traffic = load_json(PKG / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = load_json(PKG / "workloads" / f"{cell}.json")["limits"]
        self.seed, self.seconds, self.traced = int(seed), float(seconds), trace
        self.device, self.control = device, control
        self.t0 = time.perf_counter() if t0 is None else t0
        self.setup_s = None
        self.rate = {}          # end-to-end rates the driver measured
        self.facts = {}         # what the per-layer readers read
        self.checks = {}        # name -> (value, limit)
        self.attempted = self.failed = 0
        self.trace = None
        self.peak_bytes = 0
        self.phases = []        # (stage of set-up, seconds since start)

    def subseed(self, *keys) -> int:
        return subseed(self.seed, *keys)

    def flops(self):
        return plugin("flops", self.config["arch"])

    def reference(self):
        """The plain reference of the configuration's architecture."""
        return importlib.import_module(
            f"portbench.reference.{self.config['arch']}")

    def phase(self, name: str):
        """Mark the end of a stage of set-up, for the log."""
        self.phases.append((name, time.perf_counter() - self.t0))

    def window_opened(self):
        """Called by the driver right after the synchronisation that ends
        set-up."""
        self.setup_s = time.perf_counter() - self.t0

    def check(self, name: str, value: float):
        """Record one compared number beside its limit from the cell's
        file; NaN fails."""
        self.checks[name] = (float(value), float(self.limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for v, lim in self.checks.values())


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def card(device: str) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        # the rehearsals on the host; the command line refuses to run here
        return {"platform": "cpu", "kind": "cpu"}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        dev["power_limit"] = smi.stdout.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        dev["power_limit"] = "not read"
    return dev


def result(run: Run) -> dict:
    """The JSON line of a finished run."""
    bench, cell = run.bench, run.name
    metrics = {}
    if run.traced:
        for m in bench["per_layer"]:
            if applies(m, cell):
                value = reader(m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
    else:
        known = {"setup_s": run.setup_s,
                 "peak_mem_gib": run.peak_bytes / 2 ** 30, **run.rate}
        for m in bench["end_to_end"]:
            if applies(m, cell):
                if known.get(m["name"]) is None:
                    raise BenchError(f"the driver measured no {m['name']}")
                metrics[m["name"]] = {"value": float(known[m["name"]]),
                                      "unit": m["unit"]}
    device = {**card(run.device), "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(run: Run) -> dict:
    """Drive the cell, then build its line; raises :class:`BenchError`
    where no result may be printed."""
    plugin("drivers", run.traffic["driver"]).run(run)
    if run.setup_s is None:
        raise BenchError("the driver never opened its window")
    out = result(run)
    found = forbidden_modules()
    if found:
        raise BenchError("loaded in the measuring process: "
                         + ", ".join(found))
    return out
