"""Summarize a ``torch.profiler`` trace: the top device ops by time.

The counterpart of ``scripts/profile_report.py`` (which reads JAX's xplane
protos) for the Chrome traces that ``--opts jax_profile <dir>``
(``solvers/base.py``) writes.

Usage:
  python -m pnpflow_tpu_torch.utils.profile_report <trace_dir> [top_n]

Reads every ``*.json`` trace under the directory, sums the durations of
its complete events per name, and prints one JSON line per op: name, total
ms, share, occurrences.  Device events (CUDA kernels, memcpy, memset) are
preferred; a trace with none, as a CPU run writes, falls back to the CPU
ops, whose times nest (an ``aten::`` op includes the ops it calls), so
their shares overlap.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import sys

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_traces(trace_dir: str) -> list:
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.json trace under {trace_dir}")
    traces = []
    for p in paths:
        with open(p) as f:
            traces.append(json.load(f))
    return traces


def op_table(traces, prefer_device: bool = True):
    """``(totals_us, counts)`` per op name over the complete ("X") events:
    the device's where there are any (``prefer_device``), else the CPU
    ops'."""
    events = [e for t in traces for e in t.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if prefer_device and device:
        events = device
    else:
        events = [e for e in events if e.get("cat") == "cpu_op"]
    totals, counts = collections.Counter(), collections.Counter()
    for e in events:
        totals[e["name"]] += float(e["dur"])
        counts[e["name"]] += 1
    return totals, counts


def report(trace_dir: str, top_n: int = 15) -> list:
    """The table's rows, largest first: ``{"op", "ms", "share", "count"}``."""
    totals, counts = op_table(load_traces(trace_dir))
    grand = sum(totals.values()) or 1.0
    return [{"op": name[:120], "ms": round(us / 1e3, 3),
             "share": round(us / grand, 4), "count": counts[name]}
            for name, us in totals.most_common(top_n)]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    top_n = int(argv[1]) if len(argv) > 1 else 15
    for row in report(argv[0], top_n):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
