"""Command line: check the cards, relaunch under ``torchrun`` for a cell
of several cards, run the cell, print its line.  Exit 0 only with a line
printed; without the cards the cell asks for, exit 2 and print none."""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

from portbench.harness import ROOT, BenchError, Run, execute, load_json


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def relaunch(argv, chips: int) -> int:
    """The same command once a card under ``torchrun``; rank 0's last line
    is the result."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={chips}", "--nnodes=1",
           "--master_addr=localhost", f"--master_port={free_port()}",
           "-m", "portbench", *argv]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                          env={**os.environ, "PORTBENCH_RANKS": str(chips)})
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-4000:])
        return proc.returncode or 1
    print(lines[-1], flush=True)
    return 0


def main(argv, t0=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1 and "PORTBENCH_RANKS" not in os.environ:
        return relaunch(argv, chips)
    run = Run(bench, args.workload, args.seed, args.seconds,
              bool(args.trace), t0=t0)
    try:
        out = execute(run)
    except BenchError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 1
    if int(os.environ.get("RANK", "0")) != 0:
        return 0 if out["correct"] else 1
    print("set-up: " + ", ".join(f"{n} {t:.2f} s" for n, t in run.phases),
          file=sys.stderr)
    print("facts: " + json.dumps(run.facts, default=str), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
