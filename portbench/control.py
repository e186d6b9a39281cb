"""Readings for the limits of each cell's check, one process a mode:

    python3 -m portbench.control --workload <cell> --mode <mode> \\
        --seconds <s> --seeds <n> [<n> ...]

``program`` runs the cell as the benchmark does (the lower readings);
``reference-tf32`` puts the plain reference in the program's place and
lets it compute in TF32, the precision below the configuration's (the
control); a name from ``faults.py`` plants that fault in the port.  Each
seed prints one line: the mode, the seed, ``correct`` and the numbers
compared.  The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys

from portbench import faults
from portbench.harness import ROOT, Run, execute, load_json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=["program", "reference-tf32", *faults.BY_NAME])
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 2
    if args.mode in faults.BY_NAME:
        faults.BY_NAME[args.mode](setattr)
    bench = load_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        run = Run(bench, args.workload, seed, args.seconds, trace=False,
                  control=args.mode if args.mode == "reference-tf32"
                  else None)
        out = execute(run)
        print(json.dumps({"mode": args.mode, "seed": seed,
                          "correct": out["correct"],
                          "checks": {k: v["value"]
                                     for k, v in out["checks"].items()},
                          "metrics": {k: v["value"]
                                      for k, v in out["metrics"].items()},
                          "facts": {k: v for k, v in run.facts.items()
                                    if isinstance(v, (int, float, dict))}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
