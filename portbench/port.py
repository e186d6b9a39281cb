"""What the benchmark reads of the port besides its outputs: the launch
counters its kernel wrappers keep (``ops/_build.count_launch``), each
named in the traffic's ``counters`` by ``module:function``."""

from __future__ import annotations

import importlib


def launch_counts(counters: dict) -> dict:
    out = {}
    for name, where in counters.items():
        module, attr = where.split(":")
        out[name] = getattr(importlib.import_module(module), attr).launches
    return out


def since(counters: dict, before: dict) -> dict:
    now = launch_counts(counters)
    return {k: now[k] - before[k] for k in counters}
