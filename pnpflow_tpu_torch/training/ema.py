"""Exponential moving average of parameters (port of
``pnpflow_tpu/training/ema.py``).

The reference's ``ExponentialMovingAverage`` surface: the warmup decay
``min(decay, (1 + n) / (10 + n))``, ``update`` / ``copy_to`` / ``store`` /
``restore`` and a serializable state dict.  It holds detached copies of a
list of tensors, or of a ``state_dict`` (then :meth:`EMA.copy_to` without
an argument returns a dict with the same keys).  Updates are in place, in
the JAX package's float32 arithmetic: ``s - (1 - decay) * (s - p)``.

The flow-matching trainer keeps its own fixed-decay EMA inside the train
step (``training/flow_matching.py``), as the JAX trainer does.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _tensors(params) -> list:
    return list(params.values()) if isinstance(params, Mapping) else list(
        params)


def warmup_decay(decay: float, num_updates: int):
    """The decay of update number ``num_updates`` (counted from 1), in
    float32 as the JAX package computes it."""
    n = np.float32(num_updates)
    return np.minimum(np.float32(decay),
                      (np.float32(1.0) + n) / (np.float32(10.0) + n))


class EMA:
    """Shadow copies of ``params`` (a list of tensors or a ``state_dict``)
    averaged after each optimizer step."""

    def __init__(self, params, decay: float, use_num_updates: bool = True):
        if decay < 0.0 or decay > 1.0:
            raise ValueError("Decay must be between 0 and 1")
        self.decay = decay
        self.num_updates = 0 if use_num_updates else None
        self._keys = list(params) if isinstance(params, Mapping) else None
        self.shadow = [p.detach().clone() for p in _tensors(params)]
        self._stored = None

    @torch.no_grad()
    def update(self, params):
        """One step after an optimizer update: ``s -= (1 - decay)(s - p)``."""
        if self.num_updates is not None:
            self.num_updates += 1
            one_minus = float(np.float32(1.0) - warmup_decay(
                self.decay, self.num_updates))
        else:
            one_minus = 1.0 - self.decay
        diff = torch._foreach_sub(self.shadow, [p.detach()
                                                for p in _tensors(params)])
        torch._foreach_mul_(diff, one_minus)
        torch._foreach_sub_(self.shadow, diff)

    @torch.no_grad()
    def copy_to(self, params=None):
        """Copy the averages into ``params`` in place; without ``params``,
        return them (a dict where the EMA was built from one)."""
        if params is None:
            return (dict(zip(self._keys, self.shadow)) if self._keys
                    is not None else list(self.shadow))
        torch._foreach_copy_(_tensors(params), self.shadow)
        return params

    def store(self, params):
        """Keep a copy of ``params``, for :meth:`restore` after evaluating
        with the averages."""
        self._stored = [p.detach().clone() for p in _tensors(params)]

    @torch.no_grad()
    def restore(self, params):
        """Copy the parameters kept by :meth:`store` back into ``params``."""
        if self._stored is None:
            raise ValueError("No parameters stored")
        torch._foreach_copy_(_tensors(params), self._stored)
        return params

    def state_dict(self) -> dict:
        return {"decay": self.decay, "num_updates": self.num_updates,
                "shadow_params": list(self.shadow)}

    def load_state_dict(self, sd: dict):
        shadow = _tensors(sd["shadow_params"])
        if len(shadow) != len(self.shadow):
            raise ValueError(f"{len(shadow)} shadow parameters for an EMA "
                             f"of {len(self.shadow)}")
        self.decay = sd["decay"]
        self.num_updates = sd["num_updates"]
        self.shadow = [s.detach().clone() for s in shadow]
