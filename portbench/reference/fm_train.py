"""Flow-matching training with minibatch exact OT, written plainly from
Tong et al. (arXiv 2302.00482) as annegnx/PnP-Flow's
``train_flow_matching.py`` runs it.

A step: x0 ~ N(0, I) from a numpy ``default_rng(seed)`` (one
``standard_normal`` of the batch's shape a step); the exact assignment of
the squared-euclidean costs in float64 (scipy's ``linear_sum_assignment``);
B matched pairs resampled with replacement (``rng.integers(0, B, B)``);
t ~ U[0, 1) from a ``torch.Generator`` seeded ``seed`` on the device (one
``torch.rand(B)`` a step); the loss sum((v(x_t, t) - (x1 - x0))^2) / B at
x_t = t x1 + (1 - t) x0; Adam (0.9, 0.999, eps 1e-8, bias-corrected); the
EMA e = d e + (1 - d) p.  These are the draws and update the trainer's
documented seeding rules name.  The gradient is accumulated over blocks
of rows, so the reference fits beside what is left on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def ot_pairs(x0: np.ndarray, x1: np.ndarray, rng: np.random.Generator):
    a = x0.reshape(x0.shape[0], -1).astype(np.float64)
    b = x1.reshape(x1.shape[0], -1).astype(np.float64)
    cost = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    sigma = linear_sum_assignment(cost)[1]
    rows = rng.integers(0, a.shape[0], size=a.shape[0])
    return rows, sigma[rows]


class Trainer:
    """Plain steps on ``model``'s parameters; ``rows`` rows per block."""

    def __init__(self, model, seed: int, device, lr: float, ema_decay: float,
                 rows: int, faults=()):
        self.model, self.device, self.rows = model, device, rows
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.names = [n for n, p in model.named_parameters()
                      if p.requires_grad]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.lr, self.decay, self.count = lr, ema_decay, 0
        self.rng = np.random.default_rng(int(seed))
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.faults = set(faults)

    def step(self, x1_host: np.ndarray):
        """One step on a host batch -> (loss, gradients)."""
        x1_host = np.asarray(x1_host, np.float32)
        x0_host = self.rng.standard_normal(x1_host.shape, dtype=np.float32)
        i0, i1 = ot_pairs(x0_host, x1_host, self.rng)
        x0 = torch.from_numpy(x0_host[i0]).to(self.device)
        x1 = torch.from_numpy(x1_host[i1]).to(self.device)
        b = x1.shape[0]
        t = torch.rand(b, generator=self.gen, device=self.device)
        used = b // 2 if "half" in self.faults else b
        grads = [torch.zeros_like(p) for p in self.params]
        loss = 0.0
        for s in range(0, used, self.rows):
            e = min(s + self.rows, used)
            tb = t[s:e, None, None, None]
            xt = tb * x1[s:e] + (1 - tb) * x0[s:e]
            part = ((self.model(xt, t[s:e]) - (x1[s:e] - x0[s:e])) ** 2
                    ).sum() / used
            g = torch.autograd.grad(part, self.params, allow_unused=True)
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc += gi
            loss += float(part.detach())
        if "unchanged" not in self.faults:
            self._adam(grads)
        return loss, grads

    def skip(self, steps: int, shape):
        """Make the draws of ``steps`` steps on batches of ``shape``, and
        count them, without stepping."""
        for _ in range(steps):
            self.rng.standard_normal(shape, dtype=np.float32)
            self.rng.integers(0, shape[0], size=shape[0])
            torch.rand(shape[0], generator=self.gen, device=self.device)
        self.count += steps

    @torch.no_grad()
    def load(self, params, m, v, ema):
        """Take the parameters, Adam's moments and the EMA given."""
        for mine, given in zip((self.params, self.m, self.v, self.ema),
                               (params, m, v, ema)):
            for a, b in zip(mine, given):
                a.copy_(b)

    @torch.no_grad()
    def _adam(self, grads):
        self.count += 1
        c1, c2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        for p, g, m, v, e in zip(self.params, grads, self.m, self.v,
                                 self.ema):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + 1e-8))
            e.mul_(self.decay).add_(p, alpha=1 - self.decay)
