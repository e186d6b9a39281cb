"""Faults planted in the port, for the checks' controls: each takes
``patch(owner, name, value)`` (``setattr``, or pytest's
``monkeypatch.setattr``) and breaks the timed path underneath the harness.

Restoration: a PnP step that returns its state unchanged; a network
forward that computes half of its batch and gives the rest their mean; a
network output altered where it is produced.  Training: an optimizer step
that leaves the state unchanged; a loss over half of the batch,
normalised by that half; a loss altered where it is produced."""

import torch


def unchanged_pnp(patch):
    from pnpflow_tpu_torch.solvers import pnp_flow

    real = pnp_flow.make_pnp_flow_solver

    def make(*a, **k):
        real(*a, **k)
        return lambda y, x, generator, start_iter, n_iters: x

    patch(pnp_flow, "make_pnp_flow_solver", make)


def half_batch_forward(patch):
    from pnpflow_tpu_torch.solvers import base

    def forward(self, x, t):
        half = max(x.shape[0] // 2, 1)
        v = self.model(x[:half], t[:half])
        rest = v.mean(dim=0, keepdim=True).expand(x.shape[0] - half,
                                                  *v.shape[1:])
        return torch.cat([v, rest])

    patch(base.ModelBundle, "forward", forward)


def altered_forward(patch):
    from pnpflow_tpu_torch.solvers import base

    def forward(self, x, t):
        v = self.model(x, t).clone()
        v[0, 0, 0, 0] += 0.05 * float(v.abs().max())
        return v

    patch(base.ModelBundle, "forward", forward)


def unchanged_train(patch):
    patch(torch.optim.Adam, "step", lambda self, *a, **k: None)


def half_batch_loss(patch):
    from pnpflow_tpu_torch.training import flow_matching as fm

    real = fm.make_fm_loss

    def make(model, remat=False):
        loss = real(model, remat)

        def half(x0, x1, t, batch=None):
            h = x1.shape[0] // 2
            return loss(x0[:h], x1[:h], t[:h], h)
        return half

    patch(fm, "make_fm_loss", make)


def altered_loss(patch):
    from pnpflow_tpu_torch.training import flow_matching as fm

    real = fm.make_fm_loss

    def make(model, remat=False):
        loss = real(model, remat)
        return lambda *a, **k: loss(*a, **k) * 1.01

    patch(fm, "make_fm_loss", make)


RESTORE = (unchanged_pnp, half_batch_forward, altered_forward)
TRAIN = (unchanged_train, half_batch_loss, altered_loss)
BY_NAME = {f.__name__: f for f in RESTORE + TRAIN}
