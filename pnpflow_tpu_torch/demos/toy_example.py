"""Self-contained 2-D toy example (port of the repository's
``toy_example.py``): train a flow-matching MLP velocity field on an
eight-mode Gaussian-mixture ring with minibatch-OT coupling (Sinkhorn, as
the JAX script couples), then run annotated PnP-Flow iterations on a linear
inverse problem that observes only the x-coordinate.

Run: ``python -m pnpflow_tpu_torch.demos.toy_example [--device cpu]
[--steps N] [--out DIR]``; writes ``toy_flow.png`` and ``toy_pnp.png``
(with matplotlib).  It runs on ``cuda`` unless ``--device`` says
otherwise.  The random draws come from seeded ``torch.Generator``s, so the
pictures are not JAX's draws; :func:`fm_step` and :func:`pnp_flow_2d` take
their noise as arguments, and the tests hold them to JAX's on the same.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pnpflow_tpu_torch.device import resolve_device
from pnpflow_tpu_torch.ops.ot import ot_pair_indices


def gmm_modes(device=None) -> torch.Tensor:
    """The eight modes, radius 2.5."""
    a = torch.arange(8, dtype=torch.float32, device=device) * 2 * math.pi / 8
    return torch.stack([2.5 * torch.cos(a), 2.5 * torch.sin(a)], dim=1)


def sample_gmm(n: int, generator, device=None) -> torch.Tensor:
    """n points of the ring GMM, standard deviation 0.15."""
    idx = torch.randint(0, 8, (n,), generator=generator, device=device)
    return gmm_modes(device)[idx] + 0.15 * torch.randn(
        (n, 2), generator=generator, device=device)


class VelocityMLP(nn.Module):
    """v(x, t): concat(x, t) -> 3 x (Dense(hidden), SiLU) -> Dense(2), the
    layers flax's ``Dense_0`` ... ``Dense_3``; lecun-normal weights (flax's
    default), zero biases."""

    def __init__(self, hidden: int = 128, seed: int = 0):
        super().__init__()
        dims = [3, hidden, hidden, hidden, 2]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for lin in self.layers:
                # truncated at 2 std, rescaled to unit variance, as flax's
                std = math.sqrt(1.0 / lin.in_features) / .87962566103423978
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                lin.bias.zero_()

    def forward(self, x, t):
        h = torch.cat([x, t[:, None]], dim=1)
        for lin in self.layers[:-1]:
            h = F.silu(lin(h))
        return self.layers[-1](h)


def fm_step(model, opt, x0, x1, t) -> torch.Tensor:
    """One Adam step on the coupled pairs: loss sum((v - (x1 - x0))^2) / B
    at x_t = t x1 + (1 - t) x0; returns the loss."""
    xt = t[:, None] * x1 + (1 - t[:, None]) * x0
    loss = ((model(xt, t) - (x1 - x0)) ** 2).sum() / x1.shape[0]
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train(steps: int = 2000, batch: int = 256, lr: float = 1e-3,
          device=None, seed: int = 0):
    """The MLP trained for ``steps`` steps: each step draws x1 from the
    GMM, x0 ~ N(0, I), couples them by Sinkhorn and draws t ~ U[0, 1)."""
    dev = resolve_device(device)
    model = VelocityMLP(seed=seed).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for i in range(steps):
        x1 = sample_gmm(batch, gen, dev)
        x0 = torch.randn((batch, 2), generator=gen, device=dev)
        i0, i1 = ot_pair_indices(x0, x1, gen, method="sinkhorn")
        t = torch.rand((batch,), generator=gen, device=dev)
        loss = fm_step(model, opt, x0[i0], x1[i1], t)
        if i % 500 == 0:
            print("train step", i, "loss", float(loss))
    return model


@torch.no_grad()
def pnp_flow_2d(model, y, A, generator=None, steps: int = 60,
                num_samples: int = 20, lr: float = 1.0, eps_seq=None):
    """PnP-Flow on the 2-D linear measurement y = A x (y: (m, n)), from
    x = 0: a gradient step on ||A x - y||^2 with lr_t = sigma^2 lr (1 - t),
    sigma 0.3, then the flow denoiser averaged over ``num_samples`` draws.
    ``eps_seq[i]`` ((num_samples, n, 2)) replaces step i's draws.  Returns
    ``(x, trajectory)``, the trajectory (steps, n, 2)."""
    sigma = 0.3
    x = torch.zeros((y.shape[1], 2), device=y.device)
    traj = []
    for i in range(steps):
        t = float(np.float32(i) / np.float32(steps))
        lr_t = sigma ** 2 * lr * (1 - t)
        z = x - lr_t / sigma ** 2 * (A.T @ (A @ x.T - y)).T
        eps = (eps_seq[i].to(y.device) if eps_seq is not None else
               torch.randn((num_samples,) + tuple(z.shape),
                           generator=generator, device=y.device))
        flat = (t * z[None] + (1 - t) * eps).reshape(-1, 2)
        t_vec = torch.full((flat.shape[0],), t, device=y.device)
        denoised = flat + (1 - t) * model(flat, t_vec)
        x = denoised.reshape(num_samples, -1, 2).mean(dim=0)
        traj.append(x)
    return x, torch.stack(traj)


@torch.no_grad()
def euler_flow(model, z, steps: int = 100):
    for i in range(steps):
        t = torch.full((z.shape[0],), i / steps, device=z.device)
        z = z + model(z, t) / steps
    return z


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--out", default=".")
    cli = parser.parse_args(argv)
    dev = resolve_device(cli.device)
    model = train(steps=cli.steps, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    samples = euler_flow(model, torch.randn((2000, 2), generator=gen,
                                            device=dev)).cpu().numpy()
    target = sample_gmm(2000, gen, dev).cpu().numpy()

    # inverse problem: observe only the x-coordinate (A = [1, 0])
    A = torch.tensor([[1.0, 0.0]], device=dev)
    truth = sample_gmm(64, torch.Generator(device=dev).manual_seed(7), dev)
    y = A @ truth.T
    x_rec, traj = pnp_flow_2d(model, y, A,
                              torch.Generator(device=dev).manual_seed(3))
    err = float(((x_rec[:, 0] - truth[:, 0]) ** 2).mean().sqrt())
    print("pnp_flow: rms error of the observed coordinate {:.4f}".format(err))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is not installed: no pictures written")
        return model
    x_rec, traj = x_rec.cpu().numpy(), traj.cpu().numpy()
    truth = truth.cpu().numpy()
    os.makedirs(cli.out, exist_ok=True)
    fig, ax = plt.subplots(1, 2, figsize=(10, 5))
    ax[0].scatter(*target.T, s=2, alpha=0.5)
    ax[0].set_title("target GMM")
    ax[1].scatter(*samples.T, s=2, alpha=0.5, color="tab:orange")
    ax[1].set_title("flow samples")
    fig.savefig(os.path.join(cli.out, "toy_flow.png"), dpi=120)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(*target.T, s=2, alpha=0.2, label="prior")
    ax.scatter(*truth.T, s=12, marker="x", color="k", label="truth")
    ax.scatter(*x_rec.T, s=12, color="tab:red", label="pnp_flow")
    for j in range(0, 64, 8):
        ax.plot(traj[:, j, 0], traj[:, j, 1], lw=0.5, color="tab:red",
                alpha=0.5)
    ax.legend()
    ax.set_title("PnP-Flow on y = x-coordinate")
    fig.savefig(os.path.join(cli.out, "toy_pnp.png"), dpi=120)
    plt.close(fig)
    print("wrote toy_flow.png, toy_pnp.png")
    return model


if __name__ == "__main__":
    main()
