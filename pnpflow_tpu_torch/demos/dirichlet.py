"""Dirichlet-simplex demos (port of the repository's ``demo/dirichlet.py``,
after the reference notebooks ``demo/dirichlet/Diri_PnP.ipynb`` and
``Diri_DFlow.ipynb``).

28x28 digits normalised onto the 784-simplex are restored with a flow prior
whose latent is Dirichlet(1, ..., 1) instead of Gaussian:

* Diri_PnP: the PnP-Flow loop whose Monte-Carlo denoiser draws Dirichlet
  samples (z2 ~ Dir, z~ = t z + (1 - t) z2, D = z~ + (1 - t) v,
  lr_t = 1 - t), for super-resolution x2 (zero-fill upsampling adjoint),
  denoising and top-half inpainting;
* Diri_DFlow: D-Flow's latent optimisation by LBFGS with a strong-Wolfe
  line search (``torch.optim.LBFGS``, where JAX runs optax's ``lbfgs``
  with a zoom line search) and the simplex penalty w (sum(z) - 1)^2, from
  z = sqrt(0.1) inverse_flow(x) + sqrt(0.9) Dir.

No checkpoint or MNIST file can be downloaded, so the demo first trains the
notebooks' small U-Net (28x28, ch 32, mult 1,2, two blocks, attention at
16; ``fused_norm True``: its GroupNorms through the ``groupnorm_swish``
kernel on the card) as a Dirichlet-latent flow on the data there is (MNIST
under ./data if present, synthetic images otherwise), then runs the six
experiments and saves 4x4 grids as the notebooks do (with matplotlib).

Run: ``python -m pnpflow_tpu_torch.demos.dirichlet [--device cpu]``
Env: ``DIRI_STEPS`` / ``DIRI_MC`` / ``DIRI_TRAIN_ITERS`` /
``DIRI_DFLOW_ITERS`` shrink it, ``DIRI_OUT`` moves its output
(``results/dirichlet``), as in JAX.  A Dirichlet draw is a normalised
vector of unit exponentials from a seeded ``torch.Generator``; the steps
take their draws as arguments, and the tests hold them to JAX's on the
same draws.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from pnpflow_tpu_torch.data import DataLoaders
from pnpflow_tpu_torch.demos.demo import small_unet
from pnpflow_tpu_torch.device import resolve_device, set_fp32_parity_mode
from pnpflow_tpu_torch.models.unet import init_weights

DIM = 28
B = 16
D = DIM * DIM


def knobs() -> dict:
    """The environment's sizes, read at call time (defaults: the
    notebooks')."""
    env = os.environ.get
    return {"steps": int(env("DIRI_STEPS", 300)),
            "num_samples": int(env("DIRI_MC", 5)),
            "train_iters": int(env("DIRI_TRAIN_ITERS", 300)),
            "dflow_iters": int(env("DIRI_DFLOW_ITERS", 20)),
            "out_dir": env("DIRI_OUT", "results/dirichlet")}


def dirichlet_sample(n: int, generator, device=None) -> torch.Tensor:
    """Dir(1, ..., 1) over the 784-simplex, shaped (n, 28, 28, 1)."""
    e = torch.empty((n, D), device=device).exponential_(generator=generator)
    return (e / e.sum(dim=1, keepdim=True)).reshape(n, DIM, DIM, 1)


def downsample(x, sf: int = 2):
    """Strided decimation."""
    return x[:, ::sf, ::sf, :]


def upsample(x, sf: int = 2):
    """Zero-fill upsampling, the decimation's adjoint."""
    b, h, w, c = x.shape
    z = x.new_zeros((b, h, sf, w, sf, c))
    z[:, :, 0, :, 0, :] = x
    return z.reshape(b, h * sf, w * sf, c)


def _data(batch: int):
    name = "mnist" if os.path.isdir("./data/mnist") else "synthetic"
    return DataLoaders(name, batch, batch, dim_image=DIM, num_channels=1,
                       root="./data").load_data()


def to_simplex(x) -> torch.Tensor:
    """[-1, 1] images -> intensities in [0, 1] summing to 1 per image."""
    x = (torch.as_tensor(np.asarray(x, np.float32)) + 1.0) / 2.0
    return x / x.sum(dim=(1, 2, 3), keepdim=True)


def fm_loss(model, x0, x1, t):
    """x_t = t x1 + (1 - t) x0, target x1 - x0, summed, over the batch."""
    tb = t[:, None, None, None]
    v = model(tb * x1 + (1 - tb) * x0, t)
    return ((v - (x1 - x0)) ** 2).sum() / x1.shape[0]


def train_dirichlet_flow(iters: int, generator, device):
    """The small U-Net trained ``iters`` Adam steps (lr 2e-4) with a
    Dirichlet source, independent coupling, batch 64."""
    model = init_weights(small_unet(channels=1, dim=DIM), 0).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=2e-4, betas=(0.9, 0.999),
                           eps=1e-8)
    it, loss = 0, float("nan")
    loaders = _data(64)
    while it < iters:
        for x, _ in loaders["train"]:
            if it >= iters:
                break
            x1 = to_simplex(x).to(device)
            x0 = dirichlet_sample(x1.shape[0], generator, device)
            t = torch.rand((x1.shape[0],), generator=generator,
                           device=device)
            loss = fm_loss(model, x0, x1, t)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            loss = loss.detach()
            it += 1
    print("  trained {} iters, final FM loss {:.3e}".format(it, float(loss)))
    return model.eval()


# ---------------------------------------------------------------------------
# Diri_PnP


@torch.no_grad()
def pnp_step(model, x, y, H, H_adj, t: float, draws):
    """One Diri_PnP iteration at time t: a gradient step with lr 1 - t,
    then the flow denoiser averaged over the Dirichlet ``draws``."""
    z = x - (1.0 - t) * H_adj(H(x) - y)
    tv = torch.full((x.shape[0],), t, device=x.device)
    acc = torch.zeros_like(x)
    for z2 in draws:
        z_new = t * z + (1.0 - t) * z2
        acc = acc + z_new + (1.0 - t) * model(z_new, tv)
    return acc / len(draws)


@torch.no_grad()
def pnp_dirichlet(model, y, H, H_adj, generator, steps: int,
                  num_samples: int):
    x = dirichlet_sample(B, generator, y.device)
    for i in range(steps):
        t = float(np.float32(i) / np.float32(steps))
        draws = [dirichlet_sample(B, generator, y.device)
                 for _ in range(num_samples)]
        x = pnp_step(model, x, y, H, H_adj, t, draws)
    return x


# ---------------------------------------------------------------------------
# Diri_DFlow


def flow_forward(model, z, steps: int = 6):
    """Midpoint integration of the flow from the latent, t = 0 to 1."""
    dt = 1.0 / steps
    for i in range(steps):
        t = i * dt
        tv = torch.full((z.shape[0],), t, device=z.device)
        tm = torch.full((z.shape[0],), t + 0.5 * dt, device=z.device)
        z = z + dt * model(z + 0.5 * dt * model(z, tv), tm)
    return z


@torch.no_grad()
def flow_inverse(model, x, steps: int = 24):
    """Euler integration of the reverse flow, t = 1 to 0."""
    dt = 1.0 / steps
    for i in range(steps):
        tv = torch.full((x.shape[0],), 1.0 - i * dt, device=x.device)
        x = x - dt * model(x, tv)
    return x


def dflow_objective(model, z, y, H, reg_weight: float):
    """The data fit mean(sum((H(flow(z)) - y)^2)) plus the simplex penalty
    reg_weight mean((sum(z) - 1)^2)."""
    fit = ((H(flow_forward(model, z)) - y) ** 2).sum(dim=(1, 2, 3)).mean()
    simplex = ((z.sum(dim=(1, 2, 3)) - 1.0) ** 2).mean()
    return fit + reg_weight * simplex


def H_adj_init(y):
    """A measurement-shaped start: zero-fill upsampling for SR, the half
    image padded with zeros for inpainting, y itself for denoising."""
    if y.shape[1] == DIM // 2 and y.shape[2] == DIM // 2:
        return upsample(y)
    if y.shape[1] == DIM // 2:
        return torch.cat([y, torch.zeros_like(y)], dim=1)
    return y


def dflow_dirichlet(model, y, H, generator, reg_weight: float, iters: int):
    model.requires_grad_(False)
    z0 = flow_inverse(model, H_adj_init(y))
    z = (math.sqrt(0.1) * z0 + math.sqrt(0.9)
         * dirichlet_sample(B, generator, y.device)).requires_grad_()
    opt = torch.optim.LBFGS([z], lr=1.0, max_iter=1, history_size=100,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        value = dflow_objective(model, z, y, H, reg_weight)
        value.backward()
        return value.detach()

    value = float("nan")
    for _ in range(iters):
        value = float(opt.step(closure))
    print("  final d_flow objective {:.4e}".format(value))
    with torch.no_grad():
        return flow_forward(model, z)


def save_grid(x, path: str, title: str):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("  matplotlib is not installed: no", path)
        return
    f, axarr = plt.subplots(4, 4, figsize=(4, 4))
    arr = x.detach().float().cpu().numpy()
    for k in range(4):
        for li in range(4):
            axarr[k, li].imshow(arr[k * 4 + li, :, :, 0], cmap="gray")
            axarr[k, li].get_yaxis().set_ticks([])
            axarr[k, li].get_xaxis().set_ticks([])
    f.suptitle(title)
    plt.tight_layout()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    plt.savefig(path)
    plt.close(f)
    print("  wrote", path)


def experiments():
    """(name, H, H_adj, measurement noise sigma, d_flow simplex weight)."""
    return [
        ("sr2", downsample, upsample, 1e-4, 10000.0),
        ("denoising", lambda x: x, lambda y: y, 1e-3, 10000.0),
        ("inpainting", lambda x: x[:, :DIM // 2],
         lambda y: torch.cat([y, torch.zeros_like(y)], dim=1), 1e-4, 100.0),
    ]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    cli = parser.parse_args(argv)
    dev = resolve_device(cli.device)
    set_fp32_parity_mode()
    k = knobs()
    gen = torch.Generator(device=dev).manual_seed(0)
    print("1) training a Dirichlet-latent flow prior ...")
    model = train_dirichlet_flow(k["train_iters"], gen, dev)

    print("2) loading a simplex-normalized batch ...")
    x, _ = next(iter(_data(B)["test"]))
    batch = to_simplex(np.asarray(x)[:B]).to(dev)
    save_grid(batch, os.path.join(k["out_dir"], "clean.png"), "clean")

    results = {}
    for i, (name, H, H_adj, sigma, reg) in enumerate(experiments()):
        meas = H(batch)
        y = meas + sigma * torch.randn(
            meas.shape, generator=torch.Generator(device=dev).manual_seed(i),
            device=dev)
        print("3.{}a) Diri_PnP {} ...".format(i, name))
        x_pnp = pnp_dirichlet(
            model, y, H, H_adj,
            torch.Generator(device=dev).manual_seed(10 + i), k["steps"],
            k["num_samples"])
        print("  simplex sums:", x_pnp.sum(dim=(1, 2, 3))[:4].tolist())
        save_grid(x_pnp, os.path.join(k["out_dir"], f"pnp_{name}.png"),
                  "Diri_PnP " + name)

        print("3.{}b) Diri_DFlow {} ...".format(i, name))
        x_df = dflow_dirichlet(
            model, y, H, torch.Generator(device=dev).manual_seed(20 + i),
            reg, k["dflow_iters"])
        save_grid(x_df, os.path.join(k["out_dir"], f"dflow_{name}.png"),
                  "Diri_DFlow " + name)
        results[name] = (x_pnp, x_df)
    print("done: results in", k["out_dir"])
    return results


if __name__ == "__main__":
    main()
