"""The FID InceptionV3 as an ``nn.Module`` (port of
``pnpflow_tpu/models/inception.py``).

pytorch-fid's patched InceptionV3, which the reference embeds
(pnpflow/models.py:501-821): the torchvision trunk with the FID heads
(InceptionA with its pool projections, the InceptionC 7x7 towers,
InceptionE-1 with an average pool and InceptionE-2 with a max pool) and
the published ``pt_inception-2015-12-05`` weights.  Every conv is a
torchvision BasicConv2d: conv without bias, BatchNorm with eps 1e-3 from its
running statistics, relu.  The max-pools are 3/2 with no padding (floor),
the average pools 3/1/1 divide by the real window
(``count_include_pad=False``).

Input, as pytorch-fid's: NHWC images in [0, 1], a bilinear resize to
299x299 with half-pixel centres (``align_corners=False``; at the 64-256
pixel sizes of this repository it only upsamples, where it equals
``jax.image.resize``), grayscale tiled to three channels, then 2x - 1.
Outputs: the 2048-d pool3 features and, from the 1008-way fc head, the
class probabilities, both in one forward (:func:`get_inception_fns`).

The weights cannot be downloaded here: they load from
``{output_root}/model/inception_fid.npz`` in the JAX package's layout
(HWIO kernels, written by ``utils/inception_convert.py``), and
:func:`get_inception_fns` returns None without the file, so the caller can
fall back.  The images run in sub-batches of 50, the last one ragged; with
several devices (``devices``) each sub-batch, rounded down to a multiple of
their count, is split over them and their copies of the network run at the
same time (``parallel/mesh.py``), as JAX shards each sub-batch over its
mesh.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pnpflow_tpu_torch.device import resolve_device
from pnpflow_tpu_torch.parallel import mesh

# (path, mtime, device) -> (feature_fn, outputs_fn), the last one asked for
# only: a process that scores under several output roots keeps one network
# on the device
_CACHE: dict = {}
BN_EPS = 1e-3


class ConvBN(nn.Module):
    """Conv (no bias), BatchNorm(eps 1e-3) in inference, relu: torchvision's
    BasicConv2d, from one ``{w, gamma, beta, mean, var}`` leaf set."""

    def __init__(self, p: dict, stride: int = 1, pad=(0, 0)):
        super().__init__()
        w = np.asarray(p["w"], np.float32)          # (kh, kw, in, out)
        kh, kw, cin, cout = w.shape
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride,
                              padding=pad, bias=False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.from_numpy(
                np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
        gamma, beta, mean, var = (
            torch.from_numpy(np.asarray(p[k], np.float32))
            for k in ("gamma", "beta", "mean", "var"))
        # float32, in the JAX module's order of operations
        scale = gamma / torch.sqrt(var + BN_EPS)
        self.register_buffer("scale", scale.view(1, -1, 1, 1))
        self.register_buffer("shift", (beta - mean * scale).view(1, -1, 1, 1))

    def forward(self, x):
        return F.relu(self.conv(x) * self.scale + self.shift)


def _avgpool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class _Block(nn.Module):
    """Named sub-convs of one Inception block; ``pads`` gives each its
    (ph, pw) padding and ``strides`` its stride."""

    def __init__(self, p: dict, pads: dict, strides: dict | None = None):
        super().__init__()
        strides = strides or {}
        self.convs = nn.ModuleDict({
            name: ConvBN(p[name], strides.get(name, 1), pads.get(name, (0, 0)))
            for name in p})

    def c(self, name, x):
        return self.convs[name](x)


class InceptionA(_Block):
    def __init__(self, p):
        super().__init__(p, {"b5_2": (2, 2), "b3_2": (1, 1), "b3_3": (1, 1)})

    def forward(self, x):
        b1 = self.c("b1x1", x)
        b5 = self.c("b5_2", self.c("b5_1", x))
        b3 = self.c("b3_3", self.c("b3_2", self.c("b3_1", x)))
        bp = self.c("bpool", _avgpool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_Block):
    def __init__(self, p):
        super().__init__(p, {"bd_2": (1, 1)}, {"b3": 2, "bd_3": 2})

    def forward(self, x):
        b3 = self.c("b3", x)
        bd = self.c("bd_3", self.c("bd_2", self.c("bd_1", x)))
        return torch.cat([b3, bd, _maxpool3s2(x)], dim=1)


class InceptionC(_Block):
    def __init__(self, p):
        super().__init__(p, {"b7_2": (0, 3), "b7_3": (3, 0), "bd_2": (3, 0),
                             "bd_3": (0, 3), "bd_4": (3, 0), "bd_5": (0, 3)})

    def forward(self, x):
        b1 = self.c("b1x1", x)
        b7 = self.c("b7_3", self.c("b7_2", self.c("b7_1", x)))
        bd = self.c("bd_1", x)
        for name in ("bd_2", "bd_3", "bd_4", "bd_5"):
            bd = self.c(name, bd)
        bp = self.c("bpool", _avgpool(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_Block):
    def __init__(self, p):
        super().__init__(p, {"b7_2": (0, 3), "b7_3": (3, 0)},
                         {"b3_2": 2, "b7_4": 2})

    def forward(self, x):
        b3 = self.c("b3_2", self.c("b3_1", x))
        b7 = self.c("b7_1", x)
        for name in ("b7_2", "b7_3", "b7_4"):
            b7 = self.c(name, b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)


class InceptionE(_Block):
    """``pool`` "avg" for E-1, "max" (3/1/1) for the FID E-2
    (models.py:797-807)."""

    def __init__(self, p, pool: str):
        super().__init__(p, {"b3_2a": (0, 1), "b3_2b": (1, 0),
                             "bd_2": (1, 1), "bd_3a": (0, 1),
                             "bd_3b": (1, 0)})
        self.pool = pool

    def forward(self, x):
        b1 = self.c("b1x1", x)
        b3 = self.c("b3_1", x)
        b3 = torch.cat([self.c("b3_2a", b3), self.c("b3_2b", b3)], dim=1)
        bd = self.c("bd_2", self.c("bd_1", x))
        bd = torch.cat([self.c("bd_3a", bd), self.c("bd_3b", bd)], dim=1)
        bp = (_avgpool(x) if self.pool == "avg"
              else F.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([b1, b3, bd, self.c("bpool", bp)], dim=1)


class InceptionFID(nn.Module):
    """``forward(x01) -> pool3`` (N, 2048); :meth:`outputs` also gives the
    softmax of the 1008-way fc logits when the weights have the fc head."""

    def __init__(self, params: dict):
        super().__init__()
        self.c1 = ConvBN(params["c1"], stride=2)
        self.c2 = ConvBN(params["c2"])
        self.c3 = ConvBN(params["c3"], pad=(1, 1))
        self.c4 = ConvBN(params["c4"])
        self.c5 = ConvBN(params["c5"])
        self.blocks = nn.Sequential(
            InceptionA(params["a1"]), InceptionA(params["a2"]),
            InceptionA(params["a3"]), InceptionB(params["b"]),
            InceptionC(params["c_1"]), InceptionC(params["c_2"]),
            InceptionC(params["c_3"]), InceptionC(params["c_4"]),
            InceptionD(params["d"]), InceptionE(params["e1"], "avg"),
            InceptionE(params["e2"], "max"))
        self.fc = None
        if "fc" in params:
            w = np.asarray(params["fc"]["w"], np.float32)   # (2048, 1008)
            self.fc = nn.Linear(w.shape[0], w.shape[1])
            with torch.no_grad():
                self.fc.weight.copy_(torch.from_numpy(
                    np.ascontiguousarray(w.T)))
                self.fc.bias.copy_(torch.from_numpy(
                    np.asarray(params["fc"]["b"], np.float32)))
        self.requires_grad_(False)

    def forward(self, x01):
        """2048-d pool3 features of NHWC images in [0, 1]."""
        x = x01.float().permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = 2.0 * x - 1.0
        x = self.c3(self.c2(self.c1(x)))
        x = self.c5(self.c4(_maxpool3s2(x)))
        x = self.blocks(_maxpool3s2(x))
        return x.mean(dim=(2, 3))

    def outputs(self, x01):
        """(pool3, softmax of the fc logits) in one forward."""
        pool3 = self(x01)
        return pool3, torch.softmax(self.fc(pool3), dim=-1)


def load_inception_params(path: str) -> dict:
    """The converted npz (flat ``block/leaf`` keys) as a nested dict of
    numpy arrays; non-numeric entries (``provenance``) are skipped."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            val = flat[key]
            if not np.issubdtype(val.dtype, np.number):
                continue
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = val
    return tree


def inception_path(args) -> str:
    return os.path.join(args.output_root, "model", "inception_fid.npz")


def chunked(fns, x01, batch: int, devs):
    """``fns[k]`` (on ``devs[k]``) over sub-batches of ``x01``: ``batch``
    images rounded down to a multiple of the device count (the last one
    ragged), each split over the devices and run at the same time; the
    results concatenated on x01's device, one tensor or a tuple of them."""
    n = len(devs)
    sub = max(n, (batch // n) * n)

    def run(k, part):
        with torch.inference_mode(), mesh.on(devs[k]):
            return fns[k](part.to(devs[k]))

    outs = []
    for i in range(0, x01.shape[0], sub):
        parts = [p for p in torch.tensor_split(x01[i:i + sub], n)
                 if p.shape[0]]
        outs += mesh.fan_out(run, parts)
    if isinstance(outs[0], tuple):
        return tuple(mesh.gather(o, x01.device) for o in zip(*outs))
    return mesh.gather(outs, x01.device)


def _on(dev, x01):
    """``x01`` itself, if it lies on ``dev``: images are never copied to
    another device behind the caller's back."""
    if x01.device != dev:
        raise ValueError(f"images on {x01.device}, the Inception network "
                         f"on {dev}: move them, or ask for that device")
    return x01


def get_inception_fns(args, batch: int = 50, device=None, devices=None):
    """``(feature_fn, outputs_fn)`` on ``device`` (``cuda`` unless asked
    otherwise), or None when the weight file is missing.  ``feature_fn``
    maps (N, H, W, C) images in [0, 1] on that device to (N, 2048) pool3
    features; ``outputs_fn`` maps them to (features, (N, 1008) softmax
    probabilities) in one forward, and is None when the npz has no fc head.
    Both raise on images on another device.  ``devices`` (a list whose
    first entry is that device) fans each sub-batch out over a copy of the
    network on each.  Cached on (path, mtime, devices), the last key asked
    for: a regenerated npz is read again."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # the device a tensor made on "cuda" reports
        dev = torch.device("cuda", torch.cuda.current_device())
    devs = [dev] if devices is None else [torch.device(d) for d in devices]
    if devs[0] != dev:
        raise ValueError(f"devices {devs} do not start with {dev}")
    path = inception_path(args)
    if not os.path.exists(path):
        return None
    key = (path, os.path.getmtime(path), tuple(map(str, devs)))
    if key not in _CACHE:
        _CACHE.clear()
        nets = mesh.replicate(
            InceptionFID(load_inception_params(path)).to(dev).eval(), devs)

        def feature_fn(x01):
            return chunked(nets, _on(dev, x01), batch, devs)

        outputs_fn = None
        if nets[0].fc is not None:
            def outputs_fn(x01):  # noqa: F811
                return chunked([n.outputs for n in nets], _on(dev, x01),
                               batch, devs)

        _CACHE[key] = (feature_fn, outputs_fn)
    return _CACHE[key]
