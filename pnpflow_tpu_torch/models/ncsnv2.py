"""NCSNv1 / NCSNv2 score networks on NHWC tensors (port of
``pnpflow_tpu/models/ncsnv2.py``).

The reference's models (``image_generation/models/ncsnv2.py:43-415``): the
64px NCSNv2, the class-conditional NCSN, and the 128px and 256px NCSNv2:
RefineNet decoders over a dilated residual encoder, InstanceNorm++, and an
output divided by ``sigmas[y]`` (NCSNv2).  The reference cannot build any
of them (its ``bias=False`` conv crashes, and its dilated blocks would
crash next): this follows the JAX package, which runs them with both
repaired (``models/ncsn_layers.py``).

Submodule and parameter names are the JAX modules' (``begin_conv``,
``res1_0``, ``refine1``, ``normalizer``, ``end_conv``, ...), so
``utils/jax_params.py:ncsnv2_state_dict_from_flax`` and its inverse carry
the weights across by path.  :func:`init_ncsnv2` draws a seeded init with
the flax initializers' distributions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from pnpflow_tpu_torch.models import ncsn_layers as L
from pnpflow_tpu_torch.models.normalization import (
    get_normalization, init_norms)


def get_sigmas(sigma_max: float, sigma_min: float, num_scales: int):
    """The geometric noise ladder as float32 (``models/zoo.py``'s)."""
    from pnpflow_tpu_torch.models.zoo import geometric_sigmas

    return geometric_sigmas(sigma_max, sigma_min, num_scales).astype(
        np.float32)


class _RefineNet(nn.Module):
    """The shared body: ``begin_conv``, pairs of residual blocks ``res{tag}_0``
    / ``res{tag}_1`` per encoder stage, RefineBlocks from the deepest stage
    up, ``normalizer``, the activation and ``end_conv``.  ``stages`` lists
    (tag, width multiple, resample, dilation, adjust_padding); ``refines``
    (name, width multiple) from the deepest."""

    conditional = False

    def __init__(self, nf, channels, centered, normalization, nonlinearity,
                 stages, refines, num_classes=None):
        super().__init__()
        self.act = act = L.get_act(nonlinearity)
        if self.conditional:
            norm = get_normalization(normalization, conditional=True,
                                     num_classes=num_classes)
            block, refine = L.ConditionalResidualBlock, L.CondRefineBlock
        else:
            norm = get_normalization(normalization)
            block, refine = L.ResidualBlock, L.RefineBlock
        self.centered = centered
        self.begin_conv = L.ncsn_conv(channels, nf)
        self.tags, widths, cin = [], [], nf
        for tag, mult, resample, dil, adjust in stages:
            self.add_module(f"res{tag}_0", block(
                cin, mult * nf, resample=resample, act=act, norm=norm,
                dilation=dil, adjust_padding=adjust))
            self.add_module(f"res{tag}_1", block(
                mult * nf, mult * nf, act=act, norm=norm, dilation=dil))
            cin = mult * nf
            self.tags.append(tag)
            widths.append(cin)
        self.refines = [name for name, _ in refines]
        prev = None
        for k, (name, mult) in enumerate(refines):
            skip = widths[-1 - k]
            ins = [skip] if prev is None else [skip, prev]
            kw = (dict(start=True) if k == 0 else
                  dict(end=True) if k == len(refines) - 1 else {})
            if self.conditional:
                mod = refine(ins, mult * nf, norm, act, **kw)
            else:
                mod = refine(ins, mult * nf, act, **kw)
            self.add_module(name, mod)
            prev = mult * nf
        self.normalizer = norm(prev)
        self.end_conv = L.ncsn_conv(prev, channels)

    def _body(self, x, y):
        cond = (y,) if self.conditional else ()
        h = x if self.centered else 2.0 * x - 1.0
        h = self.begin_conv(h)
        layers = []
        for tag in self.tags:
            h = getattr(self, f"res{tag}_0")(h, *cond)
            h = getattr(self, f"res{tag}_1")(h, *cond)
            layers.append(h)
        ref = None
        for k, name in enumerate(self.refines):
            skip = layers[-1 - k]
            xs = [skip] if ref is None else [skip, ref]
            ref = getattr(self, name)(xs, *cond, tuple(skip.shape[1:3]))
        out = self.act(self.normalizer(ref, *cond))
        return self.end_conv(out)


class _SigmaScaled(_RefineNet):
    """An NCSNv2: the output divided by ``sigmas[y]``."""

    def __init__(self, sigmas, **kw):
        super().__init__(**kw)
        self.register_buffer("sigmas", torch.tensor(
            np.asarray(sigmas, np.float32)))

    def forward(self, x, y):
        return self._body(x, y) / self.sigmas[y.long()][:, None, None, None]


class NCSNv2(_SigmaScaled):
    """64px NCSNv2 (reference ``ncsnv2.py:43-132``)."""

    def __init__(self, nf: int = 128, channels: int = 3,
                 image_size: int = 64, centered: bool = False,
                 normalization: str = "InstanceNorm++",
                 nonlinearity: str = "elu",
                 sigmas: Sequence[float] = (50.0, 1.0)):
        super().__init__(
            sigmas, nf=nf, channels=channels, centered=centered,
            normalization=normalization, nonlinearity=nonlinearity,
            stages=[("1", 1, None, 1, False), ("2", 2, "down", 1, False),
                    ("3", 2, "down", 2, False),
                    ("4", 2, "down", 4, image_size == 28)],
            refines=[("refine1", 2), ("refine2", 2), ("refine3", 1),
                     ("refine4", 1)])


class NCSN(_RefineNet):
    """Class-conditional NCSNv1 (reference ``ncsnv2.py:135-218``): every
    norm reads per-class rows of ``num_scales`` labels; no sigma scaling."""

    conditional = True

    def __init__(self, nf: int = 128, channels: int = 3,
                 image_size: int = 32, num_scales: int = 10,
                 centered: bool = False,
                 normalization: str = "InstanceNorm++",
                 nonlinearity: str = "elu"):
        super().__init__(
            nf=nf, channels=channels, centered=centered,
            normalization=normalization, nonlinearity=nonlinearity,
            stages=[("1", 1, None, 1, False), ("2", 2, "down", 1, False),
                    ("3", 2, "down", 2, False),
                    ("4", 2, "down", 4, image_size == 28)],
            refines=[("refine1", 2), ("refine2", 2), ("refine3", 1),
                     ("refine4", 1)], num_classes=num_scales)

    def forward(self, x, y):
        return self._body(x, y)


class NCSNv2_128(_SigmaScaled):
    """128px NCSNv2 (reference ``ncsnv2.py:221-312``)."""

    def __init__(self, nf: int = 128, channels: int = 3,
                 centered: bool = False,
                 normalization: str = "InstanceNorm++",
                 nonlinearity: str = "elu",
                 sigmas: Sequence[float] = (190.0, 0.01)):
        super().__init__(
            sigmas, nf=nf, channels=channels, centered=centered,
            normalization=normalization, nonlinearity=nonlinearity,
            stages=[("1", 1, None, 1, False), ("2", 2, "down", 1, False),
                    ("3", 2, "down", 1, False), ("4", 4, "down", 2, False),
                    ("5", 4, "down", 4, False)],
            refines=[("refine1", 4), ("refine2", 2), ("refine3", 2),
                     ("refine4", 1), ("refine5", 1)])


class NCSNv2_256(_SigmaScaled):
    """256px NCSNv2 (reference ``ncsnv2.py:315-415``)."""

    def __init__(self, nf: int = 128, channels: int = 3,
                 centered: bool = False,
                 normalization: str = "InstanceNorm++",
                 nonlinearity: str = "elu",
                 sigmas: Sequence[float] = (348.0, 0.01)):
        super().__init__(
            sigmas, nf=nf, channels=channels, centered=centered,
            normalization=normalization, nonlinearity=nonlinearity,
            stages=[("1", 1, None, 1, False), ("2", 2, "down", 1, False),
                    ("3", 2, "down", 1, False), ("31", 2, "down", 1, False),
                    ("4", 4, "down", 2, False), ("5", 4, "down", 4, False)],
            refines=[("refine1", 4), ("refine2", 2), ("refine31", 2),
                     ("refine3", 2), ("refine4", 1), ("refine5", 1)])


def get_network(image_size: int):
    """The class for an image size (reference ``ncsnv2.py:31-40``)."""
    if image_size < 96:
        return NCSNv2
    if 96 <= image_size <= 128:
        return NCSNv2_128
    if 128 < image_size <= 256:
        return NCSNv2_256
    raise NotImplementedError(
        "No network suitable for {}px implemented yet.".format(image_size))


@torch.no_grad()
def init_ncsnv2(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init with the flax initializers' distributions: the convs
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the norms' gains N(1, 0.02^2) and
    their tables as ``models/normalization.py`` says.  Draws from a CPU
    generator."""
    gen = torch.Generator().manual_seed(int(seed))
    L.init_ncsn(model, gen)
    init_norms(model, gen)
    return model
