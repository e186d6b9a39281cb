"""The score-model zoo (port of ``pnpflow_tpu/models/zoo.py``).

The reference's ``register_model`` / ``get_model`` / ``create_model``
surface (``image_generation/models/utils.py:24-103``) for the families
``ddpm``, ``ncsn``, ``ncsnv2_64`` / ``_128`` / ``_256`` and ``ncsnpp``, with
the port's modules.  ``create_model`` builds the module that
``config.model.name`` names from the ``model.*`` / ``data.*`` keys, with the
same dispatch as JAX's; ``init_model`` gives it its seeded weights.  Also
``get_sigmas`` and ``get_ddpm_params`` (``utils.py:52-88``), in float64.
"""

from __future__ import annotations

import numpy as np
import torch

_MODELS = {}


def register_model(cls=None, *, name=None):
    """Decorator registry (reference ``utils.py:27-44``)."""

    def _register(cls):
        local_name = cls.__name__ if name is None else name
        if local_name in _MODELS:
            raise ValueError(
                "Already registered model with name: {}".format(local_name))
        _MODELS[local_name] = cls
        return cls

    return _register if cls is None else _register(cls)


def get_model(name):
    _ensure_populated()
    return _MODELS[name]


def geometric_sigmas(sigma_max: float, sigma_min: float, num_scales: int):
    """The geometric SMLD noise ladder (reference ``utils.py:52-62``), in
    float64."""
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min),
                              num_scales))


def get_sigmas(config):
    """The config's ladder, float64 as the reference's."""
    return geometric_sigmas(config.model.sigma_max, config.model.sigma_min,
                            config.model.num_scales)


def get_ddpm_params(config):
    """The original DDPM's beta / alpha schedules (reference
    ``utils.py:65-88``), float64."""
    num_diffusion_timesteps = 1000
    beta_start = config.model.beta_min / config.model.num_scales
    beta_end = config.model.beta_max / config.model.num_scales
    betas = np.linspace(beta_start, beta_end, num_diffusion_timesteps,
                        dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    return {
        "betas": betas,
        "alphas": alphas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "beta_min": beta_start * (num_diffusion_timesteps - 1),
        "beta_max": beta_end * (num_diffusion_timesteps - 1),
        "num_diffusion_timesteps": num_diffusion_timesteps,
    }


_BUILTINS_REGISTERED = False


def _ensure_populated():
    """Register the built-ins at first use, under their own flag, so a user
    registration does not suppress them."""
    global _BUILTINS_REGISTERED
    if _BUILTINS_REGISTERED:
        return
    _BUILTINS_REGISTERED = True
    from pnpflow_tpu_torch.models import ddpm, ncsnpp, ncsnv2

    _MODELS["ddpm"] = ddpm.DDPM
    _MODELS["ncsn"] = ncsnv2.NCSN
    _MODELS["ncsnv2_64"] = ncsnv2.NCSNv2
    _MODELS["ncsnv2_128"] = ncsnv2.NCSNv2_128
    _MODELS["ncsnv2_256"] = ncsnv2.NCSNv2_256
    _MODELS["ncsnpp"] = ncsnpp.NCSNpp


def create_model(config, dtype=torch.float32):
    """The module ``config.model.name`` names, built from the reference-
    shaped config tree (reference ``utils.py:91-103``).  ``dtype`` is the
    NCSN++'s compute dtype; the other families compute in their
    parameters' float32."""
    _ensure_populated()
    name = config.model.name
    m, d = config.model, config.data
    if name == "ddpm":
        return get_model(name)(
            nf=m.nf, ch_mult=tuple(m.ch_mult),
            num_res_blocks=m.num_res_blocks,
            attn_resolutions=tuple(m.attn_resolutions), dropout=m.dropout,
            resamp_with_conv=m.resamp_with_conv, conditional=m.conditional,
            image_size=d.image_size, channels=d.num_channels,
            centered=d.centered, scale_by_sigma=m.scale_by_sigma,
            nonlinearity=m.nonlinearity, sigmas=tuple(get_sigmas(config)))
    if name == "ncsn":
        return get_model(name)(
            nf=m.nf, channels=d.num_channels, image_size=d.image_size,
            num_scales=m.num_scales, centered=d.centered,
            normalization=m.normalization, nonlinearity=m.nonlinearity)
    if name in ("ncsnv2_64", "ncsnv2_128", "ncsnv2_256"):
        kwargs = dict(nf=m.nf, channels=d.num_channels, centered=d.centered,
                      normalization=m.normalization,
                      nonlinearity=m.nonlinearity,
                      sigmas=tuple(get_sigmas(config)))
        if name == "ncsnv2_64":
            kwargs["image_size"] = d.image_size
        return get_model(name)(**kwargs)
    if name == "ncsnpp":
        from pnpflow_tpu_torch.models.ncsnpp import make_ncsnpp_from_config

        return make_ncsnpp_from_config(config, dtype=dtype)
    raise ValueError("Unknown model name: {}".format(name))


def init_model(model, seed: int = 0):
    """Seeded weights for any zoo module (a CPU ``torch.Generator``): the
    NCSN++ and DDPM by the JAX ``vs_init``'s variance scaling
    (``models/ncsnpp.py:init_ncsnpp``), the NCSN family by its convs' and
    norms' own distributions (``models/ncsnv2.py:init_ncsnv2``)."""
    from pnpflow_tpu_torch.models.ddpm import DDPM
    from pnpflow_tpu_torch.models.ncsnpp import NCSNpp, init_ncsnpp
    from pnpflow_tpu_torch.models.ncsnv2 import init_ncsnv2

    if isinstance(model, (NCSNpp, DDPM)):
        return init_ncsnpp(model, seed=seed)
    return init_ncsnv2(model, seed=seed)
