"""The port's score-model zoo against the JAX package's on the same weights
and inputs: every normalization, every ``ncsn_layers`` block, DDPM (the
port's reference-layout weights carried to JAX by JAX's own
``convert_ddpm_state_dict``), NCSN and NCSNv2 at 64, 128 and 256 (JAX's
weights carried to the port by ``ncsnv2_state_dict_from_flax``), and the
NCSN++ built from the RF configs with ``fir`` True and False; the zoo's
schedules and registry.

Weights are drawn at a real scale from a numpy seed (the seeded inits leave
outputs near zero).  Bound: every forward within 1e-5 of max|out| (float32
rounding through these depths stays near 1e-6; a wrong layout, tap or
padding is O(1)); the schedules equal in float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import flax.linen as fnn

from pnpflow_tpu.config import rf_configs as jcfg
from pnpflow_tpu.models import ddpm as jddpm
from pnpflow_tpu.models import ncsn_layers as JL
from pnpflow_tpu.models import ncsnv2 as jncsnv2
from pnpflow_tpu.models import normalization as JN
from pnpflow_tpu.models import zoo as jzoo
from pnpflow_tpu.models.ncsnpp import make_ncsnpp_from_config as jmake
from pnpflow_tpu.utils.ddpm_convert import convert_ddpm_state_dict
from pnpflow_tpu_torch.config import rf_configs as tcfg
from pnpflow_tpu_torch.models import ddpm as tddpm
from pnpflow_tpu_torch.models import ncsn_layers as TL
from pnpflow_tpu_torch.models import ncsnv2 as tncsnv2
from pnpflow_tpu_torch.models import normalization as TN
from pnpflow_tpu_torch.models import zoo as tzoo
from pnpflow_tpu_torch.models.ncsnpp import make_ncsnpp_from_config as tmake
from pnpflow_tpu_torch.utils.jax_params import (
    flax_from_ncsnpp_state_dict, flax_from_ncsnv2_state_dict,
    ncsnpp_state_dict_from_flax, ncsnv2_state_dict_from_flax)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomized(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if name.endswith("['kernel']") or name.endswith("['W']"):
            fan_in = max(int(np.prod(shape[:-1])), 1)
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif any(name.endswith(f"['{k}']") for k in
                 ("scale", "alpha", "gamma")):
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name.endswith("['embed']"):
            v = 0.5 + 0.3 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _jax_params(module, *args, seed=0):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))
    return _randomized(shapes, seed)


def _load(tm, params):
    sd = ncsnv2_state_dict_from_flax(params)
    if "sigmas" in tm.state_dict():
        sd["sigmas"] = tm.sigmas
    tm.load_state_dict(sd)
    return tm.eval()


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3, scale
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(jm, tm, args, seed=0, tol=TOL):
    params = _jax_params(jm, *args, seed=seed)
    want = jax.jit(jm.apply)(params, *args)
    with torch.no_grad():
        got = _load(tm, params)(*[torch.as_tensor(np.asarray(a))
                                  for a in args])
    _close(got, want, tol)
    return params


# ------------------------------------------------------------ normalization
NORMS = [
    ("InstanceNorm2d", lambda: JN.InstanceNorm2d(), TN.InstanceNorm2d),
    ("VarianceNorm2d", lambda: JN.VarianceNorm2d(), TN.VarianceNorm2d),
    ("NoneNorm2d", lambda: JN.NoneNorm2d(), TN.NoneNorm2d),
    ("InstanceNorm2dPlus", lambda: JN.InstanceNorm2dPlus(),
     TN.InstanceNorm2dPlus),
    ("InstanceNorm2dPlus_nobias", lambda: JN.InstanceNorm2dPlus(bias=False),
     functools.partial(TN.InstanceNorm2dPlus, bias=False)),
    ("GroupNorm32", lambda: JN.GroupNorm32(), TN.GroupNorm32),
]
COND_NORMS = [
    (JN.ConditionalInstanceNorm2dPlus, TN.ConditionalInstanceNorm2dPlus),
    (JN.ConditionalInstanceNorm2d, TN.ConditionalInstanceNorm2d),
    (JN.ConditionalVarianceNorm2d, TN.ConditionalVarianceNorm2d),
    (JN.ConditionalNoneNorm2d, TN.ConditionalNoneNorm2d),
]


@pytest.mark.parametrize("name,jm,tm", NORMS, ids=[n[0] for n in NORMS])
def test_normalization_matches_jax(name, jm, tm):
    x = 1.5 + _x((2, 6, 5, 64), 1)
    _both(jm(), tm(64), (x,))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("jm,tm", COND_NORMS,
                         ids=[c[0].__name__ for c in COND_NORMS])
def test_conditional_normalization_matches_jax(jm, tm, bias):
    x = 1.5 + _x((3, 6, 5, 8), 2)
    y = np.asarray([0, 4, 2])
    _both(jm(num_classes=5, bias=bias), tm(8, num_classes=5, bias=bias),
          (x, y))


def test_get_normalization_and_seeded_init():
    assert TN.get_normalization("InstanceNorm++") is TN.InstanceNorm2dPlus
    assert TN.get_normalization("GroupNorm") is TN.GroupNorm32
    cond = TN.get_normalization("InstanceNorm++", True, 7)(4)
    assert cond.embed_ga.embed.shape == (7, 8)
    with pytest.raises(NotImplementedError):
        TN.get_normalization("GroupNorm", conditional=True)
    with pytest.raises(ValueError):
        TN.get_normalization("BatchNorm")
    m = torch.nn.ModuleList([TN.InstanceNorm2dPlus(256),
                             TN.ConditionalInstanceNorm2d(256, 5)])
    TN.init_norms(m, torch.Generator().manual_seed(0))
    a = m[0].alpha.detach().numpy()
    assert abs(a.mean() - 1.0) < 0.01 and 0.01 < a.std() < 0.03
    assert float(m[0].beta.detach().abs().max()) == 0.0
    t = m[1].embed.embed.detach().numpy()
    assert (t[:, 256:] == 0).all() and 0 <= t[:, :256].min()
    assert t[:, :256].max() < 1


# ------------------------------------------------------------ ncsn layers
def _cond_norms(k=5):
    return (functools.partial(JN.ConditionalInstanceNorm2dPlus,
                              num_classes=k),
            functools.partial(TN.ConditionalInstanceNorm2dPlus,
                              num_classes=k))


def test_pools_and_bilinear_match_jax():
    x = _x((2, 9, 7, 3), 3)
    xt = torch.from_numpy(x)
    for jf, tf in ((JL.max_pool_5x5, TL.max_pool_5x5),
                   (JL.avg_pool_5x5, TL.avg_pool_5x5)):
        _close(tf(xt), jf(jnp.asarray(x)))
    x = _x((2, 8, 6, 3), 4)
    _close(TL.avg_pool_2x2(torch.from_numpy(x)), JL.avg_pool_2x2(x))
    for hw in ((16, 11), (4, 3), (8, 6)):
        _close(TL.interpolate_bilinear_ac(torch.from_numpy(x), hw),
               JL.interpolate_bilinear_ac(jnp.asarray(x), hw))
    assert TL.get_act("swish") is F.silu and TL.get_act("ELU") is F.elu
    with pytest.raises(NotImplementedError):
        TL.get_act("gelu")


def _blocks():
    jcn, tcn = _cond_norms()
    x8 = _x((2, 8, 8, 8), 5)
    x4 = _x((2, 4, 4, 8), 6)
    y = np.asarray([1, 3])
    return [
        ("crp_max", JL.CRPBlock(8, 2, fnn.relu, True),
         TL.CRPBlock(8, 2, F.relu, True), (x8,)),
        ("crp_avg", JL.CRPBlock(8, 2, fnn.elu, False),
         TL.CRPBlock(8, 2, F.elu, False), (x8,)),
        ("cond_crp", JL.CondCRPBlock(8, 2, jcn, fnn.relu),
         TL.CondCRPBlock(8, 2, tcn, F.relu), (x8, y)),
        ("rcu", JL.RCUBlock(8, 2, 2, fnn.elu), TL.RCUBlock(8, 2, 2, F.elu),
         (x8,)),
        ("cond_rcu", JL.CondRCUBlock(8, 2, 2, jcn, fnn.elu),
         TL.CondRCUBlock(8, 2, 2, tcn, F.elu), (x8, y)),
        ("conv_mean_pool", JL.ConvMeanPool(6, 3),
         TL.ConvMeanPool(8, 6, 3), (x8,)),
        ("conv_mean_pool_adjust", JL.ConvMeanPool(6, 3, adjust_padding=True),
         TL.ConvMeanPool(8, 6, 3, adjust_padding=True),
         (_x((2, 7, 7, 8), 7),)),
        ("mean_pool_conv", JL.MeanPoolConv(6, 3, biases=False),
         TL.MeanPoolConv(8, 6, 3, biases=False), (x8,)),
        ("upsample_conv", JL.UpsampleConv(6, 3), TL.UpsampleConv(8, 6, 3),
         (x4,)),
    ]


_BLOCKS = _blocks()


@pytest.mark.parametrize("name,jm,tm,args", _BLOCKS,
                         ids=[b[0] for b in _BLOCKS])
def test_ncsn_block_matches_jax(name, jm, tm, args):
    _both(jm, tm, args)


def test_msf_and_refine_blocks_match_jax():
    xs = [_x((2, 8, 8, 6), 8), _x((2, 4, 4, 4), 9)]
    jx = [jnp.asarray(a) for a in xs]
    tx = [torch.from_numpy(a) for a in xs]
    y = np.asarray([0, 2])
    jcn, tcn = _cond_norms()
    cases = [
        (JL.MSFBlock(8), TL.MSFBlock([6, 4], 8), (jx, (8, 8)), (tx, (8, 8))),
        (JL.CondMSFBlock(8, jcn), TL.CondMSFBlock([6, 4], 8, tcn),
         (jx, y, (8, 8)), (tx, torch.from_numpy(y), (8, 8))),
        (JL.RefineBlock(6, fnn.relu), TL.RefineBlock([6, 4], 6, F.relu),
         (jx, (8, 8)), (tx, (8, 8))),
        (JL.RefineBlock(6, fnn.elu, end=True, maxpool=False),
         TL.RefineBlock([6, 4], 6, F.elu, end=True, maxpool=False),
         (jx, (8, 8)), (tx, (8, 8))),
        (JL.RefineBlock(6, fnn.elu, start=True),
         TL.RefineBlock([6], 6, F.elu, start=True), (jx[:1], (8, 8)),
         (tx[:1], (8, 8))),
        (JL.CondRefineBlock(6, jcn, fnn.elu, end=True),
         TL.CondRefineBlock([6, 4], 6, tcn, F.elu, end=True),
         (jx, y, (8, 8)), (tx, torch.from_numpy(y), (8, 8))),
    ]
    for i, (jm, tm, jargs, targs) in enumerate(cases):
        params = _jax_params(jm, *jargs, seed=i)
        with torch.no_grad():
            got = _load(tm, params)(*targs)
        _close(got, jax.jit(lambda p: jm.apply(p, *jargs))(params))


RES = [(resample, dil, feats) for resample in (None, "down")
       for dil in (1, 2) for feats in (8, 12)]


@pytest.mark.parametrize("resample,dilation,features", RES)
def test_residual_block_matches_jax(resample, dilation, features):
    x = _x((2, 8, 8, 8), 10)
    jm = JL.ResidualBlock(features, resample=resample, act=fnn.elu,
                          norm=JN.InstanceNorm2dPlus, dilation=dilation)
    tm = TL.ResidualBlock(8, features, resample=resample, act=F.elu,
                          norm=TN.InstanceNorm2dPlus, dilation=dilation)
    _both(jm, tm, (x,))


@pytest.mark.parametrize("resample,adjust", [(None, False), ("down", True)])
def test_conditional_residual_block_matches_jax(resample, adjust):
    jcn, tcn = _cond_norms()
    x = _x((2, 7, 7, 8), 11) if adjust else _x((2, 8, 8, 8), 11)
    y = np.asarray([4, 0])
    jm = JL.ConditionalResidualBlock(12, resample=resample, act=fnn.elu,
                                     norm=jcn, adjust_padding=adjust)
    tm = TL.ConditionalResidualBlock(8, 12, resample=resample, act=F.elu,
                                     norm=tcn, adjust_padding=adjust)
    _both(jm, tm, (x, y))


# ------------------------------------------------------------ models
def test_ddpm_reference_layout_matches_jax():
    """The port's DDPM state_dict (the reference layout) through JAX's
    ``convert_ddpm_state_dict``: the two forwards agree, with
    scale_by_sigma; every parameter lands in the JAX tree."""
    kw = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1,
              attn_resolutions=(8,), image_size=16, dropout=0.0,
              centered=False, scale_by_sigma=True,
              sigmas=tuple(jzoo.geometric_sigmas(50.0, 0.01, 10)))
    tm = tddpm.DDPM(**kw)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=gen)
                        / p[0].numel() ** 0.5)
            elif name.endswith(".weight"):      # a GroupNorm's scale
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    sd = tm.state_dict()
    assert "sigmas" in sd and "all_modules.0.weight" in sd
    params = convert_ddpm_state_dict(
        {k: v.numpy() for k, v in sd.items()}, nf=32, ch_mult=(1, 2),
        num_res_blocks=1, attn_resolutions=(8,), image_size=16)
    n_flax = sum(v.size for v in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(v.numel() for k, v in sd.items() if k != "sigmas")
    x = _x((2, 16, 16, 3), 12)
    labels = np.asarray([3, 7])
    want = jax.jit(jddpm.DDPM(**kw).apply)(params, x, labels)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(labels))
    _close(got, want)
    fresh = tddpm.DDPM(**kw)
    fresh.load_state_dict(sd)   # strict: the reference layout round-trips


NCSNV2 = [
    ("ncsnv2_64", lambda s: jncsnv2.NCSNv2(nf=16, image_size=16, sigmas=s),
     lambda s: tncsnv2.NCSNv2(nf=16, image_size=16, sigmas=s), 16),
    ("ncsnv2_128", lambda s: jncsnv2.NCSNv2_128(nf=8, sigmas=s),
     lambda s: tncsnv2.NCSNv2_128(nf=8, sigmas=s), 32),
    ("ncsnv2_256", lambda s: jncsnv2.NCSNv2_256(nf=8, sigmas=s),
     lambda s: tncsnv2.NCSNv2_256(nf=8, sigmas=s), 32),
]


@pytest.mark.parametrize("name,jm,tm,dim", NCSNV2,
                         ids=[n[0] for n in NCSNV2])
def test_ncsnv2_matches_jax(name, jm, tm, dim):
    sig = tuple(jncsnv2.get_sigmas(50.0, 0.01, 10))
    x = np.random.default_rng(13).uniform(size=(2, dim, dim, 3)).astype(
        np.float32)
    y = np.asarray([0, 9])
    params = _both(jm(sig), tm(sig), (x, y))
    back = flax_from_ncsnv2_state_dict(_load(tm(sig), params).state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_ncsn_conditional_matches_jax():
    x = np.random.default_rng(14).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    _both(jncsnv2.NCSN(nf=16, image_size=16, num_scales=5),
          tncsnv2.NCSN(nf=16, image_size=16, num_scales=5),
          (x, np.asarray([0, 4])))


def _rf_cfg(pkg, name, **over):
    cfg = pkg.get_config(name)
    for key, v in over.items():
        sec, k = key.split("__")
        cfg[sec][k] = v
    return cfg


TINY = dict(data__image_size=16, model__nf=16, model__ch_mult=(1, 2),
            model__num_res_blocks=1, model__attn_resolutions=(8,))
NCSNPP = [
    ("celeba_fir", "celeba_hq_pytorch_rf_gaussian", {}),
    ("cifar10_ddpmpp_nofir", "cifar10_rf_gaussian_ddpmpp", {}),
    ("ddpm_blocks_fir", "celeba_hq_pytorch_rf_gaussian",
     dict(model__resblock_type="ddpm", model__progressive="none",
          model__progressive_input="none", model__embedding_type="positional",
          model__scale_by_sigma=True, data__centered=False)),
]


@pytest.mark.parametrize("name,config,over", NCSNPP,
                         ids=[n[0] for n in NCSNPP])
def test_ncsnpp_from_config_matches_jax(name, config, over):
    jc = _rf_cfg(jcfg, config, **TINY, **over)
    tc = _rf_cfg(tcfg, config, **TINY, **over)
    jm, tm = jmake(jc), tmake(tc)
    assert tm.resblock_type == jc.model.get("resblock_type", "biggan")
    x = _x((2, 16, 16, 3), 15)
    t = np.asarray([3.0, 250.0], np.float32)
    params = _jax_params(jm, x, t, seed=16)
    tm.load_state_dict(ncsnpp_state_dict_from_flax(params, tm.sigmas))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(t))
    _close(got, jax.jit(jm.apply)(params, x, t))
    back = flax_from_ncsnpp_state_dict(tm.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


# ------------------------------------------------------------ the zoo
def test_sigmas_and_ddpm_params_equal_jax():
    cfg_t = tcfg.get_config("cifar10_rf_gaussian_ddpmpp")
    cfg_j = jcfg.get_config("cifar10_rf_gaussian_ddpmpp")
    a, b = tzoo.get_sigmas(cfg_t), jzoo.get_sigmas(cfg_j)
    assert a.dtype == np.float64 and np.array_equal(a, b)
    assert np.array_equal(tncsnv2.get_sigmas(50, 0.01, 10),
                          jncsnv2.get_sigmas(50, 0.01, 10))
    pa, pb = tzoo.get_ddpm_params(cfg_t), jzoo.get_ddpm_params(cfg_j)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert np.asarray(pa[k]).dtype == np.asarray(pb[k]).dtype
        assert np.array_equal(pa[k], pb[k]), k


def test_create_model_dispatch_and_registry():
    cfg = tcfg.get_config("cifar10_rf_gaussian_ddpmpp")
    cfg.data.image_size, cfg.model.nf = 16, 32
    cfg.model.ch_mult, cfg.model.num_res_blocks = (1, 2), 1
    cfg.model.attn_resolutions = (8,)
    for name, cls in (("ddpm", tddpm.DDPM), ("ncsnv2_64", tncsnv2.NCSNv2),
                      ("ncsn", tncsnv2.NCSN)):
        cfg.model.name = name
        cfg.model.normalization = "InstanceNorm++"
        m = tzoo.create_model(cfg)
        assert type(m) is cls and tzoo.get_model(name) is cls
        tzoo.init_model(m, seed=1)
        assert all(bool(torch.isfinite(p).all()) for p in m.parameters())
    assert tzoo.get_model("ncsnv2_256") is tncsnv2.NCSNv2_256
    assert tncsnv2.get_network(64) is tncsnv2.NCSNv2
    assert tncsnv2.get_network(128) is tncsnv2.NCSNv2_128
    assert tncsnv2.get_network(256) is tncsnv2.NCSNv2_256
    with pytest.raises(NotImplementedError):
        tncsnv2.get_network(512)
    cfg.model.name = "nope"
    with pytest.raises(ValueError):
        tzoo.create_model(cfg)

    @tzoo.register_model(name="my_model")
    class Mine(torch.nn.Module):
        pass

    assert tzoo.get_model("my_model") is Mine
    with pytest.raises(ValueError, match="Already registered"):
        tzoo.register_model(Mine, name="my_model")
    del tzoo._MODELS["my_model"]
