"""The port's kernels and models under reverse- and forward-mode autodiff,
against the JAX package on the same parameters and inputs.

On the CPU every wrapper runs its plain version, so these tests check the
autograd rules themselves: that the GroupNorm and FIR entries go through
their autograd functions whenever a gradient, a ``torch.func`` transform or
a forward-AD tangent is present (on the card the bare forward would drop
it), the GroupNorm forward-mode rule, and the FIR adjoint geometry.

Bounds: U-Net VJP within 1e-5 of max|grad| (JAX ``fused_norm True``, whose
``custom_vjp`` backward the port copies); U-Net JVP within 5e-5 of max|jvp|
against JAX ``False`` (JAX's ``custom_vjp`` refuses ``jax.jvp``, and the
function is the same); the gradient of the Hutchinson trace term within
1e-4 of its max; the FIR adjoint within 1e-6 of max(1, max|dx|), a few
float32 ulps (at the up sites the adjoint sums 16 taps of up to 0.56 into
gradients near 5, where an ulp is 4.8e-7); the NCSN++ VJP within 2e-5 of
max|grad|, the NCSN++ forward's bound.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from pnpflow_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from pnpflow_tpu.models.unet import VelocityUNet as JaxUNet
from pnpflow_tpu.ops.upfirdn import upfirdn2d_xla
from pnpflow_tpu_torch.models.ncsnpp import NCSNpp
from pnpflow_tpu_torch.models.unet import VelocityUNet
from pnpflow_tpu_torch.ops import upfirdn as fir_mod
from pnpflow_tpu_torch.ops.gn_swish import (
    _GroupNormSwish, gn_swish_reference, groupnorm_swish)
from pnpflow_tpu_torch.ops.gn_swish_bm import _GroupNormSwishBM
from pnpflow_tpu_torch.ops.upfirdn import (
    adjoint_geometry, fir_plan, setup_kernel, upfirdn2d, upfirdn2d_reference)
from pnpflow_tpu_torch.utils.jax_params import (
    ncsnpp_state_dict_from_flax, state_dict_from_flax)

CFG = dict(input_channels=3, input_height=32, ch=32, ch_mult=(1, 2),
           num_res_blocks=1, attn_resolutions=(16,))
NCSNPP = dict(image_size=32, num_channels=3, nf=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(16,))
B = 2
FUNCTIONS = {True: _GroupNormSwish, "bm": _GroupNormSwishBM}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's CPU work: the test runner
    runs several files side by side on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomized(shapes, seed):
    """Every leaf random at a real scale (the seeded init's output convs are
    near zero, which would make a gradient comparison vacuous)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif "bias" in name or name.endswith("['b']"):
            v = 0.1 * rng.normal(size=leaf.shape)
        else:
            v = rng.normal(size=leaf.shape) / np.sqrt(
                max(int(np.prod(leaf.shape[:-1])), 1))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _unet_case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    t = rng.uniform(0.1, 0.9, size=(B,)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    shapes = jax.eval_shape(JaxUNet(**CFG).init, jax.random.PRNGKey(0), x, t)
    return _randomized(shapes, 1), x, t, dy


def _port_unet(params, fused):
    m = VelocityUNet(**CFG, fused_norm=fused)
    m.load_state_dict(state_dict_from_flax(params))
    return m.eval().requires_grad_(False)


def _gn_sites(model):
    return sum(isinstance(m, nn.GroupNorm) for m in model.modules())


@pytest.mark.parametrize("fused", [True, "bm"])
def test_unet_vjp_matches_jax(fused):
    params, x, t, dy = _unet_case()
    jm = JaxUNet(**CFG, fused_norm=True)
    _, vjp = jax.vjp(lambda z: jm.apply(params, z, t), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])

    m = _port_unet(params, fused)
    tx = torch.from_numpy(x).requires_grad_()
    v = m(tx, torch.from_numpy(t))
    (got,) = torch.autograd.grad(v, tx, torch.from_numpy(dy))
    scale = np.abs(want).max()
    assert scale > 1e-2
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("fused", [True, "bm"])
def test_unet_jvp_matches_jax(fused):
    params, x, t, dx = _unet_case()
    jm = JaxUNet(**CFG, fused_norm=False)
    _, want = jax.jvp(lambda z: jm.apply(params, z, t), (jnp.asarray(x),),
                      (jnp.asarray(dx),))
    want = np.asarray(want)

    m = _port_unet(params, fused)
    tt = torch.from_numpy(t)
    _, got = torch.func.jvp(lambda z: m(z, tt), (torch.from_numpy(x),),
                            (torch.from_numpy(dx),))
    scale = np.abs(want).max()
    assert scale > 1e-2
    assert np.abs(got.numpy() - want).max() <= 5e-5 * scale


def test_hutchinson_trace_gradient_matches_jax():
    """d/dx of sum_b <eps, (dv/dx) eps>, the trace term of flow_priors, one
    Rademacher probe shared by both packages."""
    params, x, t, _ = _unet_case()
    eps = np.where(np.random.default_rng(3).uniform(size=x.shape) < 0.5,
                   -1.0, 1.0).astype(np.float32)
    jm = JaxUNet(**CFG, fused_norm=False)

    def jtrace(z):
        _, jv = jax.jvp(lambda u: jm.apply(params, u, t), (z,),
                        (jnp.asarray(eps),))
        return jnp.sum(jv * eps)

    want = np.asarray(jax.grad(jtrace)(jnp.asarray(x)))

    m = _port_unet(params, True)
    tt, te = torch.from_numpy(t), torch.from_numpy(eps)

    def trace(z):
        _, jv = torch.func.jvp(lambda u: m(u, tt), (z,), (te,))
        return (jv * te).sum()

    got = torch.func.grad(trace)(torch.from_numpy(x))
    scale = np.abs(want).max()
    assert scale > 1e-3
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale


def _vjp(f, x, w):
    xr = x.clone().requires_grad_()
    (g,) = torch.autograd.grad((f(xr) * w).sum(), xr)
    return g


def _jvp(f, x, w):
    return torch.func.jvp(f, (x,), (w,))[1]


def _grad_of_jvp(f, x, w):
    """The shape of flow_priors' loss: the primal and the tangent of one
    JVP inside a gradient."""
    def loss(z):
        v, jv = torch.func.jvp(f, (z,), (w,))
        return (v * w).sum() + (jv * w).sum()

    return torch.func.grad(loss)(x)


def _autograd_of_jvp(f, x, w):
    """flow_priors' own form: the JVP on an x that records a gradient,
    then ``torch.autograd.grad``."""
    xr = x.clone().requires_grad_()
    v, jv = torch.func.jvp(f, (xr,), (w,))
    (g,) = torch.autograd.grad((v * w).sum() + (jv * w).sum(), xr)
    return g


def _forward_ad(f, x, w):
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        return fwAD.unpack_dual(f(fwAD.make_dual(x, w))).tangent


# (transform, backward calls, jvp calls), per GroupNorm site
TRANSFORMS = {"autograd.grad": (_vjp, 1, 0), "func.jvp": (_jvp, 0, 1),
              "func.grad_of_jvp": (_grad_of_jvp, 1, 1),
              "autograd_of_func.jvp": (_autograd_of_jvp, 1, 1),
              "forward_ad": (_forward_ad, 0, 1)}


@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
@pytest.mark.parametrize("fused", [True, "bm"])
def test_groupnorm_autograd_function_runs_under_each_transform(fused,
                                                               transform):
    """Every GroupNorm of a forward goes through the entry's autograd
    function and its rules, once per site: on the card a bypass would run
    the bare kernel launch, which records no gradient and sees no
    tangent."""
    params, x, t, w = _unet_case()
    m = _port_unet(params, fused)
    fn, n_bwd, n_jvp = TRANSFORMS[transform]
    cls = FUNCTIONS[fused]
    cls.backward_calls = cls.jvp_calls = 0
    tt = torch.from_numpy(t)
    out = fn(lambda z: m(z, tt), torch.from_numpy(x), torch.from_numpy(w))
    sites = _gn_sites(m)
    assert torch.isfinite(out).all()
    assert (cls.backward_calls, cls.jvp_calls) == (n_bwd * sites,
                                                   n_jvp * sites)


def test_groupnorm_forward_alone_without_anything_to_differentiate():
    x = torch.randn(2, 4, 4, 64)
    s, b = torch.ones(64), torch.zeros(64)
    _GroupNormSwish.backward_calls = _GroupNormSwish.jvp_calls = 0
    with torch.no_grad():
        y = groupnorm_swish(x.requires_grad_(), s, b)
    assert y.grad_fn is None
    y = groupnorm_swish(x.detach(), s, b)
    assert y.grad_fn is None
    y = groupnorm_swish(x.detach().requires_grad_(), s, b)
    assert type(y.grad_fn).__name__ == "_GroupNormSwishBackward"


@pytest.mark.parametrize("swish", [True, False])
def test_groupnorm_jvp_rule_with_parameter_tangents(swish):
    """The forward-mode rule in all three tangents against forward AD
    through the plain version."""
    g = torch.Generator().manual_seed(4)
    x, dx = (torch.randn(2, 4, 4, 64, generator=g) for _ in range(2))
    s, ds, b, db = (torch.randn(64, generator=g) for _ in range(4))
    s = s * 0.2 + 1.0
    f = functools.partial(groupnorm_swish, num_groups=32, eps=1e-6,
                          swish=swish)
    r = functools.partial(gn_swish_reference, num_groups=32, eps=1e-6,
                          swish=swish)
    _, got = torch.func.jvp(f, (x, s, b), (dx, ds, db))
    _, want = torch.func.jvp(r, (x, s, b), (dx, ds, db))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("transform", ["func.jvp", "forward_ad",
                                       "func.grad_of_jvp"])
def test_conv_mode_refuses_forward_mode(transform):
    params, x, t, w = _unet_case()
    m = _port_unet(params, "conv")
    tt = torch.from_numpy(t)
    fn = TRANSFORMS[transform][0]
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(lambda z: m(z, tt), torch.from_numpy(x), torch.from_numpy(w))


# ---------------------------------------------------------------- upfirdn2d
@functools.lru_cache(maxsize=None)
def ncsnpp_fir_sites():
    """Every distinct upfirdn2d geometry of one NCSN++ 256^2 forward
    (h, w, up, down, pad, taps, narrow), recorded at a narrow width, where
    ``narrow`` marks the C = 3 image pyramids."""
    real, sites = fir_mod._upfirdn2d, []

    def record(x, k, up, down, pad, role):
        sites.append((x.shape[1], x.shape[2], up, down, pad,
                      tuple(np.asarray(k, np.float32).ravel()),
                      x.shape[3] == 3))
        return real(x, k, up, down, pad, role)

    fir_mod._upfirdn2d = record
    try:
        with torch.no_grad():
            NCSNpp(image_size=256, nf=16).eval()(
                torch.zeros(1, 256, 256, 3), torch.full((1,), 500.0))
    finally:
        fir_mod._upfirdn2d = real
    assert len(sites) == 36
    distinct = sorted(set(sites))
    assert len(distinct) == 24
    return distinct


@pytest.mark.parametrize("i", range(24))
def test_fir_adjoint_matches_jax_at_ncsnpp_sites(i):
    """The backward of upfirdn2d (the entry on the cotangent, adjoint
    geometry) against ``jax.vjp`` of the JAX package's ``upfirdn2d_xla``
    and torch autograd through the plain version, with C = 4 (the tiled
    path's shape class) or 3 (the narrow one); the adjoint goes to the path
    the card would take."""
    h, w, up, down, pad, taps, narrow = ncsnpp_fir_sites()[i]
    k = np.asarray(taps, np.float32).reshape(4, 4)
    c = 3 if narrow else 4
    rng = np.random.default_rng(i)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    y = upfirdn2d_reference(torch.from_numpy(x), k, up, down, pad)
    dy = rng.normal(size=tuple(y.shape)).astype(np.float32)

    _, vjp = jax.vjp(lambda z: upfirdn2d_xla(z, k, up=up, down=down, pad=pad),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    got = _vjp(lambda z: upfirdn2d(z, k, up, down, pad), torch.from_numpy(x),
               torch.from_numpy(dy))
    plain = _vjp(lambda z: upfirdn2d_reference(z, k, up, down, pad),
                 torch.from_numpy(x), torch.from_numpy(dy))
    tol = 1e-6 * max(1.0, float(np.abs(want).max()))
    assert got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= tol
    assert np.abs(got.numpy() - plain.numpy()).max() <= tol

    taps_a, up_a, down_a, pad_a, crop = adjoint_geometry(h, w, k, up, down,
                                                         pad)
    assert crop is None and (up_a, down_a) == (down, up)
    assert pad_a == ((1, 1) if up > 1 else (2, 1))
    plan = fir_plan(2, *dy.shape[1:], up_a, down_a, *pad_a, 4, 4)
    assert plan.path == ("narrow" if narrow else "tiled")
    assert (plan.oh, plan.ow) == (h, w)


@pytest.mark.parametrize("geometry", [
    (8, 8, 2, 1, (0, 5)),    # pad1' < 0: run at 0 and crop
    (9, 8, 1, 2, (1, 1)),    # non-square: the axes' pad1' differ
    (8, 8, 1, 1, (2, 2)),    # conv_downsample_2d's FIR (general path)
    (9, 9, 1, 1, (1, 1)),    # upsample_conv_2d's FIR (general path)
])
def test_fir_adjoint_geometry_beyond_the_ncsnpp_sites(geometry):
    h, w, up, down, pad = geometry
    k = setup_kernel([1, 3, 3, 1])
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, h, w, 2)).astype(np.float32))
    dy = torch.randn_like(upfirdn2d_reference(x, k, up, down, pad))
    got = _vjp(lambda z: upfirdn2d(z, k, up, down, pad), x, dy)
    want = _vjp(lambda z: upfirdn2d_reference(z, k, up, down, pad), x, dy)
    assert (got - want).abs().max() <= 1e-6 * max(1.0, want.abs().max())


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1))])
def test_fir_jvp_is_the_forward_on_the_tangent(up, down, pad):
    k = setup_kernel([1, 3, 3, 1]) * (4 if up > 1 else 1)
    g = torch.Generator().manual_seed(2)
    x, dx = (torch.randn(2, 8, 8, 4, generator=g) for _ in range(2))
    _, got = torch.func.jvp(lambda z: upfirdn2d(z, k, up, down, pad), (x,),
                            (dx,))
    assert torch.equal(got, upfirdn2d(dx, k, up, down, pad))
    assert torch.equal(_forward_ad(lambda z: upfirdn2d(z, k, up, down, pad),
                                   x, dx), got)


def test_fir_gradient_goes_through_the_autograd_function():
    """A recorded call's grad_fn is the FIR's own function, whose backward
    launches the kernel on a CUDA cotangent; the plain version's autograd
    graph would only exist on the CPU."""
    k = setup_kernel([1, 3, 3, 1])
    x = torch.randn(1, 8, 8, 4, requires_grad=True)
    y = upfirdn2d(x, k, 1, 2, (1, 1))
    assert type(y.grad_fn).__name__ == "_UpFirDn2dBackward"
    with torch.no_grad():
        assert upfirdn2d(x, k, 1, 2, (1, 1)).grad_fn is None


def test_ncsnpp_vjp_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
    tc = np.asarray([123.0, 500.0], np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    shapes = jax.eval_shape(JaxNCSNpp(**NCSNPP).init, jax.random.PRNGKey(0),
                            x, tc)
    params = _randomized(shapes, 6)
    jm = JaxNCSNpp(**NCSNPP)
    _, vjp = jax.vjp(lambda z: jm.apply(params, z, tc), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])

    net = NCSNpp(**NCSNPP)
    net.load_state_dict(ncsnpp_state_dict_from_flax(params, net.sigmas))
    net.eval().requires_grad_(False)
    got = _vjp(lambda z: net(z, torch.from_numpy(tc)), torch.from_numpy(x),
               torch.from_numpy(dy))
    scale = np.abs(want).max()
    assert scale > 1e-3
    assert np.abs(got.numpy() - want).max() <= 2e-5 * scale


def test_fir_launch_roles_of_the_differentiated_solvers(monkeypatch):
    """What the NCSN++ runs of ``chip_smoke.py`` expect of upfirdn2d, by
    role, counted here on the bare forward that a CUDA tensor would send to
    the kernel: an ot_ode step is one forward and one adjoint launch per
    site; a flow_priors outer step (K 1) is two forwards (the JVP's primal
    and the advance) and one tangent per site, and two adjoints (the
    backward through the primal and through the tangent) per site but the
    input pyramid's, whose tangent is the probe's pyramid, the same for
    every x."""
    from collections import Counter

    from pnpflow_tpu_torch.models.registry import RectifiedAdapter
    from pnpflow_tpu_torch.ops.degradations import GaussianDeblurring
    from pnpflow_tpu_torch.solvers.flow_priors import (
        make_flow_priors_solver)
    from pnpflow_tpu_torch.solvers.ot_ode import make_ot_ode_solver

    roles, pyramid, real = Counter(), Counter(), fir_mod._upfirdn2d_fwd

    def counting(x, k, up, down, pad, role):
        roles[role] += 1
        pyramid[role] += x.shape[-1] == 3 and down > 1
        return real(x, k, up, down, pad, role)

    monkeypatch.setattr(fir_mod, "_upfirdn2d_fwd", counting)
    net = RectifiedAdapter(NCSNpp(**NCSNPP)).eval().requires_grad_(False)
    g = torch.Generator().manual_seed(3)
    x, y = (torch.randn(B, 32, 32, 3, generator=g) for _ in range(2))
    with torch.no_grad():
        net(x, torch.full((B,), 0.5))
    sites, down3 = roles.pop("forward"), pyramid["forward"]
    assert sites > 0 and down3 > 0 and not roles
    op = GaussianDeblurring(1.0, 9, 3, 32, device="cpu")
    with torch.no_grad():
        make_ot_ode_solver(net, op, problem="gaussian_deblurring_FFT",
                           steps=5, gamma="constant", sigma_noise=0.05)(
            y, x, 2, 1)
        assert dict(roles) == {"forward": sites, "adjoint": sites}
        roles.clear()
        make_flow_priors_solver(net, op.H, N=1, K=1, lmbda=1000.0, eta=0.01,
                                start_time=0.0, noise_type="gaussian")(
            y, op.H(x), x, lambda i, k: torch.ones_like(x))
    assert dict(roles) == {"forward": 2 * sites, "tangent": sites,
                           "adjoint": 2 * sites - down3}
