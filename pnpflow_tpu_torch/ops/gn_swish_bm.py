"""GroupNorm(32, eps 1e-6) [+ swish] on NHWC for the U-Net's ``fused_norm
"bm"`` path, through the same CUDA kernel as ``groupnorm_swish``.

Replaces the TPU kernel
``pnpflow_tpu/ops/pallas_kernels.py:_gn_swish_bm_kernel`` (launched by
``_gn_swish_bm_pallas``, entry ``groupnorm_swish_bm``).  It computes the same
function as ``groupnorm_swish`` (``ops/gn_swish.py``): per sample and group,
float32 statistics E[x] and max(E[x^2] - E[x]^2, 0) over the group's (H, W,
C/G) slab, then (x - mean) * rsqrt(var + eps) * scale + bias, an optional
swish, and a store in x's dtype.

On the TPU the layout was the point: the kernel read the activations
batch-minor, as XLA had laid them out, with a sequential two-phase grid that
carried the moment sums in VMEM scratch.  That layout has no counterpart on
the card, where both entries see the same NHWC tensor, so both launch one
design, ``csrc/gn_swish.cu`` (see ``ops/gn_swish.py`` for it and its
:func:`~pnpflow_tpu_torch.ops.gn_swish.gn_plan`).  This entry keeps its own
launch counter, its argument checks and its autograd function, whose
backward is the plain copy of ``_gn_swish_vjp_bwd``, as the JAX entry shares
that backward, and whose forward-mode rule is the plain linearisation.  The
plain version, for CPU tensors and as the yardstick, is
:func:`~pnpflow_tpu_torch.ops.gn_swish.gn_swish_reference`.
"""

from __future__ import annotations

from pnpflow_tpu_torch.ops import _build
from pnpflow_tpu_torch.ops.gn_swish import (
    _GroupNormSwish, check_args, gn_swish_reference, launch, needs_autograd)

__all__ = ["groupnorm_swish_bm", "groupnorm_swish_bm_fwd"]


def groupnorm_swish_bm_fwd(x, scale, bias, num_groups: int = 32,
                           eps: float = 1e-6, swish: bool = True):
    """Forward only.  The arguments are checked as the kernel takes them on
    every device; then CPU tensors take :func:`gn_swish_reference` and CUDA
    tensors launch ``csrc/gn_swish.cu`` (one launch counted in
    ``.launches`` per call, whichever path the plan takes) or raise."""
    plan = check_args(x, scale, bias, num_groups)
    if x.device.type == "cpu":
        return gn_swish_reference(x, scale, bias, num_groups, eps, swish)
    y = launch(x, scale, bias, num_groups, eps, swish, plan)
    _build.count_launch(groupnorm_swish_bm_fwd)
    return y


groupnorm_swish_bm_fwd.launches = 0


class _GroupNormSwishBM(_GroupNormSwish):
    """:class:`~pnpflow_tpu_torch.ops.gn_swish._GroupNormSwish` with this
    entry's forward: the same plain backward and forward-mode rule, with
    call counts of its own."""
    fwd = staticmethod(groupnorm_swish_bm_fwd)
    backward_calls = 0
    jvp_calls = 0


def groupnorm_swish_bm(x, scale, bias, num_groups: int = 32,
                       eps: float = 1e-6, swish: bool = True):
    """GroupNorm(num_groups, eps) [+ swish] on NHWC, differentiable in
    reverse and forward mode; the forward alone where
    :func:`~pnpflow_tpu_torch.ops.gn_swish.needs_autograd` finds nothing to
    differentiate."""
    if needs_autograd(x, scale, bias):
        return _GroupNormSwishBM.apply(x, scale, bias, num_groups, eps,
                                       swish)
    return groupnorm_swish_bm_fwd(x, scale, bias, num_groups, eps, swish)
