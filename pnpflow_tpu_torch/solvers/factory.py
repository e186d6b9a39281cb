"""Solver dispatch by method name (port of ``pnpflow_tpu/solvers/factory.py``)."""

from __future__ import annotations

_NOT_PORTED = ("ot_ode", "d_flow", "flow_priors", "pnp_gs", "pnp_diff")


def build_solver(bundle, args):
    if args.method == "pnp_flow":
        from pnpflow_tpu_torch.solvers.pnp_flow import PnPFlow

        return PnPFlow(bundle, args)
    if args.method in _NOT_PORTED:
        raise NotImplementedError(
            f"method {args.method!r} is not ported yet (ROADMAP queue 1, "
            "items 8-10)")
    raise ValueError("The method you entered does not exist")
