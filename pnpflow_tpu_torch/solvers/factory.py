"""Solver dispatch by method name (port of ``pnpflow_tpu/solvers/factory.py``)."""

from __future__ import annotations


def build_solver(bundle, args):
    if args.method == "pnp_flow":
        from pnpflow_tpu_torch.solvers.pnp_flow import PnPFlow

        return PnPFlow(bundle, args)
    if args.method == "ot_ode":
        from pnpflow_tpu_torch.solvers.ot_ode import OTOde

        return OTOde(bundle, args)
    if args.method == "d_flow":
        from pnpflow_tpu_torch.solvers.d_flow import DFlow

        return DFlow(bundle, args)
    if args.method == "flow_priors":
        from pnpflow_tpu_torch.solvers.flow_priors import FlowPriors

        return FlowPriors(bundle, args)
    if args.method == "pnp_gs":
        from pnpflow_tpu_torch.solvers.pnp_gs import ProxPnP

        return ProxPnP(bundle, args)
    if args.method == "pnp_diff":
        from pnpflow_tpu_torch.solvers.pnp_diff import PnPDiff

        return PnPDiff(bundle, args)
    raise ValueError("The method you entered does not exist")
