"""The GroupNorm kernel's share of its roofline over the window's forward
launches (its backward is plain PyTorch and launches none): the sum of
each launch's least time (``flops/unet.py:gn_bound_s``) over the device
time of the kernel's three functions in the trace, in percent."""

NAMES = ("gn_cluster_kernel", "gn_moments_kernel", "gn_normalize_kernel")


def read(run):
    f, trace = run.facts, run.trace
    launches = f.get("launches", {}).get("groupnorm_swish_fwd", 0)
    if trace is None or not launches:
        return None
    flops = run.flops()
    sites = flops.gn_sites(run.config)
    forwards, rest = divmod(launches, len(sites))
    if rest:
        # the program launches the kernel at other sites than these
        return None
    n = f.get("images_per_step") or f["images_per_forward"]
    bound = forwards * sum(flops.gn_bound_s(s, n, run.config["dtype"])
                           for s in sites)
    busy = trace.kernel_seconds(*NAMES)
    return 100.0 * bound / busy if busy > 0 else None
