"""``conv3x3_gn``'s share of its roofline over the window: the sum of each
launch's least time (``flops/unet.py:conv_bound_s``, from the site's
shapes) over the kernel's device time in the trace, in percent."""


def read(run):
    f, trace = run.facts, run.trace
    launches = f.get("launches", {}).get("conv3x3_gn", 0)
    if trace is None or not launches:
        return None
    flops = run.flops()
    sites = flops.conv_sites(run.config)
    forwards, rest = divmod(launches, len(sites))
    if rest:
        # the program launches the kernel at other sites than these
        return None
    bound = forwards * sum(flops.conv_bound_s(s, f["images_per_forward"],
                                              run.config["dtype"])
                           for s in sites)
    busy = trace.kernel_seconds("conv3x3_gn_kernel")
    return 100.0 * bound / busy if busy > 0 else None
