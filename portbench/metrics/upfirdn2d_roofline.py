"""``upfirdn2d``'s share of its roofline over the window: the sum of each
launch's least time (``flops/ncsnpp.py:fir_bound_s``, from the site's
shapes) over the kernel's device time in the trace, in percent."""


def read(run):
    f, trace = run.facts, run.trace
    launches = f.get("launches", {}).get("upfirdn2d", 0)
    if trace is None or not launches:
        return None
    flops = run.flops()
    sites = flops.fir_sites(run.config)
    forwards, rest = divmod(launches, len(sites))
    if rest:
        # the program launches the kernel at other sites than these
        return None
    bound = forwards * sum(flops.fir_bound_s(s, f["images_per_forward"])
                           for s in sites)
    busy = trace.kernel_seconds("upfirdn2d_")
    return 100.0 * bound / busy if busy > 0 else None
