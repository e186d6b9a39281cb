"""Model FLOPs of the window's forwards (``flops/<arch>.py``, counted from
the architecture) over the window's seconds and the matmul peak of the
configuration's dtype, in percent."""

from portbench.peaks import matmul_peak


def read(run):
    f = run.facts
    if not f.get("forwards"):
        return None
    flop = run.flops().forward_flops(run.config, f["images_per_forward"])
    return 100.0 * flop * f["forwards"] / f["window_s"] / matmul_peak(
        run.config["dtype"])
