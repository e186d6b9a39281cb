"""Model FLOPs of the window's training steps over the window's seconds and
the matmul peak of the configuration's dtype, in percent.  A step counts
three forwards: the forward, and the backward's two products for each of
the forward's (to the activations and to the weights)."""

from portbench.peaks import matmul_peak


def read(run):
    f = run.facts
    if not f.get("train_steps"):
        return None
    flop = 3 * run.flops().forward_flops(run.config, f["images_per_step"])
    return 100.0 * flop * f["train_steps"] / f["window_s"] / matmul_peak(
        run.config["dtype"])
