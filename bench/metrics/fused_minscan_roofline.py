"""fused_minscan_roofline (scan kernels): kernel 1's share of its roofline,
the useful FLOPs of the traced calls at the card's published fp32 peak
over the device time of every ``fused_minscan`` launch in them.  The
kernel is bound by its FFMA issue, not by memory: its operands are reused
from shared memory across a whole tile."""

KERNEL = "fused_minscan"


def read(view) -> float | None:
    k1 = view.busy_s(KERNEL)
    if k1 == 0.0 or view.peak_flops is None or not view.flops or any(f is None for f in view.flops):
        return None
    return 100.0 * sum(view.flops) / view.peak_flops / k1
