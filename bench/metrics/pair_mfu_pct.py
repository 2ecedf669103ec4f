"""pair_mfu_pct (front door): the traced calls' useful float32 FLOPs over
their time on the profiler's clock (the harness's range around each call,
which ends with the result on the host) times the card's published fp32
peak.  The whole call's share of the peak, whichever kernels run it."""


def read(view) -> float | None:
    if view.peak_flops is None or not view.flops or any(f is None for f in view.flops):
        return None
    return 100.0 * sum(view.flops) / (view.calls_s() * view.peak_flops)
