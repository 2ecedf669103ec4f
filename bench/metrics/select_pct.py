"""select_pct (ProHD selection): the share of the traced calls' time in which
kernel 1 (``fused_minscan``) was not running: the selection, the bounds and
the host's waits around the two sweeps."""

KERNEL = "fused_minscan"


def read(view) -> float | None:
    k1 = view.busy_s(KERNEL)
    if k1 == 0.0:
        return None
    return 100.0 * (1.0 - k1 / view.calls_s())
