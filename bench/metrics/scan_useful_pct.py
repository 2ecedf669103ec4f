"""scan_useful_pct (scan kernels): useful pairs over pairs attempted.  The
traced calls' useful FLOPs (the benchmark's own count: ProHD's subsets as
the reference selects them) over the FLOPs of the work the program handed
kernel 1: 2 * d * rows * cols summed over its ``hd.scan`` spans, whose
rows are ProHD's subsets padded to their static capacity.  Nothing to
read where the program has no such span or ran off the card (no
``device_s``)."""

SPAN = "hd.scan"


def read(view) -> float | None:
    scans = [s for s in view.spans if s.get("type") == "span" and s["name"] == SPAN]
    if not scans or any("device_s" not in s for s in scans):
        return None
    if not view.flops or any(f is None for f in view.flops):
        return None
    attempted = sum(2.0 * s["attrs"]["d"] * s["attrs"]["rows"] * s["attrs"]["cols"] for s in scans)
    return 100.0 * sum(view.flops) / attempted
