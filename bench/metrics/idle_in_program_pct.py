"""idle_in_program_pct (device): the share of the traced window in which no
operation ran on the card while the host was inside the program's
``set_distance`` (its ``hd.set_distance`` ranges, which the profiler
bridge opens on the profiler's clock; one call's range never overlaps
another's).  ``idle_pct.pair`` less this is the harness's own idle.
Nothing to read without device operations or such ranges."""

from bench.harness.profiling import union_ns

RANGE = "hd.set_distance"


def read(view) -> float | None:
    if not view.device_ops:
        return None
    lo, hi = view.window
    calls = [(max(s, lo), min(e, hi)) for name, s, e in view.host_ops if name == RANGE]
    calls = [(s, e) for s, e in calls if e > s]
    if not calls:
        return None
    ops = [(s, e) for _, s, e in view.device_ops]
    idle_ns = sum((e - s) - union_ns(ops, s, e) for s, e in calls)
    return 100.0 * idle_ns * 1e-9 / view.window_s
