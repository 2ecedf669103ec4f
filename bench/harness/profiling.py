"""The traced run: ``torch.profiler`` over a short steady stretch, read into
plain lists that the per-layer readers and the breakdown take.

``TraceView`` is all a reader sees: the device's operations (kernels,
copies, fills) and the host's ranges as (name, start_ns, end_ns), the
harness's ``bench.call`` range around each traced call of the program, the
loop's records, the program's own spans (``repro_torch.obs.trace``), each
call's useful FLOPs and the card's published peak.  No reader of the two
cells reads the records or the spans; they are there for a reader that a
later cell adds, since the harness's files are not edited.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import types
from collections import defaultdict

__all__ = ["TraceView", "profiled", "union_ns", "breakdown"]

CALL_RANGE = "bench.call"
NAME_CHARS = 160
SPAN_PREFIXES = ("bench.", "index.", "cascade.", "hd.")


@dataclasses.dataclass
class TraceView:
    device_ops: list[tuple[str, int, int]]
    host_ops: list[tuple[str, int, int]]
    records: list[dict]
    spans: list[dict]
    flops: list[float | None]
    peak_flops: float | None

    @property
    def calls(self) -> list[tuple[int, int]]:
        """The (start_ns, end_ns) of each traced call, in order."""
        return sorted((s, e) for name, s, e in self.host_ops if name == CALL_RANGE)

    @property
    def window(self) -> tuple[int, int]:
        calls = self.calls
        return calls[0][0], calls[-1][1]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) * 1e-9

    def busy_s(self, match: str | None = None) -> float:
        """Seconds of the window in which a device operation (whose name
        holds ``match``, if given) ran: the union of their intervals."""
        lo, hi = self.window
        ops = [(s, e) for name, s, e in self.device_ops if match is None or match in name]
        return union_ns(ops, lo, hi) * 1e-9

    def calls_s(self) -> float:
        return sum(e - s for s, e in self.calls) * 1e-9

    def idle_pct(self) -> float | None:
        if not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _item(e) -> tuple[str, int, int]:
    start = int(e.start_ns())
    return e.name()[:NAME_CHARS], start, start + int(e.duration_ns())


@contextlib.contextmanager
def profiled(device_type: str):
    """Profile the block; afterwards the holder has ``device_ops`` and
    ``host_ops``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device_type == "cuda" else [])
    holder = types.SimpleNamespace(device_ops=[], host_ops=[])
    with profile(activities=acts) as prof:
        yield holder
        if device_type == "cuda":
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    host = [_item(e) for e in events if str(e.device_type()).endswith("CPU")]
    # A device event is a kernel, a copy or a fill; the device's copies of
    # the host's ranges (``record_function``) carry those ranges' names.
    ranges = {name for name, _, _ in host}
    dev = [it for it in (_item(e) for e in events if not str(e.device_type()).endswith("CPU"))
           if it[0] not in ranges]
    holder.device_ops, holder.host_ops = dev, host


def breakdown(view: TraceView, top: int = 10, gaps_named: int = 500) -> dict:
    """The device operations that took most time (summed by name) and the
    idle time of the ``gaps_named`` longest device gaps in the window,
    summed by what the host was doing in the middle of each: the innermost
    host range there, after the innermost span of the harness or the
    program that holds it."""
    lo, hi = view.window
    by_op = defaultdict(int)
    for name, s, e in view.device_ops:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_op[name] += e - s
    ops = sorted(((s, e) for _, s, e in view.device_ops if e > lo and s < hi))
    gaps, cursor = [], lo
    for s, e in ops:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:gaps_named]
    host = sorted(view.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_gap = defaultdict(int)
    for g0, g1 in gaps:
        by_gap[_host_activity(host, starts, (g0 + g1) // 2)] += g1 - g0
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    top_gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, t * 1e-9] for n, t in top_ops],
            "idle_gaps": [[n, t * 1e-9] for n, t in top_gaps]}


def _host_activity(host, starts, t: int, scan: int = 4000) -> str:
    i = bisect.bisect_right(starts, t)
    inner = span = None
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        name, s, e = host[j]
        if e < t:
            continue
        if inner is None:
            inner = name
        if name.startswith(SPAN_PREFIXES):
            span = name
            break
    if inner is None:
        return "host: no range"
    return inner if span is None or span == inner else f"{span} > {inner}"
