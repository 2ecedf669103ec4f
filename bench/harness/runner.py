"""One run of one cell: set-up, the measured window (or the traced
stretch), the check against the plain reference, and the result line.

``run_cell`` does the work on any device, so the CPU tests drive it at tiny
sizes; ``main`` is the command line, which insists on the card.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time

from bench.harness import spec as S
from bench.harness.profiling import TraceView, breakdown, profiled

__all__ = ["FORBIDDEN", "forbidden_modules", "run_cell", "main"]

# Top-level module names the process may not hold once the window has
# closed: JAX and the JAX package (whose name ``repro_torch`` begins with,
# hence the comparison of whole top-level names).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _window(driver, seconds: float, device) -> tuple[list[dict], float, float]:
    """The closed loop: steps until ``seconds`` have passed since the first
    began, each ended when its answer is on the host.  The window is the
    whole steps: (records, start, end) on the host clock."""
    records, i = [], 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        rec = _step(driver, i)
        rec["host_s"] = (ts, time.perf_counter())
        records.append(rec)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    return records, t0, time.perf_counter()


def _step(driver, i: int) -> dict:
    """One step; a step whose call raises counts its requests as failed."""
    try:
        return driver.step(i)
    except Exception as e:  # the loop keeps running: a fault is a failed request
        print(f"step {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
        return driver.failed_step(i)


def run_cell(cell: S.Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t0: float | None = None, program=None, peak_flops: float | None = None) -> dict:
    """Run ``cell`` once and return its result line as a dict.

    ``program`` replaces the system under test (a function of the driver
    that returns the callable the loop drives): the control and the
    planted faults of the tests and ``controls/``.  ``t0`` is the process's
    start on the ``time.perf_counter`` clock, for ``setup_s``."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    driver_mod = S.load_driver(cell.traffic["driver"])
    marks = [("start", time.perf_counter())]
    driver = driver_mod.Driver(cell.config, cell.traffic, seed, dev, program=program)
    _sync(dev)
    marks.append(("inputs_and_program", time.perf_counter()))
    if program is None:
        driver.build()
    marks.append(("build", time.perf_counter()))
    driver.warmup()
    _sync(dev)
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    # setup_s holds every phase, the build too (on a checkout's first run,
    # the nvcc build of the kernels); each phase is given apart beside it.
    phases, prev = {}, t0
    for name, t in marks:
        phases[name], prev = t - prev, t

    spans: list[dict] = []
    if trace:
        from repro_torch.obs import trace as obs_trace

        with profiled(dev.type) as prof, obs_trace.capture(record_function=True) as events:
            records = [_step(driver, i) for i in range(int(cell.traffic["trace_steps"]))]
            _sync(dev)
            spans = events()
    else:
        records, w0, w1 = _window(driver, seconds, dev)

    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    driver.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    readings, refs = driver.check(records, all_steps=trace)
    limits = dict(cell.traffic["check"]["limits"], unanswered=0)
    checks = {name: {"value": _finite(readings[name]), "limit": limits[name]} for name in limits}
    correct = bool(records) and all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        flops = [driver.flops(rec, refs.get(rec["step"])) for rec in records]
        view = TraceView(device_ops=prof.device_ops, host_ops=prof.host_ops, records=records,
                         spans=spans, flops=flops, peak_flops=peak_flops)
        metrics = _read(cell.per_layer, "metrics", view)
        extra = {"busy_s": view.busy_s(), "window_s": view.window_s}
    else:
        window = {"setup_s": setup_s, "start": w0, "end": w1, "records": records}
        metrics = _read(cell.end_to_end, "end_to_end", window)
        extra = {}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak), **extra}
    out = {"correct": correct,
           "attempted": sum(r["requests"] for r in records),
           "failed": sum(r["failed"] for r in records),
           "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = breakdown(view)
    else:
        out["step_s"] = [r["host_s"][1] - r["host_s"][0] for r in records]
    out["setup_phases_s"] = phases
    out["checks"] = checks
    return out


def _finite(x: float) -> float:
    """A reading for the JSON line: +inf (no answer) as the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def _read(entries: list[dict], kind: str, view) -> dict:
    """Each metric's reader on ``view``; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in entries:
        value = S.load_reader(kind, m["name"]).read(view)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = S.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 3
    from bench.harness.flops import fp32_peak

    kind = torch.cuda.get_device_name(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t0=t0,
                   peak_flops=fp32_peak(kind))
    card = _power_limit()
    out["device"]["card"] = card
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded JAX or the JAX package: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"card: {card}", file=sys.stderr)
    print(f"setup phases (s): {out['setup_phases_s']}", file=sys.stderr)
    steps = out.get("step_s")
    if steps:
        print(f"steps: {len(steps)}, seconds each: first {steps[0]:.4f}, min {min(steps):.4f}, "
              f"max {max(steps):.4f}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
