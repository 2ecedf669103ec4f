#!/usr/bin/env python3
"""Trace a loop shaped like the cascade's stage 2b on one NVIDIA GPU.

    python3 scripts/refine_trace.py [--src DIR] [--refines 400] [--seed 0]

Stage 2b of ``search`` and ``search_batch`` refines candidates one at a
time: an exact ``set_distance`` of the query against a set copied from
the host, its value read back. This script runs that loop (a 128-point
query against host sets of 48–256 points at D 256) once to warm up, times
it on the host clock, then runs it again under ``torch.profiler`` and
prints one JSON line: wall µs per refine, the device time per refine by
kernel name (largest first), the device's busy share of the traced wall
time, and the CPU time per refine of the largest host operations.
``--src`` imports ``repro_torch`` from another checkout's ``src/`` (to
compare two versions in one call, in turns).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--refines", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("refine_trace: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.hd import set_distance

    rng = np.random.default_rng(args.seed)
    q = torch.from_numpy(rng.random((128, 256), dtype=np.float32)).cuda()
    sets = [rng.random((int(n), 256), dtype=np.float32) for n in rng.integers(48, 257, args.refines)]

    def loop():
        for s in sets:
            float(set_distance(q, torch.tensor(s, device="cuda"), method="exact", backend="fused_cuda").value)

    loop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / len(sets) * 1e6

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = prof.key_averages()
    n = len(sets)
    device = {}
    for e in events:
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0.0)
        if dt and "CUDA" in str(getattr(e, "device_type", "")):
            device[e.key] = device.get(e.key, 0.0) + dt
    busy_us = sum(device.values())
    cpu = sorted(((e.key, e.self_cpu_time_total) for e in events if e.self_cpu_time_total), key=lambda kv: -kv[1])
    print(json.dumps({
        "src": str(args.src), "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
        "refines": n, "wall_us_per_refine": wall_us, "traced_wall_us_per_refine": traced_s / n * 1e6,
        "device_busy_share": busy_us / (traced_s * 1e6),
        "device_us_per_refine": {k: v / n for k, v in sorted(device.items(), key=lambda kv: -kv[1])[:12]},
        "cpu_self_us_per_refine": {k: v / n for k, v in cpu[:12]},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
