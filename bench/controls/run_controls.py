#!/usr/bin/env python3
"""Readings that set a cell's limits: the program over many seeds and the
control (the plain reference in TF32 in the program's place) over a few, at
the cell's own size, in one process.

    python3 bench/controls/run_controls.py --workload rc256.prohd_1m \\
        --program-seeds 12 --control-seeds 3 --seconds 3 [--first-seed N]

Each run goes through the benchmark's own loop and check (``run_cell``) with
a short window; one JSON line per run, then for each compared number the
largest program reading and the smallest control reading.  The benchmark's
own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import spec as S  # noqa: E402
from bench.harness.runner import run_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = S.load_cell(args.workload)
    driver_cls = S.load_driver(cell.traffic["driver"]).Driver
    runs = [("program", None, i) for i in range(args.program_seeds)]
    runs += [("control", driver_cls.control_program, 100 + i) for i in range(args.control_seeds)]
    readings: dict[str, dict[str, list[float]]] = {}
    for who, program, i in runs:
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, program=program)
        checks = {k: v["value"] for k, v in out["checks"].items()}
        print(json.dumps({"who": who, "seed": seed, "correct": out["correct"], "attempted": out["attempted"],
                          "checks": checks, "run_s": time.perf_counter() - t}), flush=True)
        for k, v in checks.items():
            readings.setdefault(who, {}).setdefault(k, []).append(v)
        torch.cuda.empty_cache()
    summary = {who: {k: (max(v) if who == "program" else min(v)) for k, v in nums.items()}
               for who, nums in readings.items()}
    print(json.dumps({"summary (program: largest, control: smallest)": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
