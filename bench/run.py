#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 bench/run.py --workload rc256.prohd_1m --seed 7 --seconds 10 --trace 0

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit); the last lines
of standard error repeat the checks.  Without a CUDA device the run exits
non-zero and prints no result.  The kernels build once into the checkout's
``build/kernels/``; the caches below stay inside the checkout too.
"""
import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=_T0))
