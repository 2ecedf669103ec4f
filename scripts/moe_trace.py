#!/usr/bin/env python3
"""Trace OLMoE-1B-7B's prefill and decode on one NVIDIA GPU.

    python3 scripts/moe_trace.py [--seed 0] [--steps 4]

Builds OLMoE-1B-7B at full width and depth with random bf16 weights (as
``chip_smoke.py`` phase 14b does), runs one ``prefill_step`` at 8 × 4,096
tokens and ``--steps`` ``serve_step``s at batch 8 over a 32,768-slot cache
once to warm up, then again under ``torch.profiler``, and prints one JSON
line per path: the host-clock wall time, the device's busy share of the
traced wall time, the device ms by kernel name (largest first) and the
device ms of the largest PyTorch operations (inclusive of the operations
they call, so nested ones count twice).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PREFILL = (8, 4_096)
DECODE_BATCH = 8
DECODE_CACHE = 32_768


def _device_ms(events, top: int = 15) -> tuple[float, dict, dict]:
    """(device ms in kernels, ms by kernel, inclusive ms by PyTorch operation)."""
    kernels, ops = {}, {}
    for e in events:
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0.0)
        if not dt:
            continue
        if "CUDA" in str(getattr(e, "device_type", "")):
            kernels[e.key] = kernels.get(e.key, 0.0) + dt / 1e3
        elif e.key.startswith("aten::"):
            ops[e.key] = ops.get(e.key, 0.0) + dt / 1e3

    def largest(d):
        return {k: v for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]}

    return sum(kernels.values()), largest(kernels), largest(ops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("moe_trace: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import load_arch
    from repro_torch.data import synth
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.models import transformer as T

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_arch("olmoe-1b-7b").config
    gen = make_generator(args.seed, "cuda")
    model = T.init_lm_params(gen, cfg)
    b, s = PREFILL
    tokens = synth.lm_batch(gen, cfg, b, s)["tokens"][:, :s]
    cache = T.init_kv_cache(cfg, DECODE_BATCH, DECODE_CACHE)
    step_tokens = synth.lm_batch(gen, cfg, DECODE_BATCH, 1)["tokens"][:, 0]

    def prefill():
        T.prefill_step(model, tokens, cfg)

    def decode():
        for _ in range(args.steps):
            T.serve_step(model, cache, step_tokens, cfg)

    paths = (("prefill", prefill, f"{b} x {s}", 1),
             ("decode", decode, f"batch {DECODE_BATCH}, cache {DECODE_CACHE}", args.steps))
    for name, run, shape, calls in paths:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        busy_ms, by_kernel, by_op = _device_ms(prof.key_averages())
        print(json.dumps({
            "path": name, "arch": cfg.name, "shape": shape, "calls": calls, "torch": torch.__version__,
            "card": card, "wall_ms_per_call": wall_s / calls * 1e3,
            "device_busy_share": busy_ms / (wall_s * 1e3),
            "device_ms_per_call_by_kernel": {k: v / calls for k, v in by_kernel.items()},
            "device_ms_per_call_by_op_inclusive": {k: v / calls for k, v in by_op.items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
