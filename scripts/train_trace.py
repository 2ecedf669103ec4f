#!/usr/bin/env python3
"""Where a TinyLlama-1.1B training step's time goes, on one NVIDIA GPU.

    python3 scripts/train_trace.py [--seed 0]

Builds TinyLlama-1.1B at full width and depth with random bf16 weights (as
``chip_smoke.py`` phase 16 does) and runs ``train.loop.make_train_step``
with the reference launcher's AdamW (lr 1e-3, weight decay 0.01, fp32
master) at 4 × 4,096 tokens in 2 microbatches, remat on: one step to warm
up, one step timed with CUDA events around its parts (kernel 4's wrapper
calls, the plain attention backward, the optimizer update; all on one
stream, so the events bound each part's device time), then one step under
``torch.profiler``.  Prints one JSON line: the step's host-clock wall time,
each part's device ms and share, the rest (GEMMs and elementwise work of
the layers, the loss), the device's busy share of the profiled step and
its device ms by kernel category and by kernel name (largest first).
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

SHAPE = (4, 4_096)
MICROBATCHES = 2
# kernel-name fragments → category, first match wins
CATEGORIES = (("flash_fwd", "kernel 4"), ("gemm", "GEMM"), ("gemv", "GEMM"), ("cutlass", "GEMM"),
              ("reduce", "reduction"), ("softmax", "reduction"), ("elementwise", "elementwise"),
              ("vectorized", "elementwise"), ("copy", "copy"), ("Memcpy", "copy"), ("Memset", "copy"))


def _by_kernel(events, top: int = 20) -> tuple[float, dict, dict]:
    """(device ms in kernels, ms by category, ms by kernel name, largest first)."""
    kernels = {}
    for e in events:
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0.0)
        if dt and "CUDA" in str(getattr(e, "device_type", "")):
            kernels[e.key] = kernels.get(e.key, 0.0) + dt / 1e3
    cats = {}
    for name, ms in kernels.items():
        cat = next((c for frag, c in CATEGORIES if frag.lower() in name.lower()), "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    order = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return sum(kernels.values()), dict(sorted(cats.items(), key=lambda kv: -kv[1])), dict(order)


class _Timed:
    """Wraps a function so every call is bracketed by CUDA events on the
    current stream; ``ms()`` sums them after a synchronise."""

    def __init__(self, fn):
        self.fn, self.pairs = fn, []

    def __call__(self, *a, **kw):
        import torch

        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = self.fn(*a, **kw)
        t1.record()
        self.pairs.append((t0, t1))
        return out

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_trace: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import load_arch
    from repro_torch.data import synth
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.flash_attention import flash as F
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer
    from repro_torch.train.loop import make_train_step, named_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_arch("tinyllama-1.1b").config
    gen = make_generator(args.seed, "cuda")
    model = T.init_lm_params(gen, cfg)
    b, s = SHAPE
    batch = synth.lm_batch(gen, cfg, b, s)
    opt = optimizer.adamw(lr=1e-3, weight_decay=0.01)
    timed_update = _Timed(opt.update)
    step = make_train_step(lambda p, bt: T.lm_loss(p, bt, cfg), opt._replace(update=timed_update),
                           microbatches=MICROBATCHES)
    state = opt.init(named_params(model))

    state, _ = step(model, state, batch)  # warm-up (and the kernel build)
    torch.cuda.synchronize()
    timed_update.pairs.clear()
    parts = {"kernel 4 forward (flash_attention)": (F, "flash_attention"),
             "attention backward (plain)": (F, "flash_attention_backward_plain")}
    wrapped = {}
    for name, (mod, attr) in parts.items():
        wrapped[name] = (mod, attr, getattr(mod, attr), _Timed(getattr(mod, attr)))
        setattr(mod, attr, wrapped[name][3])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(model, state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        for mod, attr, fn, _ in wrapped.values():
            setattr(mod, attr, fn)
    part_ms = {name: w[3].ms() for name, w in wrapped.items()}
    part_ms["optimizer update (AdamW)"] = timed_update.ms()
    part_ms["rest: layer GEMMs, elementwise, loss"] = wall_s * 1e3 - sum(part_ms.values())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, _ = step(model, state, batch)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t1
    busy_ms, by_cat, by_kernel = _by_kernel(prof.key_averages())
    print(json.dumps({
        "path": "train_step", "arch": cfg.name, "shape": list(SHAPE), "microbatches": MICROBATCHES,
        "remat": cfg.remat, "torch": torch.__version__, "card": card, "wall_s": wall_s,
        "loss": float(metrics["loss"]), "tokens_per_s": b * s / wall_s,
        "part_ms": part_ms, "part_share": {k: v / (wall_s * 1e3) for k, v in part_ms.items()},
        "kernel4_calls_in_step": len(wrapped["kernel 4 forward (flash_attention)"][3].pairs),
        "profiled_wall_s": prof_wall_s, "device_busy_share": busy_ms / (prof_wall_s * 1e3),
        "device_ms_by_category": by_cat, "device_ms_by_kernel": by_kernel,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
