#!/usr/bin/env python3
"""Time kernel 4 of this tree against an earlier tree's, in one process on
one card, at the shapes both can run.

    python3 scripts/flash_parent_ab.py --parent-src DIR [--reps 3]

``DIR`` is the ``src/`` folder of another checkout (for example
``git archive <commit> | tar -x -C build/parent`` and then
``build/parent/src``); its ``kernels/flash_attention/csrc/flash_fwd*.cu``
are built into a temporary directory with this tree's ``nvcc`` flags.
The earlier launcher's C entry point ends ``…, causal, q_offset, window,
stream`` (called with offset 0 and no window).  Every side is one bare
``ctypes`` call of its library's ``flash_fwd_sm90`` on the same tensors,
so no side pays Python launcher time that another does not:

  - ``parent``: the earlier library;
  - ``this``: this tree's, with offset 0 and no window (INT_MAX), which
    takes the plain causal instance ``<HD, false>``;
  - ``span``: this tree's, with offset 0 and window Sk, which takes the
    instance for offsets and windows ``<HD, true>`` on the same causal
    attention (every row sees every key up to its own), so ``span / this``
    is what carrying that logic in the causal kernel would cost.

At each of ``chip_smoke.FLASH_TIMES``' causal bf16 shapes the sides are
timed with CUDA events (``chip_smoke.cuda_ms``: the median of 5 after a
warm-up) in turns, parent, this, span, span, this, parent, ``--reps``
times, and their outputs compared bit for bit.

Then the wrapper, before and after kernel 4 became the custom op
``torch.ops.repro_torch.flash_fwd``: ``launcher`` is the earlier wrapper's
body (an output allocated, then ``flash.flash_fwd``), ``op`` is
``flash.flash_attention`` through the op; each timed with CUDA events as
above and on the host clock (microseconds a call over 50 calls, the device
synchronised at both ends), in turns, outputs bitwise.  Prints one JSON line per
shape and the card's name and power limit.  Needs one CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)


def parent_library(src: Path, tmp: Path) -> ctypes.CDLL:
    """The earlier tree's kernel-4 library, built from its own sources."""
    from repro_torch.kernels import _build

    csrc = src / "repro_torch" / "kernels" / "flash_attention" / "csrc"
    for f in csrc.iterdir():  # sources and any headers they include
        (tmp / f.name).write_bytes(f.read_bytes())
    so = tmp / "flash_parent.so"
    _build.compile_library([tmp / "flash_fwd.cu", tmp / "flash_fwd_sm90.cu"], so)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_sm90.argtypes = [p, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
    lib.flash_fwd_sm90.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_parent_ab: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.flash_attention import flash as F

    print(C.smi("name,power.limit"), flush=True)
    lib = F.build()
    gen = make_generator(args.seed + 15, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        parent = parent_library(args.parent_src.resolve(), Path(tmp))
        for b, s, h, kv, hd, dtype_name, window in C.FLASH_TIMES:
            if dtype_name != "bfloat16" or window is not None or hd not in (64, 80, 128):
                continue  # the earlier kernel's instances, causal bf16
            q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            outs = {name: torch.empty_like(q) for name in ("parent", "this", "span")}
            stream = torch.cuda.current_stream().cuda_stream
            scale = 1.0 / hd ** 0.5

            def bare(name):
                o = outs[name]
                ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, s, h, kv, hd, scale, 1)
                if name == "parent":
                    err = parent.flash_fwd_sm90(*ptrs, 0, F._INT_MAX, stream)
                else:
                    err = lib.flash_fwd_sm90(*ptrs, 0, s if name == "span" else F._INT_MAX, stream)
                assert err == 0, (name, err)

            times = {name: [] for name in outs}
            for _ in range(args.reps):
                for name in ("parent", "this", "span", "span", "this", "parent"):
                    times[name].append(C.cuda_ms(lambda: bare(name)))
            torch.cuda.synchronize()
            med = {k: statistics.median(v) for k, v in times.items()}
            C.emit({"shape": [b, s, h, kv, hd], "parent_ms": med["parent"], "this_ms": med["this"],
                    "span_ms": med["span"], "this_over_parent": med["this"] / med["parent"],
                    "span_over_this": med["span"] / med["this"], "runs": times,
                    "bitwise_equal": {n: bool(torch.equal(outs[n], outs["parent"])) for n in ("this", "span")}})

            wrapped = {}

            def launcher():
                o = torch.empty_like(q)
                F.flash_fwd(q, k, v, o)
                wrapped["launcher"] = o

            def op():
                wrapped["op"] = F.flash_attention(q, k, v)

            def host_us(fn, n=50):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / n * 1e6

            w_ms = {"launcher": [], "op": []}
            w_us = {"launcher": [], "op": []}
            with torch.no_grad():
                for _ in range(args.reps):
                    for name, fn in (("launcher", launcher), ("op", op), ("op", op), ("launcher", launcher)):
                        w_ms[name].append(C.cuda_ms(fn))
                        w_us[name].append(host_us(fn))
            wm = {k: statistics.median(v) for k, v in w_ms.items()}
            wu = {k: statistics.median(v) for k, v in w_us.items()}
            C.emit({"shape": [b, s, h, kv, hd], "wrapper": True, "launcher_ms": wm["launcher"], "op_ms": wm["op"],
                    "op_over_launcher": wm["op"] / wm["launcher"], "launcher_host_us": wu["launcher"],
                    "op_host_us": wu["op"], "op_over_launcher_host": wu["op"] / wu["launcher"],
                    "bitwise_equal": bool(torch.equal(wrapped["op"], wrapped["launcher"]))})
            del q, k, v, outs
            torch.cuda.empty_cache()
    print(C.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
