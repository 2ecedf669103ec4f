#!/usr/bin/env python3
"""Time kernel 4 of this tree against an earlier tree's, in one process on
one card, at the shapes both can run.

    python3 scripts/flash_parent_ab.py --parent-src DIR [--reps 3]

``DIR`` is the ``src/`` folder of another checkout (for example
``git archive <commit> | tar -x -C build/parent`` and then
``build/parent/src``); its ``kernels/flash_attention/csrc/flash_fwd*.cu``
are built into a temporary directory with this tree's ``nvcc`` flags.
The earlier launcher's C entry point ends ``…, causal, q_offset, window,
stream`` or, where its source takes the block order's group, ``…, window,
group, stream`` (called with offset 0, no window and ``flash.kv_group``'s
group).  Every side is one bare ``ctypes`` call of its library's
``flash_fwd_sm90`` on the same tensors, so no side pays Python launcher
time that another does not:

  - ``parent``: the earlier library;
  - ``this``: this tree's, with offset 0 and no window (INT_MAX), which
    takes the plain causal instance ``<HD, false>``, and the launcher's
    group (``flash.kv_group`` on the card's L2);
  - ``flat``: the same instance with one group of all B·KV (batch, kv
    head) pairs, which is the block order before the L2-aware one (every
    head's heaviest query block first, then the next-lighter ones), so
    ``this / flat`` is what the order alone gives;
  - ``span``: this tree's, with offset 0 and window Sk, which takes the
    instance for offsets and windows ``<HD, true>`` on the same causal
    attention (every row sees every key up to its own), so ``span / this``
    is what carrying that logic in the causal kernel would cost.

At each of ``chip_smoke.FLASH_TIMES``' causal bf16 shapes the sides are
timed with CUDA events (``chip_smoke.cuda_ms``: the median of 5 after a
warm-up) in turns, parent, this, flat, span, span, flat, this, parent,
``--reps`` times, their outputs compared bit for bit (a changed key tile
changes the summation order, so the parent's may differ in the last bits)
and each held to the plain version with ``chip_smoke.flash_error``.  At
each causal fp32 shape the fp32 route (``flash_fwd``, route "ffma") of
both trees is timed the same way, outputs compared bitwise and held to the
plain version, and at the windowed shape both trees' instance for offsets
and windows, outputs compared bitwise and held to the plain version.

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


def parent_library(src: Path, tmp: Path) -> tuple[ctypes.CDLL, bool]:
    """The earlier tree's kernel-4 library, built from its own sources, and
    whether its entry point takes the block order's group."""
    from repro_torch.kernels import _build

    csrc = src / "repro_torch" / "kernels" / "flash_attention" / "csrc"
    for f in csrc.iterdir():  # sources and any headers they include
        (tmp / f.name).write_bytes(f.read_bytes())
    so = tmp / "flash_parent.so"
    _build.compile_library([tmp / "flash_fwd.cu", tmp / "flash_fwd_sm90.cu"], so)
    takes_group = "int group, void* stream" in (tmp / "flash_fwd_sm90.cu").read_text()
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_sm90.argtypes = [p, p, p, p, i, i, i, i, i, i, f, i, i, i, *([i] if takes_group else []), p]
    lib.flash_fwd_sm90.restype = i
    return lib, takes_group


def window_row(parent, parent_group, lib, gen, b, s, h, kv, hd, window) -> None:
    """A causal bf16 shape with a sliding window: both trees' instance for
    offsets and windows, bare calls in turns, outputs compared bitwise and
    held to the plain version."""
    import torch

    from repro_torch.kernels.flash_attention import flash as F

    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    outs = {name: torch.empty_like(q) for name in ("parent", "this")}
    stream = torch.cuda.current_stream().cuda_stream
    l2 = torch.cuda.get_device_properties(q.device).L2_cache_size
    group = F.kv_group(b, s, kv, hd, l2)

    def bare(name):
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[name].data_ptr(), b, s, s, h, kv, hd,
                1.0 / hd ** 0.5, 1, 0, window)
        if name == "parent":
            err = parent.flash_fwd_sm90(*ptrs, *([group] if parent_group else []), stream)
        else:
            err = lib.flash_fwd_sm90(*ptrs, group, stream)
        assert err == 0, (name, err)

    times = {name: [] for name in outs}
    for _ in range(3):
        for name in ("parent", "this", "this", "parent"):
            times[name].append(C.cuda_ms(lambda: bare(name)))
    torch.cuda.synchronize()
    want = F.flash_attention_plain(q, k, v, causal=True, window=window)
    abs_v = C.weighted_abs_v(q, k, v, causal=True, window=window)
    held = {n: C.flash_error(o, want, abs_v)["max_ratio"] for n, o in outs.items()}
    assert all(r <= 1 for r in held.values()), held
    med = {k: statistics.median(v) for k, v in times.items()}
    C.emit({"shape": [b, s, h, kv, hd], "window": window, "group": group, "parent_ms": med["parent"],
            "this_ms": med["this"], "this_over_parent": med["this"] / med["parent"], "runs": times,
            "bitwise_equal": bool(torch.equal(outs["this"], outs["parent"])), "max_ratio_vs_plain": held})


def fp32_row(parent, lib, gen, b, s, h, kv, hd) -> None:
    """The fp32 route ("ffma", ``flash_fwd.cu``) of both trees at one causal
    shape, bare calls in turns, outputs compared bitwise and held to the
    plain version."""
    import torch

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent.flash_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, i, i, i, p]
    parent.flash_fwd.restype = i
    q, k, v = (torch.randn(shape, generator=gen, device="cuda") for shape in ((b, s, h, hd), (b, s, kv, hd),
                                                                              (b, s, kv, hd)))
    outs = {name: torch.empty_like(q) for name in ("parent", "this")}
    stream = torch.cuda.current_stream().cuda_stream
    from repro_torch.kernels.flash_attention import flash as F

    def bare(name):
        fn = parent.flash_fwd if name == "parent" else lib.flash_fwd
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[name].data_ptr(), b, s, s, h, kv, hd,
                 1.0 / hd ** 0.5, 1, 0, F._INT_MAX, stream)
        assert err == 0, (name, err)

    times = {name: [] for name in outs}
    for _ in range(3):
        for name in ("parent", "this", "this", "parent"):
            times[name].append(C.cuda_ms(lambda: bare(name)))
    torch.cuda.synchronize()
    want = F.flash_attention_plain(q, k, v, causal=True)
    abs_v = C.weighted_abs_v(q, k, v, causal=True)
    held = {n: C.flash_error(o, want, abs_v)["max_ratio"] for n, o in outs.items()}
    assert all(r <= 1 for r in held.values()), held
    med = {k: statistics.median(v) for k, v in times.items()}
    C.emit({"shape": [b, s, h, kv, hd], "dtype": "float32", "route": "ffma", "parent_ms": med["parent"],
            "this_ms": med["this"], "this_over_parent": med["this"] / med["parent"], "runs": times,
            "bitwise_equal": bool(torch.equal(outs["this"], outs["parent"])), "max_ratio_vs_plain": held})


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
        parent, parent_group = parent_library(args.parent_src.resolve(), Path(tmp))
        for b, s, h, kv, hd, dtype_name, window in C.FLASH_TIMES:
            if window is not None:
                window_row(parent, parent_group, lib, gen, b, s, h, kv, hd, window)
                continue
            if dtype_name == "float32":
                fp32_row(parent, lib, gen, b, s, h, kv, hd)
                continue
            q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            outs = {name: torch.empty_like(q) for name in ("parent", "this", "flat", "span")}
            stream = torch.cuda.current_stream().cuda_stream
            scale = 1.0 / hd ** 0.5
            l2 = torch.cuda.get_device_properties(q.device).L2_cache_size
            group = F.kv_group(b, s, kv, hd, l2)

            def bare(name):
                o = outs[name]
                ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, s, h, kv, hd, scale, 1)
                if name == "parent":
                    err = parent.flash_fwd_sm90(*ptrs, 0, F._INT_MAX, *([group] if parent_group else []), stream)
                else:
                    err = lib.flash_fwd_sm90(*ptrs, 0, s if name == "span" else F._INT_MAX,
                                             b * kv if name == "flat" else group, stream)
                assert err == 0, (name, err)

            times = {name: [] for name in outs}
            for _ in range(args.reps):
                for name in ("parent", "this", "flat", "span", "span", "flat", "this", "parent"):
                    times[name].append(C.cuda_ms(lambda: bare(name)))
            torch.cuda.synchronize()
            med = {k: statistics.median(v) for k, v in times.items()}
            want = F.flash_attention_plain(q, k, v, causal=True)
            abs_v = C.weighted_abs_v(q, k, v, causal=True)
            held = {n: C.flash_error(o, want, abs_v)["max_ratio"] for n, o in outs.items()}
            del want, abs_v
            assert all(r <= 1 for r in held.values()), held
            C.emit({"shape": [b, s, h, kv, hd], "group": group, "groups": -(-b * kv // group),
                    "parent_ms": med["parent"], "this_ms": med["this"], "flat_ms": med["flat"],
                    "span_ms": med["span"], "this_over_parent": med["this"] / med["parent"],
                    "this_over_flat": med["this"] / med["flat"], "span_over_this": med["span"] / med["this"],
                    "runs": times, "bitwise_equal": {n: bool(torch.equal(outs[n], outs["parent"]))
                                                     for n in ("this", "flat", "span")},
                    "max_ratio_vs_plain": held})

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
