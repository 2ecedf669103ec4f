#!/usr/bin/env python3
"""Measure what each design lever of kernel 1 (the fused min-d² scan) gives.

    python3 scripts/minscan_levers.py [--parent OLD.cu] [--alt OTHER.cu] [--parent-src OLD/src]
                                      [--shapes NAME ...] [--reps 5] [--seed 0]

Run from the repository root on a machine with one NVIDIA GPU and nvcc.
It builds ``src/repro_torch/kernels/hausdorff/csrc/fused_minscan.cu``
several times with the resident instance's tuning knobs overridden (ring
depth ``MINSCAN_RING``, unroll of the 4-k steps ``MINSCAN_STEP_UNROLL``,
register tile ``MINSCAN_QN``: 8 × QN entries a consumer thread, a 128 ×
16·QN tile pair; the producer's registers ``MINSCAN_PRODUCER_REGS``), all
``nvcc`` runs started together, and times each build at the two shapes
phase 7 of ``chip_smoke.py`` times (65,536² × 256, and ProHD's sweep,
41,930 × 1,048,576 × 256) in each launch mode: a-tile resident or
streamed, directed or bidirectional instance. ``--parent`` adds an
earlier source of the kernel with the register-staged design's C
interface (``fused_minscan(a, b, dtype, ...)``, one 2-D grid of a-tiles ×
b-chunks), timed at the same shapes; extract it with ``git show``.

It also times each build at 256 × 256 × 256, the size of a stage-2b
refine or a brute-force call of the corpus search. Times are CUDA-event
medians of ``--reps`` calls after a warm-up (at 256², of 50 calls in a
row each, divided by 50, the two fills of +inf included). The
default build is timed first and again last, to show the drift within the
call. Every build's row mins (and column mins, bidirectional) must equal
the default build's bit for bit, and the parent's too. It prints one JSON
line per measurement, the card's name, power limit and SM clock under the
kernel's load, and exits non-zero if a build fails or a result differs.
``--alt`` times another source with this kernel's C interface beside the
builds (such as the parent commit's, ``git show``; a header it includes
that is not beside it is taken from this tree's ``csrc/``).  Each build's
registers and spill bytes per instance are ptxas's (``-Xptxas -v``); where
a kernel trades registers with ``setmaxnreg``, ptxas reports the launch's
budget, so the machine code's own count is given too. ``--parent-src`` (an earlier checkout's ``src/``) adds the host-clock time
per call of the ops wrappers at 256², parent and this tree in turns. The
default (and the alternative) build's k-loop is also counted from
``cuobjdump -sass`` (opcodes and the static schedule's stall cycles), for
the instruction mix the card is asked to issue.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src/repro_torch/kernels/hausdorff/csrc/fused_minscan.cu"
OUT = ROOT / "build" / "levers"
D = 256
# The last shape is a stage-2b refine or brute-force call, timed over
# TINY_CALLS calls per event pair (host overhead is not in these times).
SHAPES = (("65536x65536", 65_536, 65_536), ("sweep", 41_930, 1_048_576), ("256x256", 256, 256))
TINY_CALLS = 50
# name → the resident instance's knobs overridden; the first is the
# source's default.
VARIANTS = {"default": {}, "ring2": {"MINSCAN_RING": 2}, "unroll1": {"MINSCAN_STEP_UNROLL": 1},
            "unroll4": {"MINSCAN_STEP_UNROLL": 4}, "qn8": {"MINSCAN_QN": 8},
            "preg24": {"MINSCAN_PRODUCER_REGS": 24}}
TILE = 128
MAX_SMEM = 232_448


# Host-clock µs per call of ops.min_sqdists / ops.fused_min_sqdists at
# 256 × 256 × 256 (a stage-2b refine): median and least of 10 blocks of 200
# calls, in a child process so that an earlier checkout's package can be
# imported instead.  (scripts/refine_trace.py traces a whole refine loop.)
HOST_PROBE = """
import json, statistics, time, torch
from repro_torch.kernels.hausdorff import ops
g = torch.Generator(device="cuda").manual_seed(0)
a = torch.rand(256, 256, device="cuda", generator=g)
b = torch.rand(256, 256, device="cuda", generator=g)
out = {}
for name, fn in (("min_sqdists", lambda: ops.min_sqdists(a, b)), ("fused_min_sqdists", lambda: ops.fused_min_sqdists(a, b))):
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    blocks = []
    for _ in range(10):
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) / 200 * 1e6)
    out[name + "_us"] = {"median": statistics.median(blocks), "min": min(blocks)}
print(json.dumps(out))
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def sass_k_loop(lib: Path) -> dict:
    """Static schedule of each kernel instance's k-loop in a built library,
    from ``cuobjdump -sass``: one iteration (a slice: wait, barrier, copies,
    the unrolled products), i.e. the instructions from the target of the
    backward branch after the last LDS.128 to that branch, counted by
    opcode, and the sum of the stall counts in their control words (sm_90
    encoding: 4 bits at bit 105 of the 128-bit instruction).  A loop that
    issues one instruction a clock has a stall sum equal to its length."""
    import re
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split()[0]
        lines = part.splitlines()
        ins = []  # (address, opcode, operands, stall)
        for i, ln in enumerate(lines):
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);\s*/\* (0x[0-9a-f]+) \*/", ln)
            if m and i + 1 < len(lines):
                hi = re.search(r"/\* (0x[0-9a-f]+) \*/", lines[i + 1])
                word = (int(hi.group(1), 16) << 64) | int(m.group(3), 16)
                tok = m.group(2).split()
                if tok[0].startswith("@"):
                    tok = tok[1:]
                ins.append((int(m.group(1), 16), tok[0], " ".join(tok[1:]), (word >> 105) & 0xF))
        lds = [i for i, r in enumerate(ins) if r[1] == "LDS.128"]
        if not lds:
            continue
        first = ins[lds[0]][0]
        back = next((r for r in ins[lds[-1]:] if r[1] == "BRA" and int(r[2].split()[-1], 16) < first), None)
        if back is None:
            continue
        head = int(back[2].split()[-1], 16)
        body = [r for r in ins if head <= r[0] <= back[0]]
        ops = {}
        for r in body:
            key = r[1] if r[1] in ("FFMA", "LDS.128") else "other"
            ops[key] = ops.get(key, 0) + 1
        out[name] = {"instructions": len(body), "by_opcode": ops, "stall_cycles": sum(r[3] for r in body)}
    return out


def sass_registers(lib: Path) -> dict[str, int]:
    """Registers each kernel of a built library uses, from its machine code."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return _build.sass_registers(text)


def build_all(parent: Path | None, alt: Path | None = None) -> dict:
    """Compile every variant (and the parent, and an alternative source) in
    parallel; load each."""
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, knobs in VARIANTS.items():
        jobs[name] = [nvcc, *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in knobs.items()),
                      "-shared", "-o", str(OUT / f"{name}.so"), str(SOURCE)]
    include = f"-I{SOURCE.parent}"
    if parent is not None:
        jobs["parent"] = [nvcc, *_build.NVCC_FLAGS, include, "-shared", "-o", str(OUT / "parent.so"), str(parent)]
    if alt is not None:
        jobs["alt"] = [nvcc, *_build.NVCC_FLAGS, include, "-shared", "-o", str(OUT / "alt.so"), str(alt)]
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(v, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, v in jobs.items()}
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for k, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {k}:\n{logs[k]}")
    libs = {}
    for k in jobs:
        lib = ctypes.CDLL(str(OUT / f"{k}.so"))
        pv, i = ctypes.c_void_p, ctypes.c_int
        if k == "parent":
            lib.fused_minscan.argtypes = [pv, pv, i, pv, pv, pv, ctypes.c_longlong, pv, pv, pv, pv,
                                          i, i, i, i, i, i, pv]
        else:
            lib.fused_minscan.argtypes = [pv, pv, pv, pv, pv, ctypes.c_longlong, pv, pv, pv, pv,
                                          i, i, i, i, i, i, i, i, i, pv]
            lib.fused_minscan_smem.argtypes = [i, i]
            lib.fused_minscan_occupancy.argtypes = [i, i, i]
        lib.fused_minscan.restype = i
        libs[k] = lib
        report = {n: v for n, v in _build.ptxas_report(logs[k]).items() if "fused_minscan_" in n}
        for n, regs in sass_registers(OUT / f"{k}.so").items():
            if n in report:
                report[n]["sass_registers"] = regs
        emit({"build": k, "knobs": VARIANTS.get(k), "kernels": report})
        if any(v.get("spill_bytes", 0) for v in report.values()):
            print(f"minscan_levers: {k} spills", file=sys.stderr)
    emit({"build_s": time.perf_counter() - t0})
    return libs


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def launcher(lib, parent: bool, a, b, a2, b2, min_a, min_b, sms: int, resident: bool, directed: bool):
    """A zero-argument call of one build in one mode (outputs reset to +inf)."""
    import torch

    n_a, n_b = a.shape[0], b.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    if parent:
        tiles_a, tiles_b = math.ceil(n_a / TILE), math.ceil(n_b / TILE)
        n_chunks = min(tiles_b, 65535, max(1, math.ceil(8 * sms / tiles_a)))
        per_chunk = math.ceil(tiles_b / n_chunks)
        args = (a.data_ptr(), b.data_ptr(), 0, a2.data_ptr(), b2.data_ptr(), None, 0, None, None,
                min_a.data_ptr(), min_b.data_ptr(), n_a, n_b, D, 4, 4, per_chunk, stream)
    else:
        smem = lib.fused_minscan_smem(D, int(resident))
        occ = lib.fused_minscan_occupancy(int(resident), int(directed), smem)
        assert occ >= 1, (resident, directed, smem)
        grid = min(math.ceil(n_a / TILE) * math.ceil(n_b / TILE), sms * occ)
        args = (a.data_ptr(), b.data_ptr(), a2.data_ptr(), b2.data_ptr(), None, 0, None, None,
                min_a.data_ptr(), min_b.data_ptr(), n_a, n_b, D, int(resident), int(directed), 4, 4,
                grid, smem, stream)

    def call():
        for _ in range(TINY_CALLS if n_b <= TILE * 2 else 1):
            min_a.fill_(torch.inf)
            min_b.fill_(torch.inf)
            err = lib.fused_minscan(*args)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

    return call


def clocks_under(call, seconds: float = 2.0) -> str:
    """nvidia-smi's SM clock and power draw, read while ``call`` runs in a loop."""
    import torch

    box = {}
    t = threading.Thread(target=lambda: (time.sleep(seconds / 2), box.update(smi=smi("clocks.sm,power.draw"))))
    t.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        call()
        torch.cuda.synchronize()
    t.join()
    return box["smi"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--alt", type=Path, default=None,
                    help="another source of this kernel with the same C interface, timed as build 'alt'")
    ap.add_argument("--parent-src", type=Path, default=None,
                    help="an earlier checkout's src/: its ops wrapper's host time per call is measured too")
    ap.add_argument("--shapes", nargs="*", default=[s[0] for s in SHAPES])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("minscan_levers: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data.pointclouds import make_generator, random_clouds

    card = smi("name,power.limit")
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    peak = sms * 128 * 2 * max_mhz * 1e6
    libs = build_all(args.parent, args.alt)
    for name in ("default", "alt"):
        if name in libs:
            emit({"sass_k_loop": name, "kernels": sass_k_loop(OUT / f"{name}.so")})
    gen = make_generator(args.seed, "cuda")
    ok = True
    modes = [(r, d) for r in (True, False) for d in (False, True)]  # bidirectional first
    for shape, n_a, n_b in SHAPES:
        if shape not in args.shapes:
            continue
        a, b = random_clouds(gen, n_a, n_b, D)
        a2, b2 = (a * a).sum(1), (b * b).sum(1)
        min_a = torch.empty(n_a, device="cuda")
        min_b = torch.empty(n_b, device="cuda")
        reps = args.reps if n_b <= 65_536 else max(3, args.reps // 2)
        bound_ms = 2.0 * n_a * n_b * D / peak * 1e3
        ref = {}
        order = ["default"] + [k for k in libs if k != "default"] + ["default"]
        for pos, name in enumerate(order):
            is_parent = name == "parent"
            for resident, directed in ([(False, False)] if is_parent else modes):
                if not is_parent and libs[name].fused_minscan_smem(D, int(resident)) > MAX_SMEM:
                    emit({"shape": shape, "build": name, "resident": resident, "directed": directed,
                          "skipped": "shared memory"})
                    continue
                call = launcher(libs[name], is_parent, a, b, a2, b2, min_a, min_b, sms, resident, directed)
                ms = cuda_ms(call, reps) / (TINY_CALLS if n_b <= TILE * 2 else 1)
                out = (min_a.clone(), None if directed else min_b.clone())
                if name == "default" and pos == 0:
                    ref[(resident, directed)] = out
                    same = True
                else:
                    want = ref.get((resident, directed), ref[(True, False)])
                    same = bool(torch.equal(out[0], want[0]))
                    if out[1] is not None:
                        same &= bool(torch.equal(out[1], want[1]))
                # directed row mins against bidirectional ones, on the default build
                if directed and (True, False) in ref:
                    same &= bool(torch.equal(out[0], ref[(True, False)][0]))
                ok &= same
                row = {"shape": shape, "build": name, "again": pos > 0 and name == "default",
                       "resident": None if is_parent else resident, "directed": directed,
                       "ms": ms, "share_of_bound": bound_ms / ms, "bitwise_default": same}
                if name == "default" and pos == 0 and resident and not directed:
                    row["clocks_sm_power_under_load"] = clocks_under(call)
                emit(row)
        del a, b, a2, b2, min_a, min_b
        torch.cuda.empty_cache()
    if args.parent_src is not None:
        # parent, change, change, parent: host time per wrapper call
        for src in (args.parent_src, ROOT / "src", ROOT / "src", args.parent_src):
            out = subprocess.run([sys.executable, "-c", HOST_PROBE], capture_output=True, text=True,
                                 check=True, env={**os.environ, "PYTHONPATH": str(src)}, timeout=300)
            emit({"wrapper_host": "parent" if src == args.parent_src else "change",
                  **json.loads(out.stdout.strip().splitlines()[-1])})
    print(smi("name,power.limit"), flush=True)
    emit({"ok": ok, "bound_ms": {s: 2.0 * n_a * n_b * D / peak * 1e3 for s, n_a, n_b in SHAPES}})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
