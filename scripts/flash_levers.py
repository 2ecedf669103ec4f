#!/usr/bin/env python3
"""Time the design levers of kernel 4's two routes: copies of
``flash_fwd_sm90.cu`` (bf16) or ``flash_fwd.cu`` (fp32) with one choice
undone, in turns in one process.

    python3 scripts/flash_levers.py [--routes wgmma,ffma] [--variants NAME,...] [--shares 0.25,1.0] [--reps 3]

``VARIANTS`` names text replacements on this tree's source, each of which
undoes one choice of its design:

  - ``two_stages``: a K/V ring of 2 stages, not 3;
  - ``key_tiles_64``: 64-key tiles above hd 80, as before the hd-128
    redesign;
  - ``trap_in_consumers``: the consumers' mbarrier waits trap on a timeout,
    as the producer's do (ptxas then holds the consumer branch to the
    launch's 168 registers).

``FP32_VARIANTS`` do the same on ``flash_fwd.cu`` (route "ffma"):

  - ``mask_every_tile``: the per-element mask on every walked key tile,
    not only on the diagonal, window-edge and ragged ones;
  - ``one_stage``: synchronous copies, a 1-stage ring (each tile's copy
    waits for the previous tile's reads, and its math for the copy);
  - ``expf_separate_scale``: the running max in natural units and p =
    ``__expf(s·scale − m)``, the scale a separate multiply on each score.

Every copy and the untouched source (``base``) are built at once, one
``nvcc`` each, into a temporary directory; the registers each instance's
machine code uses (``_build.sass_registers`` on ``cuobjdump -sass``) and
ptxas's spill bytes are printed per copy.  At each causal bf16 shape of
``chip_smoke.FLASH_TIMES`` every copy runs with the launcher's block-order
group (``flash.kv_group``), and ``base`` also with one group of all B·KV
(batch, kv head) pairs (``base@flat``, the flat order) and at each L2
share of ``--shares`` (``base@<share>``).  Every side is one bare
``ctypes`` call, timed with CUDA events (``chip_smoke.cuda_ms``, the
median of 5 after a warm-up) in turns, forwards then backwards,
``--reps`` times; each output is held to the plain version with
``chip_smoke.flash_error`` and compared bit for bit with ``base``'s.
The fp32 copies run at each fp32 shape of ``chip_smoke.FLASH_TIMES`` (causal),
bare ``flash_fwd`` calls timed the same way in turns, each output held to
the plain version and compared bit for bit with ``base``'s.
Prints one JSON line per copy and per shape, and the card's name and power
limit.  Needs one CUDA card, ``nvcc`` and ``cuobjdump``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)

# variant -> [(text in the source, its replacement), ...]; each text occurs once.
VARIANTS = {
    "two_stages": [("static constexpr int STAGES = 3;", "static constexpr int STAGES = 2;")],
    "key_tiles_64": [("static constexpr int BN = NC == 2 ? 128 : 64;",
                      "static constexpr int BN = HD > 80 ? 64 : 128;")],
    "trap_in_consumers": [("  late |= !mbar_poll(bar, parity, late ? 0u : 1u << 26);",
                           "  if (!mbar_poll(bar, parity)) __trap();")],
}
# The same for the fp32 route's flash_fwd.cu.
FP32_VARIANTS = {
    "mask_every_tile": [("const bool edge = tile_needs_mask(k0, BK, pos_lo, pos_hi, Sk, window, causal);",
                         "const bool edge = true;")],
    "one_stage": [("constexpr int STAGES = 2;", "constexpr int STAGES = 1;")],
    "expf_separate_scale": [("const float c = scale * LOG2E;", "const float c = scale;"),
                            ("return ex2(fmaf(s, c, -m));", "return __expf(s * c - m);"),
                            ("const float corr = ex2(m[i2] - m_new);", "const float corr = __expf(m[i2] - m_new);")],
}


def instance_of(mangled: str) -> str:
    """``<HD>/<SPAN>`` of a mangled ``flash_fwd_sm90_kernel<HD, SPAN>`` name,
    ``<HD>`` of a ``flash_fwd_kernel<HD>`` one."""
    m = re.search(r"kernelILi(\d+)E(?:Lb(\d))?", mangled)
    return "/".join(g for g in m.groups() if g is not None) if m else mangled


def build_variants(names: list[str], tmp: Path, route: str = "wgmma") -> dict:
    """Compile ``base`` and each named variant of ``route``'s source into
    ``tmp`` at once; the loaded libraries and their register reports by
    name."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash as F

    source, variants, entry = ((F.SOURCE_SM90, VARIANTS, "flash_fwd_sm90") if route == "wgmma"
                               else (F.SOURCE, FP32_VARIANTS, "flash_fwd"))
    text = source.read_text()
    for header in source.parent.glob("*.cuh"):
        (tmp / header.name).write_text(header.read_text())
    jobs = {}
    for name in ("base", *names):
        src = text
        for old, new in variants.get(name, []):
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        path = tmp / f"{entry}_{name}.cu"
        path.write_text(src)
        jobs[name] = (path, tmp / f"{entry}_{name}.so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(lambda j: _build.compile_library([j[0]], j[1]), jobs.values())))
    ref = getattr(F.build(), entry)
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    libs = {}
    for name, (_, so) in jobs.items():
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        libs[name] = lib
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True, check=True).stdout
        C.emit({"route": route, "variant": name,
                "sass_registers": {instance_of(k): v for k, v in _build.sass_registers(sass).items()},
                "spill_bytes": {instance_of(k): v.get("spill_bytes")
                                for k, v in _build.ptxas_report(logs[name]).items()}})
    return libs


def fp32_levers(names: list[str], reps: int, gen) -> None:
    """The fp32 copies at each fp32 shape of ``chip_smoke.FLASH_TIMES``:
    bare ``flash_fwd`` calls in turns, held to the plain version, compared
    bitwise with ``base``."""
    import torch

    from repro_torch.kernels.flash_attention import flash as F

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(names, Path(tmp), "ffma")
        for b, s, h, kv, hd, dtype_name, window in C.FLASH_TIMES:
            if dtype_name != "float32" or window is not None:
                continue
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
            outs = {n: torch.empty_like(q) for n in libs}
            stream = torch.cuda.current_stream().cuda_stream

            def call(n):
                err = libs[n].flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[n].data_ptr(), b, s, s, h,
                                        kv, hd, 1.0 / hd ** 0.5, 1, 0, F._INT_MAX, stream)
                assert err == 0, (n, err)

            order = list(libs)
            times = {n: [] for n in order}
            for _ in range(reps):
                for n in order + order[::-1]:
                    times[n].append(C.cuda_ms(lambda: call(n)))
            torch.cuda.synchronize()
            want = F.flash_attention_plain(q, k, v, causal=True)
            abs_v = C.weighted_abs_v(q, k, v, causal=True)
            row = {"route": "ffma", "shape": [b, s, h, kv, hd]}
            for n in order:
                row[n] = {"ms": statistics.median(times[n]),
                          "max_ratio": C.flash_error(outs[n], want, abs_v)["max_ratio"],
                          "bitwise_base": bool(torch.equal(outs[n], outs["base"])), "runs": times[n]}
            C.emit(row)
            del q, k, v, outs, want, abs_v
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--routes", default="wgmma,ffma")
    ap.add_argument("--variants", default=",".join([*VARIANTS, *FP32_VARIANTS]))
    ap.add_argument("--shares", default="0.25,1.0")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    names = [n for n in args.variants.split(",") if n]
    routes = [r for r in args.routes.split(",") if r]
    shares = [float(s) for s in args.shares.split(",") if s]

    import torch

    if not torch.cuda.is_available():
        print("flash_levers: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.flash_attention import flash as F

    print(C.smi("name,power.limit"), flush=True)
    gen = make_generator(args.seed + 15, "cuda")
    if "ffma" in routes:
        fp32_levers([n for n in names if n in FP32_VARIANTS], args.reps, gen)
    if "wgmma" not in routes:
        print(C.smi("name,power.limit"), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants([n for n in names if n in VARIANTS], Path(tmp))
        for b, s, h, kv, hd, dtype_name, window in C.FLASH_TIMES:
            if dtype_name != "bfloat16" or window is not None:
                continue
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
            l2 = torch.cuda.get_device_properties(q.device).L2_cache_size
            sides = {n: (libs[n], F.kv_group(b, s, kv, hd, l2)) for n in libs}
            sides["base@flat"] = (libs["base"], b * kv)
            for share in shares:
                sides[f"base@{share}"] = (libs["base"], max(1, min(b * kv, int(l2 * share) // (4 * s * hd))))
            outs = {n: torch.empty_like(q) for n in sides}
            stream = torch.cuda.current_stream().cuda_stream

            def call(n):
                lib, group = sides[n]
                err = lib.flash_fwd_sm90(q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[n].data_ptr(), b, s, s, h,
                                         kv, hd, 1.0 / hd ** 0.5, 1, 0, F._INT_MAX, group, stream)
                assert err == 0, (n, err)

            order = list(sides)
            times = {n: [] for n in order}
            for _ in range(args.reps):
                for n in order + order[::-1]:
                    times[n].append(C.cuda_ms(lambda: call(n)))
            torch.cuda.synchronize()
            want = F.flash_attention_plain(q, k, v, causal=True)
            abs_v = C.weighted_abs_v(q, k, v, causal=True)
            row = {"shape": [b, s, h, kv, hd]}
            for n in order:
                row[n] = {"ms": statistics.median(times[n]), "group": sides[n][1],
                          "max_ratio": C.flash_error(outs[n], want, abs_v)["max_ratio"],
                          "bitwise_base": bool(torch.equal(outs[n], outs["base"])), "runs": times[n]}
            C.emit(row)
            del q, k, v, outs, want, abs_v
            torch.cuda.empty_cache()
    print(C.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
