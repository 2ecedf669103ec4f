#!/usr/bin/env python3
"""Plant faults in the flash-attention kernel and show that chip_smoke's
tolerance rejects each of them.

    python3 scripts/flash_planted_faults.py [--seed 0]

Builds copies of ``src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu``
into a temporary directory, each with one fault planted (a key tile skipped
or counted twice, a missing rescale of acc or l, the wrong kv head), one
``nvcc`` each, started together.  Each copy and the untouched source run at
TinyLlama's prefill shape (8 × 4,096, 32 query and 4 kv heads of 64, bf16),
causal and not, and are held entry by entry to the plain version with
``chip_smoke.flash_error``, the check that phases 13-15 of ``chip_smoke.py``
apply.  Prints one JSON line per (variant, case) and a summary line; exits
0 when the untouched source passes every case and every fault fails every
case.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)

SHAPE = (8, 4_096, 32, 4, 64)  # B, S, H, KV, hd
LOOP = "for (int kt = 0; kt < n_tiles; ++kt) {"
ACC = "acc[i][j] = acc[i][j] * corr[i] + pv[i][j];"
# variant -> (text in the source, its replacement); each text occurs once.
FAULTS = {
    "skip_last_tile": (LOOP, "for (int kt = 0; kt < n_tiles - 1; ++kt) {"),
    "skip_middle_tile": (LOOP, LOOP + "\n    if (kt == n_tiles / 2) continue;"),
    "double_first_tile": (ACC, "acc[i][j] = acc[i][j] * corr[i] + (kt == 0 ? 2.f : 1.f) * pv[i][j];"),
    "no_rescale_acc": (ACC, "acc[i][j] = acc[i][j] + pv[i][j];"),
    "no_rescale_l": ("l[i] = l[i] * corr[i] + half_warp_sum(row_sum);",
                     "l[i] = l[i] + half_warp_sum(row_sum);"),
    "kv_head_mod": ("const int kvh = h / (H / KV);", "const int kvh = h % KV;"),
}


def build_variants(tmp: Path) -> dict:
    """Compile the untouched source and each planted fault into ``tmp``,
    all nvcc processes at once; the loaded libraries by variant."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash as F

    text = F.SOURCE.read_text()
    procs = {}
    for name, (old, new) in {"none": ("", ""), **FAULTS}.items():
        if old:
            assert text.count(old) == 1, (name, text.count(old))
        src = tmp / f"flash_fwd_{name}.cu"
        src.write_text(text.replace(old, new) if old else text)
        so = tmp / f"flash_fwd_{name}.so"
        procs[name] = (so, subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ref = F.build().flash_fwd
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.flash_fwd.argtypes, lib.flash_fwd.restype = ref.argtypes, ref.restype
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_planted_faults: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.data.pointclouds import make_generator
    from repro_torch.kernels.flash_attention import flash as F

    print(C.smi("name,power.limit"), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        b, s, h, kv, hd = SHAPE
        gen = make_generator(args.seed + 13, "cuda")
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        pristine = F._lib
        verdicts = {}
        try:
            for causal in (True, False):
                want = F.flash_attention_plain(q, k, v, causal=causal)
                abs_v = C.weighted_abs_v(q, k, v, causal=causal)
                for name, lib in libs.items():
                    F._lib = lib
                    out = F.flash_attention(q, k, v, causal=causal)
                    e = C.flash_error(out, want, abs_v)
                    passed = e["max_ratio"] <= 1
                    verdicts[(name, causal)] = passed == (name == "none")
                    C.emit({"variant": name, "causal": causal, "shape": list(SHAPE), "passed": passed,
                            "entries": out.numel(), **e})
                    del out
                del want, abs_v
        finally:
            F._lib = pristine
    ok = all(verdicts.values())
    C.emit({"planted_faults": len(FAULTS), "as_expected": ok,
            "wrong": [f"{n} causal={c}" for (n, c), good in verdicts.items() if not good]})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
