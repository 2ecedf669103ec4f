#!/usr/bin/env python3
"""Plant faults in the tensor-core flash-attention kernel and show that
chip_smoke's tolerance rejects each of them.

    python3 scripts/flash_planted_faults.py [--seed 0]

Builds copies of ``src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu``
(the bf16 route, ``flash.route`` ``"wgmma"``) into a temporary directory,
each with one fault planted: the last or a middle key tile given no weight,
the first tile's p counted twice in P·V, a missing rescale of acc or l, the
wrong kv head, or the diagonal tile left unmasked; one ``nvcc`` each,
started together.  Each copy and the untouched source run at TinyLlama's
prefill shape (8 × 4,096, 32 query and 4 kv heads of 64, bf16), causal and
not, and are held entry by entry to the plain version with
``chip_smoke.flash_error``, the check that phases 13-15 of ``chip_smoke.py``
apply.  Prints one JSON line per (variant, case) and a summary line; exits
0 when the untouched source passes every case and every fault fails every
case it can reach (the unmasked diagonal: the causal one; without the mask
it is no fault).  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402  (puts src/ on the path)

SHAPE = (8, 4_096, 32, 4, 64)  # B, S, H, KV, hd
SOFTMAX = "c.softmax(kt * BN, row0, col0, Sk, masked(kt), causal, scale_log2);"
# variant -> (text in the source, its replacement); each text occurs once.
FAULTS = {
    "skip_last_tile": (SOFTMAX, "c.softmax(kt * BN, row0, col0, kt == n_tiles - 1 ? 0 : Sk, "
                                "masked(kt) || kt == n_tiles - 1, causal, scale_log2);"),
    "skip_middle_tile": (SOFTMAX, "c.softmax(kt * BN, row0, col0, kt == n_tiles / 2 ? 0 : Sk, "
                                  "masked(kt) || kt == n_tiles / 2, causal, scale_log2);"),
    "double_first_tile": ("c.softmax(0, row0, col0, Sk, masked(0), causal, scale_log2);",
                          "c.softmax(0, row0, col0, Sk, masked(0), causal, scale_log2);\n"
                          "    for (float& x : c.s) x *= 2.f;"),
    "no_rescale_acc": ("for (int r = 0; r < N64; ++r) o64[r][i] *= corr[(i >> 1) & 1];",
                       "for (int r = 0; r < N64; ++r) o64[r][i] *= 1.f;"),
    "no_rescale_l": ("for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];",
                     "for (int r = 0; r < 2; ++r) l[r] = l[r] + sum[r];"),
    "kv_head_mod": ("const int kvh = h / (H / KV);", "const int kvh = h % KV;"),
    "diagonal_unmasked": ("if (col >= Sk || (causal && col > row)) s[i] = -CUDART_INF_F;",
                          "if (col >= Sk) s[i] = -CUDART_INF_F;"),
}
CAUSAL_ONLY = {"diagonal_unmasked"}


def build_variants(tmp: Path) -> dict:
    """Compile the untouched source and each planted fault into ``tmp``,
    all nvcc processes at once; the loaded libraries by variant."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash as F

    text = F.SOURCE_SM90.read_text()
    jobs = {}
    for name, (old, new) in {"none": ("", ""), **FAULTS}.items():
        if old:
            assert text.count(old) == 1, (name, text.count(old))
        src = tmp / f"flash_fwd_sm90_{name}.cu"
        src.write_text(text.replace(old, new) if old else text)
        jobs[name] = (src, tmp / f"flash_fwd_sm90_{name}.so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(_build.compile_library, [src], so) for src, so in jobs.values()]:
            f.result()
    ref = F.build().flash_fwd_sm90
    libs = {}
    for name, (_, so) in jobs.items():
        lib = ctypes.CDLL(str(so))
        lib.flash_fwd_sm90.argtypes, lib.flash_fwd_sm90.restype = ref.argtypes, ref.restype
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
                    is_fault = name != "none" and (causal or name not in CAUSAL_ONLY)
                    verdicts[(name, causal)] = passed != is_fault
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
