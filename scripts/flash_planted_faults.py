#!/usr/bin/env python3
"""Plant faults in the tensor-core flash-attention kernel and show that
chip_smoke's tolerance rejects each of them.

    python3 scripts/flash_planted_faults.py [--seed 0]

Builds copies of ``src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu``
(the bf16 route, ``flash.route`` ``"wgmma"``) into a temporary directory,
each with one fault planted; one ``nvcc`` each, started together.

``FAULTS`` sit in code that both instances run, but the unmasked diagonal,
which only the plain causal instance ``<HD, false>`` has: the last or a
middle key tile given no weight, the first tile's p counted twice in P·V, a
missing rescale of acc or l, the wrong kv head, the diagonal tile left
unmasked, and a head index off by one within a group of the block order
(a group's first head is never computed, its last twice).  They run at
TinyLlama's prefill shape (8 × 4,096, 32 query and 4 kv heads of 64,
bf16), causal and not, and each must fail every case it can reach (the
unmasked diagonal: the causal one; without the mask it is no fault).  The
block-order fault must also fail ``ORDER_CASE``, the case of phase 13 that
spans several groups of the order at hd 128 (MHA, 26 (batch, head) pairs
in groups of 9, 9 and 8 on a 50 MiB L2), where the untouched source
passes.

``SPAN_FAULTS`` sit in code that only the instance for query offsets and
windows ``<HD, true>`` runs: the window test off by one, the first key tile
of a block's walk skipped, and hidden keys masked with −inf in place of the
finite ``MASKED``.  They run at ``SPAN_CASES`` (a 50-key window at 1 ×
1,024, and an offset and window that leave rows seeing no key); each must
fail the cases it names, pass the others (−inf masking is no fault where
every row sees a key) and pass TinyLlama's shape, whose instance does not
hold it.

``FP32_FAULTS`` are planted in copies of ``flash_fwd.cu``, the fp32 route
(``flash.route`` ``"ffma"``): a middle key tile of each block given no
weight, no rescale of acc, the wrong kv head, the interior-tile
classification one tile too far (the diagonal and the ragged Sk tile go
unmasked), and a ring stage read before its copy is waited for (the tile's
math reads the stage whose copy was issued last).  They run at every fp32
case of ``chip_smoke.FLASH_CASES`` (phase 13: windows, offsets, rows that
see no key, ragged edges, every instance); each must fail every case it
reaches (:func:`fp32_reaches`) and pass the others.

Every copy and the untouched source are held entry by entry to the plain
version with ``chip_smoke.flash_error``, the check that phases 13-15 of
``chip_smoke.py`` apply; the untouched source must pass every case.  Each
launch writes into an output filled with NaN, so rows a faulty copy never
stores fail the check too.
Prints one JSON line per (variant, case) and a summary line; exits 0 when
every verdict is as expected.  Needs one CUDA card and ``nvcc``.
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
SOFTMAX = "c.template softmax<SPAN>(kt * BN, pos0, col0, Sk, masked(kt), causal, window, scale_log2);"
# variant -> (text in the source, its replacement); each text occurs once.
FAULTS = {
    "skip_last_tile": (SOFTMAX, "c.template softmax<SPAN>(kt * BN, pos0, col0, i == n_tiles - 1 ? 0 : Sk, "
                                "masked(kt) || i == n_tiles - 1, causal, window, scale_log2);"),
    "skip_middle_tile": (SOFTMAX, "c.template softmax<SPAN>(kt * BN, pos0, col0, i == n_tiles / 2 ? 0 : Sk, "
                                  "masked(kt) || i == n_tiles / 2, causal, window, scale_log2);"),
    "double_first_tile": ("c.template softmax<SPAN>(kt0 * BN, pos0, col0, Sk, masked(kt0), causal, window, "
                          "scale_log2);",
                          "c.template softmax<SPAN>(kt0 * BN, pos0, col0, Sk, masked(kt0), causal, window, "
                          "scale_log2);\n"
                          "    for (float& x : c.s) x *= 2.f;"),
    "no_rescale_acc": ("for (int r = 0; r < N64; ++r) o64[r][i] *= corr[(i >> 1) & 1];",
                       "for (int r = 0; r < N64; ++r) o64[r][i] *= 1.f;"),
    "no_rescale_l": ("for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];",
                     "for (int r = 0; r < 2; ++r) l[r] = l[r] + sum[r];"),
    "kv_head_mod": ("const int kvh = h / (H / KV);", "const int kvh = h % KV;"),
    "diagonal_unmasked": ("} else if (col >= Sk || (causal && col > pos)) {", "} else if (col >= Sk) {"),
    "block_head_off_by_one": ("const int bh = first * (H / KV) + r % heads;",
                              "const int bh = first * (H / KV) + min(r % heads + 1, heads - 1);"),
}
CAUSAL_ONLY = {"diagonal_unmasked"}
# (B, Sq, Sk, H, KV, hd, dtype, causal): the case of chip_smoke.FLASH_CASES
# that the block-order fault must fail as well.
ORDER_CASE = (2, 4000, 4000, 13, 13, 128, "bfloat16", True)
ORDER_FAULTS = ("block_head_off_by_one",)
# case -> (B, Sq, Sk, H, KV, hd, q_offset, window), bf16, causal.
SPAN_CASES = {
    "window50": (1, 1_024, 1_024, 32, 4, 64, 0, 50),
    # positions 1,100-1,299 over 1,000 keys, window 150: rows from 1,149 on see no key
    "no_key_rows": (1, 200, 1_000, 8, 2, 64, 1_100, 150),
}
SPAN_MASK = "else if (causal && !visible(pos, col, window)) s[i] = MASKED;"
# variant -> (text in the source, its replacement, the SPAN_CASES it must fail)
SPAN_FAULTS = {
    "window_off_by_one": (SPAN_MASK, "else if (causal && !visible(pos, col, window + 1)) s[i] = MASKED;",
                          ("window50", "no_key_rows")),
    "first_tile_skipped": ("const int kt0 = tiles.first, n_tiles = tiles.count;",
                           "const int kt0 = tiles.first + (SPAN && tiles.count > 1), "
                           "n_tiles = tiles.count - (SPAN && tiles.count > 1);",
                           ("window50", "no_key_rows")),
    # where every row sees a key, the running max starts finite and −inf
    # gives the same p = 0 as MASKED: no fault there
    "masked_as_inf": (SPAN_MASK, "else if (causal && !visible(pos, col, window)) s[i] = -CUDART_INF_F;",
                      ("no_key_rows",)),
}

# variant -> (text in flash_fwd.cu, its replacement); each text occurs once.
FP32_FAULTS = {
    "skip_middle_tile": ("if (edge) mask_scores<SM, SN, RGS, KG>(s, k0 + kg, pos_lo + rg, Sk, causal, window);",
                         "if (edge || i == tiles.count / 2) mask_scores<SM, SN, RGS, KG>(s, k0 + kg, pos_lo + rg, "
                         "i == tiles.count / 2 ? 0 : Sk, causal, window);"),
    "no_rescale_acc": ("for (int cc = 0; cc < ON; ++cc) acc[i2][cc] *= f;",
                       "for (int cc = 0; cc < ON; ++cc) acc[i2][cc] *= 1.f;"),
    "kv_head_mod": ("const int kvh = h / (H / KV);", "const int kvh = h % KV;"),
    "interior_one_tile_too_far": ("tile_needs_mask(k0, BK,", "tile_needs_mask(k0 - BK, BK,"),
    "stage_read_early": ("return ring + (i % STAGES) * T::STAGE;", "return ring + ((i + 1) % STAGES) * T::STAGE;"),
}
INT_MAX = 2 ** 31 - 1


def fp32_tiles(hd: int) -> tuple[int, int, int]:
    """(query rows per CTA, rows per warp, keys per tile) of flash_fwd.cu's
    ``Shape`` at the instance that runs ``hd``."""
    from repro_torch.kernels.flash_attention import flash as F

    return F._block_rows("ffma", hd), 16, 64 if F.instance("ffma", hd) <= 64 else 32


def fp32_cases(cases) -> list:
    """The fp32 cases of ``chip_smoke.FLASH_CASES``."""
    return [c for c in cases if c[6] == "float32"]


def _walk(case):
    """(tile count, [(first row's position, last stored row's, k0)]) of
    every (query block, warp, walked key tile) of ``case``: flash_mask.cuh's
    ``key_tiles`` per block, its rows in warps."""
    _, sq, sk, _, _, hd, _, causal, off, win = (*case, 0, None)[:10]
    win = INT_MAX if win is None else max(win, 0)
    bq, wr, bk = fp32_tiles(hd)
    out, most = [], 0
    for q0 in range(0, sq, bq):
        p_lo, p_hi = off + q0, off + min(q0 + bq, sq) - 1
        n = -(-sk // bk)
        first = 0
        if causal and not (p_lo < 0 or win <= 0 or p_hi - win + 1 > sk - 1):
            first = max(0, p_lo - win + 1) // bk
            n = min(p_hi, sk - 1) // bk - first + 1
        most = max(most, n)
        for w0 in range(q0, min(q0 + bq, sq), wr):
            out += [(off + w0, off + min(w0 + wr, sq) - 1, kt * bk) for kt in range(first, first + n)]
    return most, out


def _needs_mask(k0, bk, p_lo, p_hi, sk, win, causal) -> bool:
    """flash_mask.cuh's ``tile_needs_mask``."""
    return k0 + bk > sk or (bool(causal) and (k0 + bk - 1 > p_lo or p_hi - k0 >= win))


def fp32_reaches(name: str, case) -> bool:
    """Whether the fp32 fault ``name`` changes the output of ``case``: the
    kv head where 1 < KV < H; the rescale where some block walks two tiles
    or more; the classification where some walked tile that needs the mask
    is taken as interior one tile back; a dropped middle tile (every walked
    tile holds a key some row weighs) and an early-read stage everywhere."""
    _, _, sk, h, kv, hd, _, causal, _, win = (*case, 0, None)[:10]
    if name == "kv_head_mod":
        return 1 < kv < h
    if name in ("skip_middle_tile", "stage_read_early"):
        return True
    most, walked = _walk(case)
    if name == "no_rescale_acc":
        return most >= 2
    bk = fp32_tiles(hd)[2]
    win = INT_MAX if win is None else max(win, 0)
    return any(_needs_mask(k0, bk, lo, hi, sk, win, causal) and not _needs_mask(k0 - bk, bk, lo, hi, sk, win, causal)
               for lo, hi, k0 in walked)


def build_fp32_variants(tmp: Path) -> dict:
    """Compile the untouched flash_fwd.cu and each fp32 fault into ``tmp``,
    all nvcc processes at once; the loaded libraries by variant."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash as F

    text = F.SOURCE.read_text()
    for header in F.SOURCE.parent.glob("*.cuh"):
        (tmp / header.name).write_text(header.read_text())
    jobs = {}
    for name, (old, new) in {"none": ("", ""), **FP32_FAULTS}.items():
        if old:
            assert text.count(old) == 1, (name, text.count(old))
        src = tmp / f"flash_fwd_{name}.cu"
        src.write_text(text.replace(old, new) if old else text)
        jobs[name] = (src, tmp / f"flash_fwd_{name}.so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(_build.compile_library, [src], so) for src, so in jobs.values()]:
            f.result()
    ref = F.build().flash_fwd
    libs = {}
    for name, (_, so) in jobs.items():
        lib = ctypes.CDLL(str(so))
        lib.flash_fwd.argtypes, lib.flash_fwd.restype = ref.argtypes, ref.restype
        libs[name] = lib
    return libs


def build_variants(tmp: Path) -> dict:
    """Compile the untouched source and each planted fault into ``tmp``,
    all nvcc processes at once; the loaded libraries by variant."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash as F

    text = F.SOURCE_SM90.read_text()
    for header in F.SOURCE_SM90.parent.glob("*.cuh"):  # the includes beside the source
        (tmp / header.name).write_text(header.read_text())
    jobs = {}
    planted = {**FAULTS, **{n: (old, new) for n, (old, new, _) in SPAN_FAULTS.items()}}
    for name, (old, new) in {"none": ("", ""), **planted}.items():
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
    with tempfile.TemporaryDirectory() as tmp, tempfile.TemporaryDirectory() as tmp32:
        with ThreadPoolExecutor(2) as pool:
            built = pool.submit(build_variants, Path(tmp)), pool.submit(build_fp32_variants, Path(tmp32))
            libs, libs32 = built[0].result(), built[1].result()
        b, s, h, kv, hd = SHAPE
        gen = make_generator(args.seed + 13, "cuda")
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        pristine = F._lib
        verdicts = {}

        def run(lib, q, k, v, **mask):
            """One launch of ``lib`` into an output of NaN."""
            F._lib = lib
            out = torch.full_like(q, float("nan"))
            F.flash_fwd(q, k, v, out, **mask)
            return out

        try:
            for causal in (True, False):
                want = F.flash_attention_plain(q, k, v, causal=causal)
                abs_v = C.weighted_abs_v(q, k, v, causal=causal)
                for name, lib in libs.items():
                    out = run(lib, q, k, v, causal=causal)
                    e = C.flash_error(out, want, abs_v)
                    passed = e["max_ratio"] <= 1
                    is_fault = name in FAULTS and (causal or name not in CAUSAL_ONLY)
                    verdicts[(name, f"causal={causal}")] = passed != is_fault
                    C.emit({"variant": name, "causal": causal, "shape": list(SHAPE), "passed": passed,
                            "entries": out.numel(), **e})
                    del out
                del want, abs_v
            del q, k, v
            for case, (b, sq, sk, h, kv, hd, off, window) in SPAN_CASES.items():
                q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
                k = torch.randn((b, sk, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
                v = torch.randn((b, sk, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
                mask = {"q_offset": off, "window": window}
                want = F.flash_attention_plain(q, k, v, causal=True, chunk=sk, **mask)
                abs_v = C.weighted_abs_v(q, k, v, causal=True, **mask)
                for name in ("none", *SPAN_FAULTS):
                    out = run(libs[name], q, k, v, causal=True, **mask)
                    e = C.flash_error(out, want, abs_v)
                    passed = e["max_ratio"] <= 1  # NaN fails
                    is_fault = name != "none" and case in SPAN_FAULTS[name][2]
                    verdicts[(name, case)] = passed != is_fault
                    C.emit({"variant": name, "case": case, "shape": [b, sq, sk, h, kv, hd], "q_offset": off,
                            "window": window, "passed": passed, "entries": out.numel(), **e})
                    del out
                del q, k, v, want, abs_v
            b, sq, sk, h, kv, hd, _, causal = ORDER_CASE
            q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn((b, sk, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            v = torch.randn((b, sk, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            want = F.flash_attention_plain(q, k, v, causal=causal, chunk=sk)
            abs_v = C.weighted_abs_v(q, k, v, causal=causal)
            l2 = torch.cuda.get_device_properties(q.device).L2_cache_size
            group = F.kv_group(b, sk, kv, hd, l2)
            for name in ("none", *ORDER_FAULTS):
                out = run(libs[name], q, k, v, causal=causal)
                e = C.flash_error(out, want, abs_v)
                passed = e["max_ratio"] <= 1
                verdicts[(name, "order_case")] = passed != (name != "none")
                C.emit({"variant": name, "case": "order_case", "shape": list(ORDER_CASE[:6]), "group": group,
                        "groups": -(-b * kv // group), "passed": passed, "entries": out.numel(), **e})
                del out
            del q, k, v, want, abs_v
            for case in fp32_cases(C.FLASH_CASES):
                b, sq, sk, h, kv, hd, _, causal, off, window = (*case, 0, None)[:10]
                q = torch.randn((b, sq, h, hd), generator=gen, device="cuda")
                k = torch.randn((b, sk, kv, hd), generator=gen, device="cuda")
                v = torch.randn((b, sk, kv, hd), generator=gen, device="cuda")
                mask = {"q_offset": off, "window": window}
                want = F.flash_attention_plain(q, k, v, causal=causal, chunk=sk, **mask)
                abs_v = C.weighted_abs_v(q, k, v, causal=causal, **mask)
                for name, lib in libs32.items():
                    out = run(lib, q, k, v, causal=causal, **mask)
                    e = C.flash_error(out, want, abs_v)
                    passed = e["max_ratio"] <= 1  # NaN fails
                    reaches = name != "none" and fp32_reaches(name, case)
                    verdicts[(name, json.dumps(case))] = passed != reaches
                    C.emit({"variant": name, "route": "ffma", "case": list(case), "reaches": reaches,
                            "passed": passed, "entries": out.numel(), **e})
                    del out
                del q, k, v, want, abs_v
        finally:
            F._lib = pristine
    ok = all(verdicts.values())
    C.emit({"planted_faults": len(FAULTS) + len(SPAN_FAULTS) + len(FP32_FAULTS), "as_expected": ok,
            "fp32_faults_failing_every_case_they_reach": sorted(
                n for n in FP32_FAULTS if all(good for (v, _), good in verdicts.items() if v == n)),
            "wrong": [f"{n} {c}" for (n, c), good in verdicts.items() if not good]})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
