#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each asserts; any failure exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit,
     TF32 off for cuBLAS and cuDNN;
  2. build: compile the fused min-d² scan from
     src/repro_torch/kernels/hausdorff/csrc/ into build/kernels/;
  3. kernel vs plain version on the same CUDA tensors (fp32 and bf16, masks,
     empty sides, pruning, a grid whose CTAs walk several b-tiles), per
     min-d² entry within 2·(D+2)·eps32·scale², HD within fp_value_margin
     of a float64 oracle;
  4. exact path: set_distance on the paper's Random Clouds at
     262,144 × 262,144, D = 256, against backend="tiled", and the kernel's
     min-d² vectors at that shape entry by entry against the plain version;
  5. ProHD at 1,048,576 × 1,048,576, D = 256 (Random Clouds and the
     Gaussian-mixture proxy) against ProHD on backend="tiled", and its
     certificate against phase 4's exact value at 262,144 per side (exact
     ground truth at 1M per side is cut for time);
  6. directed, partial and chamfer at 65,536 × 65,536, D = 256;
  7. CUDA-event times (median of 5 after warm-up) of the kernel, its bound,
     its plain version and torch.cdist as a yardstick, with the kernel's
     outputs held entry by entry against the plain version's at both timed
     shapes (and the masked, directed wrapper call at ProHD's sweep shape).

The kernel's launch counter is set to 0 before phase 4 and read after
phase 6: those are the main path's launches; launches made there only to
compare the kernel with its plain version are taken back out.  Prints JSON
lines; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCE = "src/repro_torch/kernels/hausdorff/csrc/fused_minscan.cu"
TPU_KERNEL = "src/repro/kernels/hausdorff/hausdorff.py:89"
# H100 SXM HBM3 rate from NVIDIA's data sheet (bytes/s).
HBM_BYTES_PER_S = 3.35e12
# FP32 lanes per SM on Hopper; one FMA = 2 FLOPs per lane per clock.
FP32_LANES_PER_SM = 128

DEVICE = "cuda"
N_EXACT = 262_144
N_PROHD = 1_048_576
N_VARIANT = 65_536
D = 256
SWEEP_QUERIES = 41_930


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def scale_of(*xs) -> float:
    """Largest row norm over the given clouds (fp32 values)."""
    import torch

    return max(float(torch.linalg.vector_norm(x.float(), dim=1).max()) for x in xs)


def oracle_min_sqdists(a, b, valid_b=None):
    """float64 per-row min d² from a to the valid rows of b, in row chunks."""
    import torch

    from repro_torch.kernels.hausdorff import ref

    per_row = max(1, b.shape[0] * b.shape[1] * 8)
    chunk = max(1, (256 << 20) // per_row)
    return torch.cat([
        ref.min_dists_ref(a[i:i + chunk], b, valid_b, dtype=torch.float64)
        for i in range(0, a.shape[0], chunk)
    ])


def finalize64(mins, valid):
    import torch

    if valid is not None:
        mins = torch.where(valid, mins, -torch.inf)
    return float(torch.sqrt(torch.clamp(mins.max(), min=0.0)))


@contextlib.contextmanager
def uncounted():
    """Leave the kernel's launch counter as it was: for comparison launches."""
    from repro_torch.kernels.hausdorff import hausdorff as K

    n = K.fused_minscan.launches
    try:
        yield
    finally:
        K.fused_minscan.launches = n


def entry_err(k, p, valid=None) -> float:
    """max |kernel − plain| over valid entries; both +inf at invalid ones."""
    import torch

    if valid is not None:
        assert torch.isinf(k[~valid]).all() and torch.isinf(p[~valid]).all()
        k, p = k[valid], p[valid]
    return float((k - p).abs().max())


def cuda_ms(fn, reps: int = 5) -> float:
    """Median ms of ``reps`` CUDA-event-timed calls after one warm-up call."""
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env():
    import torch

    card = smi("name,power.limit")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    env = {
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "card": card,
        "sms": props.multi_processor_count,
        "max_sm_mhz": max_sm_mhz,
        "fp32_peak_tflops": props.multi_processor_count * FP32_LANES_PER_SM * 2 * max_sm_mhz * 1e6 / 1e12,
    }
    emit(env)
    return env


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.hausdorff import hausdorff as K

    t0 = time.perf_counter()
    K.build()
    logs = sorted(_build.BUILD_DIR.glob("fused_minscan-*.log"))
    ptxas = [ln.strip() for ln in logs[-1].read_text().splitlines()
             if "registers" in ln or "spill" in ln] if logs else []
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})


def phase_kernel_vs_plain(seed: int) -> float:
    import torch

    from repro_torch.core import exact, projections, tile_bounds
    from repro_torch.core.fp_margin import fp_value_margin, sqdist_tolerance
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.kernels.hausdorff import hausdorff as K
    from repro_torch.kernels.hausdorff import ops

    # The last shape's grid has each CTA walk several b-tiles, as the main
    # path's launches do.
    shapes = [(8, 8, 2), (513, 129, 100), (1000, 333, 28), (64, 2000, 256), (4096, 4096, 256),
              (4096, 65_536, 256)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    walks = {f"{n_a}x{n_b}": K.grid(n_a, n_b, sms)[2] for n_a, n_b, _ in shapes}
    assert max(walks.values()) > 1, walks
    gen = make_generator(seed, DEVICE)
    max_err = 0.0
    rows = []
    for n_a, n_b, d in shapes:
        a32, b32 = random_clouds(gen, n_a, n_b, d)
        va = torch.rand(n_a, generator=gen, device=DEVICE) > 0.1
        vb = torch.rand(n_b, generator=gen, device=DEVICE) > 0.1
        va[0] = vb[0] = True
        for dtype in (torch.float32, torch.bfloat16):
            a, b = a32.to(dtype), b32.to(dtype)
            scale = scale_of(a, b)
            tol = sqdist_tolerance(d, scale)
            for masked in (False, True):
                ma, mb = (va, vb) if masked else (None, None)
                ka, kb = ops.fused_min_sqdists(a, b, valid_a=ma, valid_b=mb)
                pa, pb = exact.fused_min_sqdists_tiled(a, b, valid_a=ma, valid_b=mb)
                for k, p, v in ((ka, pa, ma), (kb, pb, mb)):
                    err = entry_err(k, p, v)
                    assert err <= tol, (n_a, n_b, d, dtype, masked, err, tol)
                    max_err = max(max_err, err)
                # HD against the float64 oracle.
                o_a = oracle_min_sqdists(a, b, mb)
                o_b = oracle_min_sqdists(b, a, ma)
                h64 = max(finalize64(o_a, ma), finalize64(o_b, mb))
                hk = float(torch.maximum(exact.finalize_mins(ka, ma), exact.finalize_mins(kb, mb)))
                margin = float(fp_value_margin(d, scale, hk))
                assert abs(hk - h64) <= margin, (n_a, n_b, d, dtype, masked, hk, h64, margin)

            # Empty sides: an empty query side gives 0.0, an empty target +inf.
            none_a = torch.zeros(n_a, dtype=torch.bool, device=DEVICE)
            none_b = torch.zeros(n_b, dtype=torch.bool, device=DEVICE)
            assert float(ops.directed_hausdorff(a, b, valid_a=none_a)) == 0.0
            assert float(ops.directed_hausdorff(a, b, valid_b=none_b)) == float("inf")
            ka, kb = ops.fused_min_sqdists(a, b, valid_a=none_a)
            assert torch.isinf(ka).all() and torch.isinf(kb).all()

            # Pruning on sorted clouds: bitwise equal to unpruned, and
            # across two prune-table block sizes.
            dirs = projections.direction_set(a, b, projections.default_num_directions(d))
            sa, pja, _, _ = tile_bounds.order_by_projection(a, projections.project(a, dirs))
            sb, pjb, _, _ = tile_bounds.order_by_projection(b, projections.project(b, dirs))
            base = ops.fused_min_sqdists(sa, sb)
            skips = {}
            for blk in (128, 512):
                pr = ops.fused_min_sqdists(sa, sb, prune_projs=(pja, pjb), block_a=blk, block_b=blk)
                assert torch.equal(pr[0], base[0]) and torch.equal(pr[1], base[1]), (n_a, n_b, d, blk)
                dr = ops.min_sqdists(sa, sb, prune_projs=(pja, pjb), block_a=blk, block_b=blk)
                assert torch.equal(dr, base[0]), (n_a, n_b, d, blk, "directed")
                tables = tile_bounds.prune_tables(
                    sa, pja, None, sb, pjb, None, ops.fit_block(blk, n_a), ops.fit_block(blk, n_b)
                )
                skips[blk] = float(tile_bounds.skip_fraction(tables))
            rows.append({"shape": [n_a, n_b, d], "dtype": str(dtype).split(".")[-1],
                         "tol": tol, "skip_fraction": skips})
    torch.cuda.synchronize()

    # Pruning that bites: low-D clouds, many tiles skipped, still bitwise.
    a, b = random_clouds(gen, 8192, 8192, 2)
    dirs = projections.direction_set(a, b, 1)
    sa, pja, _, _ = tile_bounds.order_by_projection(a, projections.project(a, dirs))
    sb, pjb, _, _ = tile_bounds.order_by_projection(b, projections.project(b, dirs))
    base = ops.fused_min_sqdists(sa, sb)
    pr = ops.fused_min_sqdists(sa, sb, prune_projs=(pja, pjb), block_a=128, block_b=128)
    assert torch.equal(pr[0], base[0]) and torch.equal(pr[1], base[1])
    tables = tile_bounds.prune_tables(sa, pja, None, sb, pjb, None, 128, 128)
    bite = float(tile_bounds.skip_fraction(tables))
    assert bite > 0.25, bite
    emit({"phase": "kernel_vs_plain", "cases": rows, "max_abs_err": max_err,
          "b_tiles_per_cta": walks, "low_d_skip_fraction": bite})
    return max_err


def phase_exact(seed: int):
    from repro_torch.core import exact
    from repro_torch.core.fp_margin import fp_value_margin, sqdist_tolerance
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import set_distance
    from repro_torch.kernels.hausdorff import hausdorff as K
    from repro_torch.kernels.hausdorff import ops

    a, b = random_clouds(make_generator(seed + 1, DEVICE), N_EXACT, N_EXACT, D)
    scale = scale_of(a, b)
    before = K.fused_minscan.launches
    res = set_distance(a, b, measure=True)
    launches = K.fused_minscan.launches - before
    assert res.meta.backend == "fused_cuda", res.meta
    assert launches > 0
    tiled = set_distance(a, b, backend="tiled", measure=True)
    h, ht = float(res.value), float(tiled.value)
    margin = float(fp_value_margin(D, scale, h))
    assert abs(h - ht) <= margin, (h, ht, margin)
    # The kernel's min-d² vectors at this shape, entry by entry.
    tol = sqdist_tolerance(D, scale)
    with uncounted():
        ka, kb = ops.fused_min_sqdists(a, b)
    pa, pb = exact.fused_min_sqdists_tiled(a, b)
    err = max(entry_err(ka, pa), entry_err(kb, pb))
    assert err <= tol, (err, tol)
    del ka, kb, pa, pb
    emit({"phase": "exact", "n": N_EXACT, "d": D, "value": h, "tiled_value": ht,
          "margin": margin, "max_abs_err": err, "tol": tol, "launches": launches,
          "elapsed_s": res.meta.elapsed_s, "tiled_elapsed_s": tiled.meta.elapsed_s})
    return a, b, h, scale, err


def phase_prohd(seed: int, a_exact, b_exact, h_exact: float, scale_exact: float):
    import torch

    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.data.pointclouds import gaussian_mixture_pca, make_generator, random_clouds
    from repro_torch.hd import HDConfig, set_distance
    from repro_torch.kernels.hausdorff import hausdorff as K

    cfg = HDConfig(alpha=0.01, inner="full")
    from repro_torch.core.projections import default_num_directions

    out = {"phase": "prohd", "n": N_PROHD, "d": D, "alpha": 0.01,
           "m": default_num_directions(D), "inner": "full",
           "exact_at_full_size": "not run (cut for time)", "runs": []}
    for name, make in (("random_clouds", random_clouds), ("gaussian_mixture", gaussian_mixture_pca)):
        a, b = make(make_generator(seed + 2, DEVICE), N_PROHD, N_PROHD, D)
        scale = scale_of(a, b)
        before = K.fused_minscan.launches
        res = set_distance(a, b, method="prohd", config=cfg, measure=True)
        launches = K.fused_minscan.launches - before
        assert res.meta.backend == "fused_cuda", res.meta
        assert launches > 0
        v, up = float(res.value), float(res.upper)
        margin = float(fp_value_margin(D, scale, v))
        assert v <= up + margin, (name, v, up)
        # The same selection on the plain scan: the sweeps agree.
        tiled = set_distance(a, b, method="prohd", config=cfg, backend="tiled", measure=True)
        vt = float(tiled.value)
        assert abs(v - vt) <= margin, (name, v, vt, margin)
        assert abs(float(res.lower) - float(tiled.lower)) <= margin, (name, res.lower, tiled.lower)
        assert abs(up - float(tiled.upper)) <= margin, (name, up, tiled.upper)
        out["runs"].append({"data": name, "value": v, "tiled_value": vt, "margin": margin,
                            "lower": float(res.lower), "upper": up,
                            "n_sel_a": int(res.stats["n_sel_a"]), "n_sel_b": int(res.stats["n_sel_b"]),
                            "launches": launches, "elapsed_s": res.meta.elapsed_s,
                            "tiled_elapsed_s": tiled.meta.elapsed_s})
        del a, b
        torch.cuda.empty_cache()

    # Certificate against the exact value of phase 4.
    res = set_distance(a_exact, b_exact, method="prohd", config=cfg, measure=True)
    assert res.meta.backend == "fused_cuda"
    v, lo, up = float(res.value), float(res.lower), float(res.upper)
    m = float(fp_value_margin(D, scale_exact, h_exact))
    assert v <= h_exact + m and lo <= h_exact + m and h_exact <= up + m, (v, lo, up, h_exact, m)
    vt = float(set_distance(a_exact, b_exact, method="prohd", config=cfg, backend="tiled").value)
    assert abs(v - vt) <= m, (v, vt, m)
    out["certificate"] = {"n": N_EXACT, "exact": h_exact, "value": v, "tiled_value": vt,
                          "lower": lo, "upper": up, "margin": m, "rel_err": (h_exact - v) / h_exact,
                          "elapsed_s": res.meta.elapsed_s}
    emit(out)


def phase_variants(seed: int):
    from repro_torch.core.fp_margin import fp_value_margin
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.hd import HDConfig, set_distance

    a, b = random_clouds(make_generator(seed + 3, DEVICE), N_VARIANT, N_VARIANT, D)
    scale = scale_of(a, b)
    cfg = HDConfig(quantile=0.95)
    rows = []
    for variant in ("directed", "partial", "chamfer"):
        res = set_distance(a, b, variant=variant, config=cfg, measure=True)
        ref = set_distance(a, b, variant=variant, config=cfg, backend="tiled")
        assert res.meta.backend == "fused_cuda", res.meta
        v, r = float(res.value), float(ref.value)
        # chamfer sums two means of distances: twice one distance's margin.
        margin = float(fp_value_margin(D, scale, v)) * (2 if variant == "chamfer" else 1)
        assert abs(v - r) <= margin, (variant, v, r, margin)
        rows.append({"variant": variant, "value": v, "tiled_value": r, "margin": margin,
                     "elapsed_s": res.meta.elapsed_s})
    emit({"phase": "variants", "n": N_VARIANT, "d": D, "runs": rows})


def phase_times(seed: int, env: dict) -> list[dict]:
    import torch

    from repro_torch.core import exact
    from repro_torch.core.fp_margin import sqdist_tolerance
    from repro_torch.data.pointclouds import make_generator, random_clouds
    from repro_torch.kernels.hausdorff import hausdorff as K
    from repro_torch.kernels.hausdorff import ops

    peak = env["fp32_peak_tflops"] * 1e12
    gen = make_generator(seed + 4, DEVICE)
    shapes = [("exact/variants", N_VARIANT, N_VARIANT), ("prohd_sweep", SWEEP_QUERIES, N_PROHD)]
    rows = []
    for label, n_a, n_b in shapes:
        a, b = random_clouds(gen, n_a, n_b, D)
        a2 = (a * a).sum(1)
        b2 = (b * b).sum(1)
        min_a = torch.empty(n_a, device=DEVICE)
        min_b = torch.empty(n_b, device=DEVICE)

        def kernel():
            min_a.fill_(torch.inf)
            min_b.fill_(torch.inf)
            K.fused_minscan(a, b, a2, b2, min_a, min_b)

        ms = cuda_ms(kernel)
        plain = {}

        def plain_scan():
            plain["mins"] = exact.fused_min_sqdists_tiled(a, b)

        plain_ms = cuda_ms(plain_scan)
        # The timed kernel's outputs, entry by entry.
        tol = sqdist_tolerance(D, scale_of(a, b))
        err = max(entry_err(min_a, plain["mins"][0]), entry_err(min_b, plain["mins"][1]))
        assert err <= tol, (label, err, tol)
        del plain["mins"]
        if label == "prohd_sweep":
            # ProHD's sweep as the main path makes it: the selected rows
            # padded to a static capacity (masked), directed, through ops.
            va = torch.rand(n_a, generator=gen, device=DEVICE) < 0.95
            km = ops.min_sqdists(a, b, valid_a=va)
            pm, _ = exact.fused_min_sqdists_tiled(a, b, valid_a=va)
            err = max(err, entry_err(km, pm, va))
            assert err <= tol, (label, "masked directed", err, tol)
            del km, pm
        library_ms = None
        if label == "exact/variants":
            library_ms = cuda_ms(lambda: torch.cdist(a, b))
            torch.cuda.empty_cache()
        flops = 2.0 * n_a * n_b * D
        nbytes = 4.0 * ((n_a + n_b) * D + 2 * (n_a + n_b))
        op_ms = flops / peak * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": [n_a, n_b, D], "label": label, "ms": ms, "plain_ms": plain_ms,
                     "max_abs_err": err, "tol": tol,
                     "library_ms": library_ms, "bound_ms": max(op_ms, byte_ms),
                     "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                     "achieved_tflops": flops / (ms * 1e-3) / 1e12})
        del a, b, a2, b2, min_a, min_b
        torch.cuda.empty_cache()
    emit({"phase": "times", "rows": rows})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels.hausdorff import hausdorff as K

    env = phase_env()
    phase_build()
    max_err = phase_kernel_vs_plain(args.seed)

    K.fused_minscan.launches = 0
    t0 = time.perf_counter()
    a, b, h, scale, exact_err = phase_exact(args.seed)
    launches_exact = K.fused_minscan.launches
    phase_prohd(args.seed, a, b, h, scale)
    launches_prohd = K.fused_minscan.launches - launches_exact
    del a, b
    torch.cuda.empty_cache()
    phase_variants(args.seed)
    launches = K.fused_minscan.launches
    assert launches_exact > 0 and launches_prohd > 0, (launches_exact, launches_prohd)
    emit({"phase": "main_path", "launches": launches, "exact_launches": launches_exact,
          "prohd_launches": launches_prohd, "wall_s": time.perf_counter() - t0})

    rows = phase_times(args.seed, env)
    main_row = rows[0]
    emit({"kernels": [{
        "name": "fused_minscan",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "tpu_kernel": "hausdorff.py:_fused_kernel",
        "launches": launches,
        "max_abs_err": max([max_err, exact_err] + [r["max_abs_err"] for r in rows]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "shapes": rows,
    }]})
    print(smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
