"""Work that the problem defines, whatever implements it, and the peaks it
is held against.

A point pair costs 2·D FLOPs (D multiply-adds of the GEMM form of d^2; the
norms are O(n·D) and not counted), the count ``chip_smoke.py`` holds kernel
1 to.  Exact: n_a·n_b pairs.  ProHD with inner='full': n_sel_a·n_b +
n_sel_b·n_a, the subset sizes from the benchmark's own selection
(``reference.pairwise.prohd``), never from the program.
"""
from __future__ import annotations

__all__ = ["FP32_PEAK", "fp32_peak", "pair_flops"]

# Published dense float32 rates outside the tensor cores (NVIDIA's data
# sheets, at the full power limit), by ``torch.cuda.get_device_name()``.
FP32_PEAK = {
    "NVIDIA H100 80GB HBM3": 67e12,   # SXM5
    "NVIDIA H100 PCIe": 51e12,
    "NVIDIA H100 NVL": 60e12,
}


def fp32_peak(kind: str) -> float | None:
    return FP32_PEAK.get(kind)


def pair_flops(method: str, d: int, n_a: int, n_b: int, n_sel_a: int | None = None,
               n_sel_b: int | None = None) -> float:
    if method == "exact":
        return 2.0 * d * n_a * n_b
    if method == "prohd":
        return 2.0 * d * (n_sel_a * n_b + n_sel_b * n_a)
    raise ValueError(f"no FLOP count for method {method!r}")
