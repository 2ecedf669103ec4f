"""Plain references for the pairwise cells: the exact Hausdorff distance,
and ProHD (the paper's Alg. 3 with inner='full' and its sec. II-E interval).

The selection follows the paper (centroid axis, the top floor(sqrt(D))
principal directions of A u B from the Gram matrix, the k smallest and
largest projections on each); the distances to the selected rows, the
projected estimator and the bound follow it; all of it in one precision:
float64 for the reference, float32 with TF32 products for the control.
Distances are the GEMM form of d^2 over row blocks.

The principal directions past the first lie in a near-degenerate spectrum
on uniform clouds (isotropic but for the offset), so two correct programs
that round differently pick a few different rows, and with them another
``upper``.  What a check may hold a program to is therefore what does not
depend on those directions: the value (the farthest selected row lies
close to the farthest row of any such selection), the paper's guarantee
lower <= H <= upper, and the selection's size between its floor and its
capacity.  ``hausdorff_above`` is a certain upper end of H for the
guarantee, without the cost of H itself.
"""
from __future__ import annotations

import math

import torch

from bench.reference.precision import dtype_of, mm

__all__ = ["min_sqdists", "hausdorff", "hausdorff_above", "prohd", "alpha_count", "selection_floor",
           "selection_capacity"]

BLOCK_BYTES = 1 << 31  # one block of d^2


def min_sqdists(a: torch.Tensor, b: torch.Tensor, precision: str, *, cols: bool = True):
    """(min_j |a_i - b_j|^2 over i, min_i |a_i - b_j|^2 over j or None)."""
    dt = dtype_of(precision)
    a, b = a.to(dt), b.to(dt)
    b2 = (b * b).sum(1)
    rows = max(1, BLOCK_BYTES // (b.shape[0] * a.element_size()))
    row_min = torch.empty(a.shape[0], dtype=dt, device=a.device)
    col_min = torch.full((b.shape[0],), math.inf, dtype=dt, device=a.device) if cols else None
    bt = b.T
    for i in range(0, a.shape[0], rows):
        x = a[i:i + rows]
        d2 = mm(x, bt, precision)
        d2.mul_(-2.0).add_(b2[None, :]).add_((x * x).sum(1)[:, None]).clamp_(min=0.0)
        row_min[i:i + rows] = d2.amin(1)
        if cols:
            torch.minimum(col_min, d2.amin(0), out=col_min)
        del d2
    return row_min, col_min


def hausdorff(a: torch.Tensor, b: torch.Tensor, precision: str = "float64") -> float:
    """H(A, B)."""
    ra, cb = min_sqdists(a, b, precision)
    return math.sqrt(max(float(ra.max()), float(cb.max())))


def hausdorff_above(a: torch.Tensor, b: torch.Tensor, rows: int, precision: str = "float64") -> float:
    """An upper end of H(A, B): every row's distance to the first ``rows``
    rows of the other cloud, which is at least its distance to the whole
    cloud; the larger of the two directions' largest."""
    ra, _ = min_sqdists(a, b[:rows], precision, cols=False)
    rb, _ = min_sqdists(b, a[:rows], precision, cols=False)
    return math.sqrt(max(float(ra.max()), float(rb.max())))


def alpha_count(n: int, alpha: float) -> int:
    """k = max(1, floor(alpha * n)) (Alg. 1 line 9)."""
    return max(1, int(alpha * n))


def selection_floor(n: int, alpha: float) -> int:
    """The fewest rows one cloud can select: the centroid axis's k smallest
    and k largest, which are distinct rows."""
    return min(n, 2 * alpha_count(n, alpha))


def selection_capacity(n: int, m: int, alpha: float) -> int:
    """The most rows one cloud can select: 2 k_centroid + m 2 k_pca."""
    return min(n, 2 * alpha_count(n, alpha) + m * 2 * alpha_count(n, alpha / max(1, m)))


def _extremes(proj: torch.Tensor, k: int) -> torch.Tensor:
    """(n,) bool: the k smallest and k largest rows of each column of
    ``proj`` (n, m), OR-ed over the columns; one ``topk`` over the (m, n)
    rows each way, as the program breaks ties among equal projections."""
    n, m = proj.shape
    k = min(k, n)
    rows = proj.T
    masks = torch.zeros((m, n), dtype=torch.bool, device=proj.device)
    masks.scatter_(1, torch.topk(rows, k, dim=1).indices, True)
    masks.scatter_(1, torch.topk(-rows, k, dim=1).indices, True)
    return masks.any(dim=0)


def _directed_1d(pa: torch.Tensor, pb_sorted: torch.Tensor) -> torch.Tensor:
    pos = torch.searchsorted(pb_sorted, pa)
    n = pb_sorted.shape[-1]
    left = torch.gather(pb_sorted, -1, (pos - 1).clamp(0, n - 1))
    right = torch.gather(pb_sorted, -1, pos.clamp(0, n - 1))
    return torch.minimum((pa - left).abs(), (pa - right).abs()).amax(-1)


def _hd_1d(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Undirected 1-D Hausdorff distance along the last axis."""
    sa, sb = pa.sort(-1).values.contiguous(), pb.sort(-1).values.contiguous()
    return torch.maximum(_directed_1d(sa, sb), _directed_1d(sb, sa))


def _selection(a: torch.Tensor, b: torch.Tensor, alpha: float, precision: str):
    """Alg. 3 lines 1-4 in ``precision``: (directions (D, m+1), masks)."""
    dt = dtype_of(precision)
    A, B = a.to(dt), b.to(dt)
    n_a, d = A.shape
    n_b = B.shape[0]
    m = max(1, int(d ** 0.5))
    u0 = B.mean(0) - A.mean(0)
    norm = torch.linalg.vector_norm(u0)
    if float(norm) < 1e-9:
        u0 = torch.zeros_like(u0)
        u0[0] = 1.0
    else:
        u0 = u0 / norm
    z = torch.cat([A, B])
    zc = z - z.mean(0)
    del z
    gram = mm(zc.T, zc, precision)
    del zc
    _, vecs = torch.linalg.eigh(gram)
    dirs = torch.cat([u0[:, None], vecs.flip(1)[:, :m]], dim=1)
    pa, pb = mm(A, dirs, precision), mm(B, dirs, precision)
    k_pca = alpha / m
    sel_a = _extremes(pa[:, :1], alpha_count(n_a, alpha)) | _extremes(pa[:, 1:], alpha_count(n_a, k_pca))
    sel_b = _extremes(pb[:, :1], alpha_count(n_b, alpha)) | _extremes(pb[:, 1:], alpha_count(n_b, k_pca))
    return dirs, sel_a, sel_b


def prohd(a: torch.Tensor, b: torch.Tensor, alpha: float, precision: str = "float64") -> dict:
    """ProHD of (A, B) in ``precision``: {value, lower, upper, n_sel_a,
    n_sel_b}."""
    dirs, sel_a, sel_b = _selection(a, b, alpha, precision)
    dt = dtype_of(precision)
    A, B = a.to(dt), b.to(dt)
    ra, _ = min_sqdists(A[sel_a], B, precision, cols=False)
    rb, _ = min_sqdists(B[sel_b], A, precision, cols=False)
    value = math.sqrt(max(float(ra.max()), float(rb.max())))
    pa, pb = mm(A, dirs, precision), mm(B, dirs, precision)
    lower = float(_hd_1d(pa.T, pb.T).max())
    delta_a = ((A * A).sum(1, keepdim=True) - pa * pa).clamp(min=0.0).amax(0).sqrt()
    delta_b = ((B * B).sum(1, keepdim=True) - pb * pb).clamp(min=0.0).amax(0).sqrt()
    bound = 2.0 * float(torch.maximum(delta_a, delta_b).min())
    return {"value": value, "lower": lower, "upper": lower + bound,
            "n_sel_a": int(sel_a.sum()), "n_sel_b": int(sel_b.sum())}
