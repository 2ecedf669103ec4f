"""α-extreme selection (Alg. 1 lines 9-12 / Alg. 2 lines 12-15).

Counterpart of ``repro/core/selection.py``.  ``torch.topk`` on the
projection and its negation keeps the k smallest and k largest entries;
it breaks ties differently from ``lax.top_k``, which changes at most which
of several equal projections is kept, never the selected values.  Sets
are boolean membership masks; :func:`take_selected` packs them into a
buffer of static capacity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import projections as P

__all__ = [
    "alpha_count",
    "extreme_mask",
    "extreme_mask_multi",
    "SelectionResult",
    "select_extremes",
    "selection_capacity",
    "take_selected",
]


def alpha_count(n: int, alpha: float) -> int:
    """k = max(1, floor(alpha * n)) — Alg. 1 line 9."""
    return max(1, int(alpha * n))


def extreme_mask_multi(projs: torch.Tensor, k: int) -> torch.Tensor:
    """(n,) bool: the k smallest and k largest rows of each column of
    ``projs`` (n, m), OR-ed over the columns."""
    n, m = projs.shape
    k = min(k, n)
    rows = projs.T  # (m, n): one topk along the row axis per direction
    top = torch.topk(rows, k, dim=1).indices
    bot = torch.topk(-rows, k, dim=1).indices
    masks = torch.zeros((m, n), dtype=torch.bool, device=projs.device)
    masks.scatter_(1, top, True)
    masks.scatter_(1, bot, True)
    return masks.any(dim=0)


def extreme_mask(proj: torch.Tensor, k: int) -> torch.Tensor:
    """(n,) bool mask of the k smallest and k largest entries of ``proj``."""
    return extreme_mask_multi(proj[:, None], k)


class SelectionResult(NamedTuple):
    mask_a: torch.Tensor  # (n_a,) bool
    mask_b: torch.Tensor  # (n_b,) bool
    proj_a: torch.Tensor  # (n_a, m+1) fp32 projections (centroid col 0)
    proj_b: torch.Tensor  # (n_b, m+1)


def select_extremes(a, b, directions, *, alpha: float, alpha_pca: float | None = None) -> SelectionResult:
    """Alg. 3 lines 2-4: centroid extremes at fraction α, PCA extremes at α'
    (default α/m).  ``directions`` is (D, m+1), column 0 the centroid."""
    n_a, n_b = a.shape[0], b.shape[0]
    m = directions.shape[1] - 1
    if alpha_pca is None:
        alpha_pca = alpha / max(1, m)
    proj_a = P.project(a, directions)
    proj_b = P.project(b, directions)
    mask_a = extreme_mask(proj_a[:, 0], alpha_count(n_a, alpha))
    mask_b = extreme_mask(proj_b[:, 0], alpha_count(n_b, alpha))
    if m > 0:
        mask_a = mask_a | extreme_mask_multi(proj_a[:, 1:], alpha_count(n_a, alpha_pca))
        mask_b = mask_b | extreme_mask_multi(proj_b[:, 1:], alpha_count(n_b, alpha_pca))
    return SelectionResult(mask_a, mask_b, proj_a, proj_b)


def selection_capacity(n: int, m: int, alpha: float, alpha_pca: float | None = None) -> int:
    """Static upper bound on |I| for one cloud: 2k_centroid + m·2k_pca."""
    if alpha_pca is None:
        alpha_pca = alpha / max(1, m)
    cap = 2 * alpha_count(n, alpha) + m * 2 * alpha_count(n, alpha_pca)
    return min(n, cap)


def take_selected(points: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Gather masked rows into a (capacity, ...) buffer + validity mask.

    Selected rows are packed to the front in their original order; the
    tail repeats the first selected row (a real point, masked out by the
    returned validity).  The capacity is static: no host round trip.
    """
    n = points.shape[0]
    capacity = min(capacity, n)
    m8 = mask.to(torch.int8)
    order = torch.argsort(1 - m8, stable=True)[:capacity]
    valid = mask[order]
    # argmax over a bool mask is not implemented on CUDA: cast first.
    first = torch.argmax(m8)
    safe = torch.where(valid, order, first)
    return points[safe], valid
