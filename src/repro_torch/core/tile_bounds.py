"""Projection-derived tile bounds for the pruned distance scans.

Counterpart of ``repro/core/tile_bounds.py``.  For any unit direction u,
``|π_u(a) − π_u(b)| ≤ ||a − b||``, so the projections ProHD already
computes bound the D-dimensional distances.  This module turns them into
the three prune tables the fused scans consume:

  ``lb`` (gi, gj) — a certified lower bound on every d² in tile (i, j):
      the largest squared gap between the tiles' projection intervals.
  ``cut_a`` (gi,) / ``cut_b`` (gj,) — an upper bound on the final row-min
      / col-min of every valid row of the block, from exact distances to
      each query's nearest neighbours in the primary 1-D projection.

A tile is skippable iff ``lb > cut_a[i] and lb > cut_b[j]`` (:func:`skip_mask`,
the one skip rule of the port).  The tile holding each row's witness has
``lb ≤ cut``, so pruned scans return the same row and column mins as
unpruned ones.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "PruneTables",
    "order_by_projection",
    "pad_rows",
    "tile_interval_bounds",
    "witness_sqdists",
    "block_cutoffs",
    "prune_tables",
    "skip_mask",
    "skip_fraction",
]

# Large-but-finite stand-in for ±inf inside interval arithmetic (inf − inf
# would poison the gap computation with NaNs for all-invalid tiles).
_BIG = 1e30


class PruneTables(NamedTuple):
    lb: torch.Tensor     # (gi, gj) fp32 lower bound on tile d²
    cut_a: torch.Tensor  # (gi,) fp32 row-min upper bound (−inf: no valid row)
    cut_b: torch.Tensor  # (gj,) fp32 col-min upper bound (−inf: no valid row
    #                      or directed-only scan: col condition vacuous)


def order_by_projection(points, projs, valid=None):
    """Sort a cloud by its primary (column-0) projection; invalid rows last.

    Returns ``(points, projs, valid, perm)`` reordered.
    """
    p0 = projs[:, 0].float()
    if valid is not None:
        p0 = torch.where(valid, p0, _BIG)
    perm = torch.argsort(p0, stable=True)
    v = valid[perm] if valid is not None else None
    return points[perm], projs[perm], v, perm


def pad_rows(x, mult, value=0.0):
    """Pad axis 0 to a multiple of ``mult`` with ``value``."""
    pad = (-x.shape[0]) % mult
    if pad:
        fill = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
        x = torch.cat([x, fill])
    return x


def tile_interval_bounds(projs, valid, block):
    """Per-block projection intervals → (g, m) lo / hi, invalid rows ignored.

    An all-invalid block gets (lo, hi) = (+BIG, −BIG).
    """
    p = projs.float()
    if valid is not None:
        lo_in = torch.where(valid[:, None], p, _BIG)
        hi_in = torch.where(valid[:, None], p, -_BIG)
    else:
        lo_in, hi_in = p, p
    lo_in = pad_rows(lo_in, block, value=_BIG)
    hi_in = pad_rows(hi_in, block, value=-_BIG)
    g = lo_in.shape[0] // block
    m = p.shape[1]
    lo = lo_in.reshape(g, block, m).amin(dim=1)
    hi = hi_in.reshape(g, block, m).amax(dim=1)
    return lo, hi


def _interval_gap_sq(lo_a, hi_a, lo_b, hi_b):
    """(gi, gj) max-over-directions squared interval gap."""
    gap = torch.maximum(
        lo_a[:, None, :] - hi_b[None, :, :],
        lo_b[None, :, :] - hi_a[:, None, :],
    )
    gap = gap.clamp(0.0, _BIG)
    return (gap * gap).amax(dim=-1)


def witness_sqdists(q, t, proj_q, proj_t, valid_t=None, *, window: int = 8):
    """Certified per-query upper bound on ``min_t ||q − t||²``.

    Sorts the targets by their primary projection, finds each query's
    insertion point, and takes the exact squared distance to the
    2·``window`` flanking targets — real candidates, hence a true upper
    bound.  One offset at a time keeps the transient at O(n_q · D).
    """
    q32 = q.float()
    t32 = t.float()
    p_t = proj_t[:, 0].float()
    if valid_t is not None:
        p_t = torch.where(valid_t, p_t, _BIG)
        n_valid = int(valid_t.sum())
    else:
        n_valid = t.shape[0]
    order = torch.argsort(p_t, stable=True)
    t_sorted = t32[order]
    pos = torch.searchsorted(p_t[order].contiguous(), proj_q[:, 0].float().contiguous())
    hi_cap = max(n_valid - 1, 0)
    q2 = torch.sum(q32 * q32, dim=1)
    t2 = torch.sum(t_sorted * t_sorted, dim=1)
    best = torch.full((q.shape[0],), torch.inf, dtype=torch.float32, device=q.device)
    for off in range(-window, window):
        c = torch.clamp(pos + off, 0, hi_cap)
        d = q2 - 2.0 * torch.sum(q32 * t_sorted[c], dim=1) + t2[c]
        best = torch.minimum(best, d)
    # The GEMM-form distance can undershoot the true d² by fp rounding; a
    # one-ulp-scale relative margin keeps the bound certified.
    ub = torch.clamp(best, min=0.0) * (1.0 + 1e-6)
    if n_valid == 0:
        return torch.full_like(ub, torch.inf)
    return ub


def block_cutoffs(ub, valid, block):
    """(g,) max over each block's valid rows of the per-row upper bounds
    (−inf for an all-invalid block)."""
    u = ub.float()
    if valid is not None:
        u = torch.where(valid, u, -torch.inf)
    u = pad_rows(u, block, value=-torch.inf)
    return u.reshape(-1, block).amax(dim=1)


def prune_tables(
    a, proj_a, valid_a, b, proj_b, valid_b, block_a: int, block_b: int, *, directed: bool = False
) -> PruneTables:
    """Assemble (lb, cut_a, cut_b) for an (A-blocks × B-blocks) scan.

    ``directed=True``: the caller consumes only the A→B row mins, so the
    col side never vetoes a skip (``cut_b = −inf``).
    """
    lo_a, hi_a = tile_interval_bounds(proj_a, valid_a, block_a)
    lo_b, hi_b = tile_interval_bounds(proj_b, valid_b, block_b)
    lb = _interval_gap_sq(lo_a, hi_a, lo_b, hi_b)
    cut_a = block_cutoffs(witness_sqdists(a, b, proj_a, proj_b, valid_b), valid_a, block_a)
    if directed:
        cut_b = torch.full((lb.shape[1],), -torch.inf, dtype=torch.float32, device=lb.device)
    else:
        cut_b = block_cutoffs(witness_sqdists(b, a, proj_b, proj_a, valid_a), valid_b, block_b)
    return PruneTables(lb=lb.float().contiguous(), cut_a=cut_a, cut_b=cut_b)


def skip_mask(tables: PruneTables) -> torch.Tensor:
    """(gi, gj) bool — THE skip rule: the tile's lower bound clears both
    witness cutoffs."""
    return (tables.lb > tables.cut_a[:, None]) & (tables.lb > tables.cut_b[None, :])


def skip_fraction(tables: PruneTables) -> torch.Tensor:
    """Fraction of the tile grid the bounds prove skippable (scalar fp32)."""
    return skip_mask(tables).float().mean()
