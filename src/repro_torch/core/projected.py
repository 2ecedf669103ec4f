"""Projected (1-D) Hausdorff distances — the estimator §II-E bounds.

Counterpart of ``repro/core/projected.py``: ``Ĥ = max_u H_u(A,B)``, with
``H_proj ≤ H ≤ H_proj + 2·min_u δ(u)``.  All directions at once: one
batched sort of each cloud's (m, n) projections and one batched
``searchsorted``, O((n_a + n_b) log n) per direction.
"""
from __future__ import annotations

import torch

__all__ = ["directed_hd_1d", "hd_1d", "projected_hd"]


def _directed_sorted(pa: torch.Tensor, pb_sorted: torch.Tensor) -> torch.Tensor:
    """max over the last axis of min |pa − pb| (rows of pb_sorted ascending)."""
    n_b = pb_sorted.shape[-1]
    pos = torch.searchsorted(pb_sorted.contiguous(), pa.contiguous())
    left = torch.gather(pb_sorted, -1, torch.clamp(pos - 1, 0, n_b - 1))
    right = torch.gather(pb_sorted, -1, torch.clamp(pos, 0, n_b - 1))
    nearest = torch.minimum((pa - left).abs(), (pa - right).abs())
    return nearest.amax(dim=-1)


def directed_hd_1d(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """max_i min_j |pa_i − pb_j| along the last axis (pb need not be sorted)."""
    return _directed_sorted(pa, torch.sort(pb, dim=-1).values)


def hd_1d(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Undirected 1-D Hausdorff along the last axis (batched over leading axes)."""
    pa_s = torch.sort(pa, dim=-1).values
    pb_s = torch.sort(pb, dim=-1).values
    return torch.maximum(_directed_sorted(pa_s, pb_s), _directed_sorted(pb_s, pa_s))


def projected_hd(proj_a: torch.Tensor, proj_b: torch.Tensor) -> torch.Tensor:
    """Ĥ = max_u H_u(A,B) over the direction columns of (n, m) projections."""
    return hd_1d(proj_a.T.float(), proj_b.T.float()).max()
