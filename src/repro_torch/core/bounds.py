"""Theoretical error bounds from §II-E (counterpart of ``repro/core/bounds.py``).

``delta(u) = max_p || p − (pᵀu) u ||`` and, for unit u,
``||p − (pᵀu)u||² = ||p||² − (pᵀu)²`` — so delta needs only the
projections and one row-norm pass.  The paper guarantees
``Ĥ ≤ H ≤ Ĥ + 2·min_u delta(u)``.
"""
from __future__ import annotations

import torch

__all__ = ["delta_per_direction", "additive_bound"]


def delta_per_direction(points: torch.Tensor, projs: torch.Tensor) -> torch.Tensor:
    """(m,) fp32: max_p sqrt(||p||² − proj²) per direction."""
    p32 = points.float()
    sq_norms = torch.sum(p32 * p32, dim=1, keepdim=True)
    orth_sq = torch.clamp(sq_norms - projs.float() ** 2, min=0.0)
    return torch.sqrt(orth_sq.amax(dim=0))


def additive_bound(points_a, points_b, proj_a, proj_b) -> torch.Tensor:
    """2 · min_u delta(u) over A ∪ B."""
    delta = torch.maximum(
        delta_per_direction(points_a, proj_a), delta_per_direction(points_b, proj_b)
    )
    return 2.0 * delta.min()
