"""Set-distance variants: reductions of the fused min-d² scan's outputs.

Counterpart of ``repro/core/variants.py``: partial (quantile) Hausdorff
(Huttenlocher et al. 1993) and chamfer distance reduce the same two min
vectors differently.  The front door applies the reductions to any
backend's scan; :func:`partial_hausdorff` and :func:`chamfer` bind them to
``kernels.hausdorff.ops.fused_min_sqdists`` (kernel 1 on CUDA tensors, the
plain fused scan on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.hausdorff import ops as hd_ops

__all__ = ["quantile_reduce", "mean_min_dist", "partial_hausdorff", "chamfer"]


def quantile_reduce(mins, vx, n: int, quantile: float) -> torch.Tensor:
    """K-th ranked (ascending) min-distance over valid rows, K = ⌈q·n_valid⌉.

    ``mins`` are squared distances; the result is a distance.  With no
    valid row the result is 0.0.
    """
    # q·n_valid is rounded to fp32 before the ceil, as the reference does.
    if vx is not None:
        mins = torch.where(vx, mins, -torch.inf)  # invalid rows sort first
        n_valid = int(vx.sum())
        q_n = np.float32(quantile) * np.float32(n_valid)
    else:
        n_valid = n
        q_n = np.float32(quantile * n)
    k = min(max(int(np.ceil(q_n)), 1), n)
    sorted_mins = torch.sort(mins).values
    # jnp clamps the all-invalid case's out-of-range index into the -inf
    # region; torch raises, so clamp explicitly (the result is then 0.0).
    idx = min(max(n - (n_valid - k) - 1, 0), n - 1)
    return torch.sqrt(torch.clamp(sorted_mins[idx], min=0.0))


def mean_min_dist(mins, vx) -> torch.Tensor:
    """Mean over valid rows of sqrt(min d²) — one chamfer direction."""
    d = torch.sqrt(torch.clamp(mins, min=0.0))
    if vx is not None:
        return torch.where(vx, d, 0.0).sum() / torch.clamp(vx.sum(), min=1)
    return d.mean()


def partial_hausdorff(a, b, *, quantile: float = 0.95, valid_a=None, valid_b=None) -> torch.Tensor:
    """Directed-partial HD both ways: K-th ranked min-distance, K = ⌈q·n⌉.

    quantile=1.0 recovers the standard Hausdorff distance.  Robust to
    (1-q)·n outliers per cloud.  Both directions' min vectors come out of
    one fused scan.
    """
    min_a, min_b = hd_ops.fused_min_sqdists(a, b, valid_a=valid_a, valid_b=valid_b)
    return torch.maximum(
        quantile_reduce(min_a, valid_a, a.shape[0], quantile),
        quantile_reduce(min_b, valid_b, b.shape[0], quantile),
    )


def chamfer(a, b, *, valid_a=None, valid_b=None) -> torch.Tensor:
    """Symmetric chamfer: mean_a min_b d(a,b) + mean_b min_a d(b,a), both
    directions from one fused scan."""
    min_a, min_b = hd_ops.fused_min_sqdists(a, b, valid_a=valid_a, valid_b=valid_b)
    return mean_min_dist(min_a, valid_a) + mean_min_dist(min_b, valid_b)
