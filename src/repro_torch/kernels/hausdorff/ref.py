"""Plain full-matrix oracle for the fused min-d² scan.

Self-contained (nothing from the rest of the package) so kernel tests
compare against an independent implementation.  Counterpart of
``repro/kernels/hausdorff/ref.py``; the difference form ``Σ (a−b)²`` is
used, not the GEMM form, and ``dtype=torch.float64`` gives the float64
oracle the tolerances are judged against.
"""
from __future__ import annotations

import torch

__all__ = ["directed_hausdorff_ref", "hausdorff_ref", "min_dists_ref"]


def _sqdists(a, b, dtype):
    a = a.to(dtype)
    b = b.to(dtype)
    return torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)


def directed_hausdorff_ref(a, b, valid_a=None, valid_b=None, *, dtype=torch.float32):
    """h(A,B) = max_{a valid} min_{b valid} ||a-b||, full matrix."""
    d2 = _sqdists(a, b, dtype)
    if valid_b is not None:
        d2 = torch.where(valid_b[None, :], d2, torch.inf)
    mins = torch.min(d2, dim=1).values
    if valid_a is not None:
        mins = torch.where(valid_a, mins, -torch.inf)
    return torch.sqrt(torch.max(mins))


def hausdorff_ref(a, b, valid_a=None, valid_b=None, *, dtype=torch.float32):
    return torch.maximum(
        directed_hausdorff_ref(a, b, valid_a, valid_b, dtype=dtype),
        directed_hausdorff_ref(b, a, valid_b, valid_a, dtype=dtype),
    )


def min_dists_ref(a, b, valid_b=None, *, dtype=torch.float32):
    """Per-query min squared distance (the kernel's raw output)."""
    d2 = _sqdists(a, b, dtype)
    if valid_b is not None:
        d2 = torch.where(valid_b[None, :], d2, torch.inf)
    return torch.min(d2, dim=1).values
