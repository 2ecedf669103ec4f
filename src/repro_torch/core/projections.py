"""Direction finding for ProHD: centroid axis + top principal components.

Counterpart of ``repro/core/projections.py`` (paper Alg. 1/2).  The
``gram`` PCA backend is ported: accumulate the D×D covariance with one
fp32 matmul and ``eigh`` it.  ``eigh`` returns eigenvectors only up to
sign; selection keeps both the k smallest and k largest projections, and
the bound and the projected estimator are sign-invariant, so no sign is
fixed here.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.device import strict_fp32

PCAMethod = Literal["gram", "rsvd", "subspace"]

__all__ = [
    "centroid_direction",
    "default_num_directions",
    "pca_directions",
    "project",
    "direction_set",
]


def default_num_directions(d: int) -> int:
    """The paper's ``m = floor(sqrt(D))`` (at least 1)."""
    return max(1, int(d**0.5))


def centroid_direction(x: torch.Tensor, y: torch.Tensor, *, eps: float = 1e-9) -> torch.Tensor:
    """Unit vector from centroid(x) to centroid(y); e_1 when they coincide."""
    u = y.float().mean(dim=0) - x.float().mean(dim=0)
    norm = torch.linalg.vector_norm(u)
    e1 = torch.zeros_like(u)
    e1[0] = 1.0
    return torch.where(norm < eps, e1, u / torch.clamp(norm, min=eps))


def project(points: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Project (n, D) points onto (D, m) directions → (n, m) fp32."""
    strict_fp32()
    if directions.ndim == 1:
        directions = directions[:, None]
    return points.float() @ directions.float()


def _pca_gram(z: torch.Tensor, mean: torch.Tensor, m: int) -> torch.Tensor:
    strict_fp32()
    zc = z.float() - mean
    gram = zc.T @ zc
    _, v = torch.linalg.eigh(gram)  # ascending eigenvalues
    return v.flip(1)[:, :m]


def pca_directions(
    z: torch.Tensor,
    m: int,
    *,
    method: PCAMethod = "gram",
    mean: torch.Tensor | None = None,
) -> torch.Tensor:
    """Top-m principal directions of ``z`` (n, D) → orthonormal (D, m)."""
    if method != "gram":
        raise NotImplementedError(f"PCA method {method!r} is not ported yet; use 'gram'")
    if mean is None:
        mean = z.float().mean(dim=0)
    return _pca_gram(z, mean, m)


def direction_set(a: torch.Tensor, b: torch.Tensor, m: int, *, method: PCAMethod = "gram") -> torch.Tensor:
    """Centroid direction + top-m PCA directions, stacked as (D, m+1)."""
    u0 = centroid_direction(a, b)
    us = pca_directions(torch.cat([a, b]), m, method=method)
    return torch.cat([u0[:, None], us], dim=1)
