"""Direction finding for ProHD: centroid axis + top principal components.

Counterpart of ``repro/core/projections.py`` (paper Alg. 1/2), with its
three PCA backends:

- ``gram``: accumulate the D×D covariance with one fp32 matmul and
  ``eigh`` it (deterministic);
- ``rsvd``: the randomised range finder (Halko et al.), O(n·D·m), the
  paper-faithful backend;
- ``subspace``: blocked subspace iteration on the implicit covariance,
  never forming D×D.

The randomised backends draw their start (a Gaussian (D, cols) matrix,
:func:`random_start`) from a ``torch.Generator`` on the data's device;
the iterations take the start as an argument, so a test can run them on
the reference's start.  ``eigh``, ``qr`` and ``svd`` return bases only up
to sign; selection keeps both the k smallest and k largest projections,
and the bound and the projected estimator are sign-invariant, so no sign
is fixed here.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.device import check_generator, strict_fp32

PCAMethod = Literal["gram", "rsvd", "subspace"]

__all__ = [
    "centroid_direction",
    "default_num_directions",
    "pca_directions",
    "project",
    "random_start",
    "rsvd_cols",
    "direction_set",
]

# The reference's defaults (``_pca_rsvd``, ``_pca_subspace``).
RSVD_OVERSAMPLE = 8
RSVD_POWER_ITERS = 2
SUBSPACE_ITERS = 8


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


def random_start(generator: torch.Generator, d: int, cols: int, device) -> torch.Tensor:
    """The randomised backends' start: a standard Gaussian (d, cols) fp32
    draw on ``device`` (rsvd: cols = min(d, m + oversample); subspace: m)."""
    check_generator(generator, device, "randomised PCA")
    return torch.randn((d, cols), generator=generator, device=generator.device)


def rsvd_cols(d: int, m: int) -> int:
    """Columns of rsvd's start: min(d, m + oversample)."""
    return min(d, m + RSVD_OVERSAMPLE)


def _pca_rsvd(z, mean, m: int, *, omega: torch.Tensor):
    """Randomised range-finder SVD (Halko/Martinsson/Tropp) from the start
    ``omega`` (D, ell): a range basis of zc·omega, refined by power
    iterations, then the top right singular vectors of its projection."""
    strict_fp32()
    zc = z.float() - mean
    q, _ = torch.linalg.qr(zc @ omega)  # (n, ell)
    for _ in range(RSVD_POWER_ITERS):
        q, _ = torch.linalg.qr(zc.T @ q)  # (d, ell)
        q, _ = torch.linalg.qr(zc @ q)  # (n, ell)
    _, _, vt = torch.linalg.svd(q.T @ zc, full_matrices=False)  # (ell, d)
    return vt[:m].T


def _pca_subspace(z, mean, m: int, *, start: torch.Tensor):
    """Blocked subspace iteration on the implicit covariance from the
    Gaussian ``start`` (D, m): each step is two tall-skinny matmuls."""
    strict_fp32()
    zc = z.float() - mean
    q, _ = torch.linalg.qr(start)
    for _ in range(SUBSPACE_ITERS):
        q, _ = torch.linalg.qr(zc.T @ (zc @ q))
    return q


def pca_directions(
    z: torch.Tensor,
    m: int,
    *,
    method: PCAMethod = "gram",
    generator: torch.Generator | None = None,
    mean: torch.Tensor | None = None,
) -> torch.Tensor:
    """Top-m principal directions of ``z`` (n, D) → orthonormal (D, m).

    ``generator`` (on ``z``'s device) is required by the randomised
    backends."""
    if mean is None:
        mean = z.float().mean(dim=0)
    if method == "gram":
        return _pca_gram(z, mean, m)
    if generator is None:
        raise ValueError(f"PCA method {method!r} requires a generator")
    d = z.shape[1]
    if method == "rsvd":
        return _pca_rsvd(z, mean, m, omega=random_start(generator, d, rsvd_cols(d, m), z.device))
    if method == "subspace":
        return _pca_subspace(z, mean, m, start=random_start(generator, d, m, z.device))
    raise ValueError(f"unknown PCA method: {method!r}")


def direction_set(a: torch.Tensor, b: torch.Tensor, m: int, *, method: PCAMethod = "gram",
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Centroid direction + top-m PCA directions, stacked as (D, m+1)."""
    u0 = centroid_direction(a, b)
    us = pca_directions(torch.cat([a, b]), m, method=method, generator=generator)
    return torch.cat([u0[:, None], us], dim=1)
