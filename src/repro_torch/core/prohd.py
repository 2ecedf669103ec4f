"""ProHD main procedure (paper Alg. 3) in PyTorch.

Counterpart of ``repro/core/prohd.py``::

    cfg = ProHDConfig(alpha=0.01, subset_backend="cuda")
    est = prohd(a, b, cfg)          # ProHDEstimate

Data-dependent subset sizes are padded to static capacities derived from
(n, D, alpha).  The subset HD backend is ``"tiled"`` (the plain PyTorch
scan, any device), ``"dense"`` (one distance matrix) or ``"cuda"`` (the
hand-written fused scan kernel; the plain version on CPU tensors).

``inner="full"`` (default) searches from the selected subsets against the
full other cloud — a certified underestimate of H; ``inner="subset"`` is
Alg. 3 as typeset (subset against subset), which can overestimate.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple

import torch

from repro_torch.core import bounds, exact, projected, projections, selection, tile_bounds
from repro_torch.kernels.hausdorff import ops as hd_ops
from repro_torch.obs import trace as _obs

__all__ = ["ProHDConfig", "ProHDEstimate", "prohd", "prohd_masks"]

SubsetBackend = Literal["tiled", "dense", "cuda"]


@dataclasses.dataclass(frozen=True)
class ProHDConfig:
    """Runtime knobs; defaults are the paper's choices."""

    alpha: float = 0.01
    num_pca_directions: int | None = None   # None → floor(sqrt(D))
    alpha_pca: float | None = None          # None → alpha / m
    pca_method: projections.PCAMethod = "gram"
    subset_backend: SubsetBackend = "tiled"
    subset_block: int = 2048
    inner: Literal["full", "subset"] = "full"
    # Reorder each cloud along the primary projection and gate the scans
    # with projection prune tables; exactness is unaffected.
    prune: bool = False
    compute_bound: bool = True
    compute_projected: bool = True

    def resolve_m(self, d: int) -> int:
        if self.num_pca_directions is not None:
            return self.num_pca_directions
        return projections.default_num_directions(d)


class ProHDEstimate(NamedTuple):
    """What Alg. 3 returns, plus the §II-E certificate:
    ``hd_proj ≤ H(A,B) ≤ hd_proj + bound``."""

    hd: torch.Tensor        # subset estimator, scalar fp32
    n_sel_a: torch.Tensor   # |I^A| (int32)
    n_sel_b: torch.Tensor   # |I^B|
    bound: torch.Tensor     # 2·min_u δ(u); 0 if compute_bound=False
    hd_proj: torch.Tensor   # certified lower bound; 0 if compute_projected=False


def _directed(a, b, va, vb, cfg: ProHDConfig, prune_projs=None) -> torch.Tensor:
    """One directed sweep h(a → b) on the configured backend."""
    if cfg.subset_backend == "dense":
        return exact.directed_hd_dense(a, b, valid_a=va, valid_b=vb)
    if cfg.subset_backend == "cuda":
        return hd_ops.directed_hausdorff(a, b, valid_a=va, valid_b=vb, prune_projs=prune_projs)
    return exact.directed_hd_tiled(
        a, b, valid_a=va, valid_b=vb, block=cfg.subset_block, prune_projs=prune_projs
    )


def _queries_vs_full_hd(a_sel, va, b_sel, vb, a_full, b_full, cfg, projs=None) -> torch.Tensor:
    """max(h(A_sel → B_full), h(B_sel → A_full)) — certified ≤ H(A,B)."""
    pab = pba = None
    if projs is not None:
        proj_a_sel, proj_b_sel, proj_a_full, proj_b_full = projs
        pab = (proj_a_sel, proj_b_full)
        pba = (proj_b_sel, proj_a_full)
    return torch.maximum(
        _directed(a_sel, b_full, va, None, cfg, prune_projs=pab),
        _directed(b_sel, a_full, vb, None, cfg, prune_projs=pba),
    )


def _subset_hd(a_sel, va, b_sel, vb, cfg: ProHDConfig, prune_projs=None) -> torch.Tensor:
    """Undirected H(A_sel, B_sel) in one fused pass."""
    if cfg.subset_backend == "dense":
        return exact.hausdorff_dense(a_sel, b_sel, valid_a=va, valid_b=vb)
    if cfg.subset_backend == "cuda":
        return hd_ops.hausdorff(a_sel, b_sel, valid_a=va, valid_b=vb, prune_projs=prune_projs)
    return exact.hausdorff_fused_tiled(
        a_sel, b_sel, valid_a=va, valid_b=vb,
        block_a=cfg.subset_block, block_b=cfg.subset_block, prune_projs=prune_projs,
    )


def prohd_masks(a, b, cfg: ProHDConfig, *, generator: torch.Generator | None = None
                ) -> selection.SelectionResult:
    """Selection step only (Alg. 3 lines 1-4): masks + projections."""
    m = cfg.resolve_m(a.shape[1])
    dirs = projections.direction_set(a, b, m, method=cfg.pca_method, generator=generator)
    return selection.select_extremes(a, b, dirs, alpha=cfg.alpha, alpha_pca=cfg.alpha_pca)


def prohd(a: torch.Tensor, b: torch.Tensor, cfg: ProHDConfig = ProHDConfig(), *,
          generator: torch.Generator | None = None) -> ProHDEstimate:
    """Full ProHD (Alg. 3): select extremes, exact HD on the selected subsets.

    a: (n_a, D), b: (n_b, D) on one device.  With ``inner="full"``, ``hd``
    never overestimates H(A,B); ``hd_proj + bound`` never underestimates it.
    ``generator`` (on the clouds' device) drives the randomised PCA
    backends (``pca_method="rsvd"`` or ``"subspace"``), which require it.
    """
    n_a, d = a.shape
    n_b = b.shape[0]
    m = cfg.resolve_m(d)
    cap_a = selection.selection_capacity(n_a, m, cfg.alpha, cfg.alpha_pca)
    cap_b = selection.selection_capacity(n_b, m, cfg.alpha, cfg.alpha_pca)
    with _obs.span("hd.prohd.directions", device=a.device, m=m, pca_method=cfg.pca_method):
        dirs = projections.direction_set(a, b, m, method=cfg.pca_method, generator=generator)
    with _obs.span("hd.prohd.extremes", device=a.device, cap_a=cap_a, cap_b=cap_b):
        mask_a, mask_b, proj_a, proj_b = selection.select_extremes(
            a, b, dirs, alpha=cfg.alpha, alpha_pca=cfg.alpha_pca
        )
        if cfg.prune:
            # HD is a set metric: a consistent row permutation changes nothing,
            # and sorted rows make the tile interval gaps bite.
            a, proj_a, _, perm_a = tile_bounds.order_by_projection(a, proj_a)
            b, proj_b, _, perm_b = tile_bounds.order_by_projection(b, proj_b)
            mask_a = mask_a[perm_a]
            mask_b = mask_b[perm_b]
        a_sel, va = selection.take_selected(a, mask_a, cap_a)
        b_sel, vb = selection.take_selected(b, mask_b, cap_b)
        if cfg.prune:
            # Gathering keeps the sort order, so the subsets' tables stay tight.
            proj_a_sel, _ = selection.take_selected(proj_a, mask_a, cap_a)
            proj_b_sel, _ = selection.take_selected(proj_b, mask_b, cap_b)

    if cfg.prune:
        if cfg.inner == "full":
            hd = _queries_vs_full_hd(
                a_sel, va, b_sel, vb, a, b, cfg,
                projs=(proj_a_sel, proj_b_sel, proj_a, proj_b),
            )
        else:
            hd = _subset_hd(a_sel, va, b_sel, vb, cfg, prune_projs=(proj_a_sel, proj_b_sel))
    elif cfg.inner == "full":
        hd = _queries_vs_full_hd(a_sel, va, b_sel, vb, a, b, cfg)
    else:
        hd = _subset_hd(a_sel, va, b_sel, vb, cfg)

    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    with _obs.span("hd.prohd.certificate", device=a.device, m=m):
        bound = bounds.additive_bound(a, b, proj_a, proj_b) if cfg.compute_bound else zero
        hd_proj = projected.projected_hd(proj_a, proj_b) if cfg.compute_projected else zero
    return ProHDEstimate(
        hd=hd,
        n_sel_a=mask_a.sum().to(torch.int32),
        n_sel_b=mask_b.sum().to(torch.int32),
        bound=bound,
        hd_proj=hd_proj,
    )
