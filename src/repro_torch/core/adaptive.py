"""Adaptive-α ProHD under a strict error budget (paper §IV future work).

Counterpart of ``repro/core/adaptive.py``.  The certified interval makes
this sound: grow α (and m) until the certificate ``H ≤ hd_proj + bound``
is tight enough, or the schedule runs out, and return the estimate WITH
its certificate, so the caller can check that the budget was met.

Two budget modes:
  absolute   — require (upper - lower) ≤ budget
  relative   — require (upper - lower) / lower ≤ budget

The certificate depends on min_u δ(u) (how one-dimensional the data is),
not on α, so the schedule interleaves: m grows by ⌊√D⌋ on odd steps (it
tightens the certificate), α doubles on the others (it tightens the point
estimate).  On isotropic data the budget may not be met; the result then
says so (``met_budget=False``).

Each step runs ProHD through the port's front door on the backend given
(the dispatching cell's own: ``fused_cuda`` runs kernel 1 at every step)
and brings the interval to the host once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.prohd import ProHDConfig, ProHDEstimate

__all__ = ["AdaptiveResult", "prohd_with_budget"]


def _prohd_step(a, b, cfg: ProHDConfig, generator, backend: str) -> ProHDEstimate:
    """One ProHD evaluation through the ``repro_torch.hd`` front door (lazy
    import: ``repro_torch.hd`` depends on this module).  The clouds were
    validated by the caller's front door, so the step does not check them
    again (that would add a host sync per step)."""
    from repro_torch import hd

    res = hd.set_distance(
        a, b, variant="hausdorff", method="prohd", backend=backend,
        config=hd.HDConfig(prohd=cfg), generator=generator, validate=False,
    )
    return res.stats["estimate"]


class AdaptiveResult(NamedTuple):
    estimate: ProHDEstimate
    alpha: float
    m: int
    certified_gap: float     # upper - lower at the final step
    met_budget: bool
    steps: int


def prohd_with_budget(
    a,
    b,
    *,
    budget: float,
    relative: bool = True,
    alpha0: float = 0.005,
    max_alpha: float = 0.5,
    max_steps: int = 8,
    generator: torch.Generator | None = None,
    backend: str = "tiled",
) -> AdaptiveResult:
    """The reference's schedule, step for step.  When it runs out, the
    result carries ``met_budget=False`` and ``steps=max_steps``, as the
    reference reports it."""
    d = a.shape[1]
    m = max(1, int(d**0.5))
    alpha = alpha0
    est = None
    for step in range(1, max_steps + 1):
        cfg = ProHDConfig(alpha=alpha, num_pca_directions=min(m, d))
        est = _prohd_step(a, b, cfg, generator, backend)
        lower, bound = torch.stack([est.hd_proj, est.bound]).tolist()  # the step's one sync
        gap = (lower + bound) - lower
        target = budget * max(lower, 1e-12) if relative else budget
        if gap <= target:
            return AdaptiveResult(est, alpha, min(m, d), gap, True, step)
        # interleave: α tightens selection, m tightens the certificate
        if step % 2 == 1 and m < d:
            m = min(d, m + max(1, int(d**0.5)))
        else:
            alpha = min(max_alpha, alpha * 2)
            if alpha >= max_alpha and m >= d:
                break
    return AdaptiveResult(est, alpha, min(m, d), bound, False, max_steps)
