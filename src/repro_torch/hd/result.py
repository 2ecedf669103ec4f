"""Uniform result type returned by every front-door dispatch
(counterpart of ``repro/hd/result.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["HDMeta", "HDResult"]


@dataclasses.dataclass(frozen=True)
class HDMeta:
    """Dispatch record."""

    variant: str
    method: str
    backend: str          # the concrete backend that ran ("auto" resolved)
    block_a: int
    block_b: int
    # Wall-clock seconds of the dispatched call, device synchronised; only
    # set by set_distance(measure=True) and search(measure=True).
    elapsed_s: float | None = None
    # ``degraded=True`` marks a search result whose certificate a deadline
    # or an absorbed fault weakened (its intervals still contain the truth);
    # ``stage_reached`` names the deepest cascade stage that contributed,
    # or "complete".  Pairwise dispatches never degrade.
    degraded: bool = False
    stage_reached: str = "complete"
    # "exact" (every pairwise dispatch, and the search's brute-force-equal
    # mode) or "anytime" (the search's ε/budget knob).
    mode: str = "exact"


@dataclasses.dataclass(frozen=True)
class HDResult:
    """What ``set_distance`` returns, whatever the (variant, method, backend).

    value  — the distance or estimate, scalar fp32 tensor.
    lower  — certified lower bound on the true distance, or None when the
             method carries no one-sided guarantee (chamfer, partial).
             For exact methods lower == upper == value.
    upper  — certified upper bound, or None.
    stats  — method-specific extras (ProHD's ``estimate``, ``n_sel_a/b``;
             pruning's ``skip_fraction``).
    meta   — dispatch record.
    """

    value: torch.Tensor
    lower: torch.Tensor | None
    upper: torch.Tensor | None
    stats: dict[str, Any]
    meta: HDMeta

    @property
    def certified(self) -> bool:
        """True when the result carries a two-sided certified interval."""
        return self.lower is not None and self.upper is not None

    @property
    def degraded(self) -> bool:
        """True when a deadline/fault weakened the certificate (the
        interval still contains the truth — see the reliability contract)."""
        return self.meta.degraded

    @property
    def stage_reached(self) -> str:
        """Deepest pipeline stage that contributed to this result."""
        return self.meta.stage_reached
