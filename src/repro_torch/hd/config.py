"""Frozen front-door configuration (counterpart of ``repro/hd/config.py``).

``HDConfig`` keeps the reference's fields, less ``interpret`` (there is no
interpret mode for a CUDA kernel).  Blocks left as ``None`` are resolved by
``repro_torch.hd.resolver``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.prohd import ProHDConfig

__all__ = ["HDConfig", "BACKEND_FOR_SUBSET"]

_SUBSET_BACKEND = {"dense": "dense", "tiled": "tiled", "fused_cuda": "cuda"}
# Inverse map: ProHDConfig.subset_backend -> front-door backend name.
BACKEND_FOR_SUBSET = {"dense": "dense", "tiled": "tiled", "cuda": "fused_cuda"}


@dataclasses.dataclass(frozen=True)
class HDConfig:
    """Every front-door knob, with the paper's defaults.

    Only the fields of the dispatched (variant, method) are read; the rest
    are inert, so one config can drive a whole sweep.
    """

    # -- shared / prohd -----------------------------------------------------
    alpha: float = 0.01              # selection / sampling fraction
    prune: bool = False              # projection pruning in the scans
    inner: str = "full"              # ProHD inner-min mode ("full"|"subset")
    # Full ProHDConfig override: alpha/prune/inner above are then ignored
    # and this config is used verbatim, subset backend aligned.
    prohd: ProHDConfig | None = None

    # -- partial ------------------------------------------------------------
    quantile: float = 0.95           # K-th-largest fraction for partial HD

    # -- sampling -----------------------------------------------------------
    sampler: str = "random"          # "random" | "systematic"

    # -- adaptive -----------------------------------------------------------
    budget: float = 0.1              # certified-gap budget
    budget_relative: bool = True     # gap relative to the lower bound
    adaptive_alpha0: float = 0.005
    adaptive_max_alpha: float = 0.5
    adaptive_max_steps: int = 8

    # -- machinery ----------------------------------------------------------
    block_a: int | None = None       # None → resolver
    block_b: int | None = None

    def prohd_config(self, backend: str) -> ProHDConfig:
        """The ProHDConfig this dispatch runs, subset backend aligned."""
        sb = _SUBSET_BACKEND[backend]
        if self.prohd is not None:
            return dataclasses.replace(self.prohd, subset_backend=sb)
        return ProHDConfig(alpha=self.alpha, prune=self.prune, inner=self.inner, subset_backend=sb)
