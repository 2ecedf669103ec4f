"""Frozen front-door configuration (counterpart of ``repro/hd/config.py``).

``HDConfig`` keeps the reference's fields of the served methods, less
``interpret`` (there is no interpret mode for a CUDA kernel).  The knobs of
methods not yet ported (sampling, adaptive) come with those methods;
``repro_torch.interop`` drops them from a reference config dict.  Blocks
left as ``None`` are resolved by ``repro_torch.hd.resolver``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.prohd import ProHDConfig

__all__ = ["HDConfig"]

_SUBSET_BACKEND = {"dense": "dense", "tiled": "tiled", "fused_cuda": "cuda"}


@dataclasses.dataclass(frozen=True)
class HDConfig:
    """Every front-door knob, with the paper's defaults."""

    # -- shared / prohd -----------------------------------------------------
    alpha: float = 0.01              # selection / sampling fraction
    prune: bool = False              # projection pruning in the scans
    inner: str = "full"              # ProHD inner-min mode ("full"|"subset")
    # Full ProHDConfig override: alpha/prune/inner above are then ignored
    # and this config is used verbatim, subset backend aligned.
    prohd: ProHDConfig | None = None

    # -- partial ------------------------------------------------------------
    quantile: float = 0.95           # K-th-largest fraction for partial HD

    # -- machinery ----------------------------------------------------------
    block_a: int | None = None       # None → resolver
    block_b: int | None = None

    def prohd_config(self, backend: str) -> ProHDConfig:
        """The ProHDConfig this dispatch runs, subset backend aligned."""
        sb = _SUBSET_BACKEND[backend]
        if self.prohd is not None:
            return dataclasses.replace(self.prohd, subset_backend=sb)
        return ProHDConfig(alpha=self.alpha, prune=self.prune, inner=self.inner, subset_backend=sb)
