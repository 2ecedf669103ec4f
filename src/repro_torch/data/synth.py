"""Synthetic batches for the LM path.

Counterpart of ``repro/data/synth.py::lm_batch``.  Draws from an explicit
``torch.Generator`` on the generator's device; the numbers differ from
``jax.random``'s for the same seed, so tests hand both packages the same
numpy tokens instead.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LMConfig

__all__ = ["lm_batch"]


def lm_batch(gen: torch.Generator, cfg: LMConfig, batch: int, seq: int) -> dict:
    """Uniform token ids (batch, seq + 1), int32, in ``[0, cfg.vocab)``."""
    return {"tokens": torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen,
                                    device=gen.device, dtype=torch.int32)}
