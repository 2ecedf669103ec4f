"""The pinned fp32 margins between two exact-HD computations of one pair.

A copy of ``_EPS32``, ``_ABS``, ``fp_margin`` and ``fp_value_margin`` from
``repro/index/cascade.py`` (lines 180-230), kept here so the port imports
nothing of the JAX package.  The arithmetic is unchanged: host-side
float64 numpy over anything ``np.asarray`` accepts.

With ``E = (dim+2)·eps32·scale²`` bounding the GEMM-form error of one d²
entry, ``fp_margin`` is the near-zero worst case ``2·sqrt(E)`` (plus
1e-6), and ``fp_value_margin`` the value-aware envelope
``2·E/(v − √E)`` away from zero.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fp_margin", "fp_value_margin", "sqdist_tolerance"]

_EPS32 = float(np.finfo(np.float32).eps)
_ABS = 1e-6


def _margin_factor(dim: int) -> float:
    return 2.0 * float(np.sqrt((dim + 2) * _EPS32))


def fp_margin(dim: int, scale):
    """``2·sqrt((dim+2)·eps32)·scale + 1e-6``."""
    return scale * _margin_factor(dim) + _ABS


def fp_value_margin(dim: int, scale, value):
    """Value-aware sharpening of :func:`fp_margin` — still certified."""
    e = (dim + 2) * _EPS32 * np.asarray(scale, dtype=np.float64) ** 2
    sqrt_e = np.sqrt(e)
    lo = np.maximum(np.asarray(value, dtype=np.float64) - sqrt_e, 0.0)
    return np.where(lo > sqrt_e, 2.0 * e / np.maximum(lo, 1e-300), 2.0 * sqrt_e) + _ABS


def sqdist_tolerance(dim: int, scale) -> float:
    """Per-entry bound between two fp32 GEMM-form min-d² values of one
    pair computed in different k orders: ``2·(dim+2)·eps32·scale²``."""
    return 2.0 * (dim + 2) * _EPS32 * float(scale) ** 2
