"""The arithmetic of the references: float64, or the control's TF32.

``"float64"`` is the reference.  ``"tf32"`` is the control of a float32
program with TF32 off (the precision the configurations state): the same
code in float32 with every matrix product in TF32.  On the card that is cuBLAS with TF32 allowed; on the CPU, which
has no TF32, the operands are rounded to TF32's 10-bit mantissa (round to
nearest even) and multiplied in float32, which is what the tensor cores do.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["PRECISIONS", "dtype_of", "tf32_round", "mm"]

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (8-bit exponent, 10-bit mantissa)."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


@contextlib.contextmanager
def _cuda_tf32():
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32
    m.allow_tf32 = True
    try:
        yield
    finally:
        m.allow_tf32 = saved


def mm(x: torch.Tensor, y: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ y`` in ``precision``."""
    dt = dtype_of(precision)
    x, y = x.to(dt), y.to(dt)
    if precision == "float64":
        return x @ y
    if x.is_cuda:
        with _cuda_tf32():
            return x @ y
    return tf32_round(x) @ tf32_round(y)
