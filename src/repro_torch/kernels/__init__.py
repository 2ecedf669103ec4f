"""The port's hand-written CUDA kernels, their launchers and plain versions.

No kernel here has a backward: each launcher writes its outputs through
``ctypes`` into buffers that autograd never sees.  :func:`refuse_grad` is
called by every launcher before it launches, so a kernel result cannot
silently drop out of a gradient.
"""
from __future__ import annotations

import torch

__all__ = ["refuse_grad"]


def refuse_grad(what: str, *tensors: torch.Tensor | None) -> None:
    """Raise when grad mode is on and an input requires grad: the kernel's
    output would carry no gradient to it.  No effect under ``no_grad``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} launches a CUDA kernel with no backward, so its result would carry no "
            "gradient to inputs that require grad.  Under autograd pass backend=\"tiled\" to "
            "set_distance (the plain PyTorch scan), take attention from "
            "models.layers.causal_attention (kernel 4 with a recomputing backward), or call "
            "it under torch.no_grad()")
