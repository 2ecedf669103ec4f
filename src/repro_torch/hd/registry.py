"""(variant, method, backend) dispatch registry for the ``repro_torch.hd`` front door.

Counterpart of ``repro/hd/registry.py``.  Axes::

    variant  — hausdorff | directed | partial | chamfer
    method   — exact | prohd | sampling | adaptive
    backend  — dense | tiled | fused_cuda | distributed
               ("auto" is resolved by repro_torch.hd.resolver before lookup)

``fused_cuda`` (the hand-written CUDA scan) takes the place of the
reference's ``fused_pallas``.  Unknown axis values raise ``ValueError``;
known cells with no implementation raise :class:`UnsupportedCombination`.
"""
from __future__ import annotations

from typing import Callable

__all__ = [
    "VARIANTS",
    "METHODS",
    "BACKENDS",
    "CONCRETE_BACKENDS",
    "UnsupportedCombination",
    "validate_axes",
    "register",
    "resolve",
    "is_supported",
    "supported_backends",
    "supported_combinations",
]

VARIANTS = ("hausdorff", "directed", "partial", "chamfer")
METHODS = ("exact", "prohd", "sampling", "adaptive")
BACKENDS = ("dense", "tiled", "fused_cuda", "distributed", "auto")
CONCRETE_BACKENDS = tuple(b for b in BACKENDS if b != "auto")


class UnsupportedCombination(ValueError):
    """A (variant, method, backend) cell with no registered implementation;
    ``supported`` lists the backends that do serve (variant, method)."""

    def __init__(self, variant: str, method: str, backend: str):
        self.variant = variant
        self.method = method
        self.backend = backend
        self.supported = supported_backends(variant, method)
        hint = (
            f"supported backends for ({variant}, {method}): {list(self.supported)}"
            if self.supported
            else f"method {method!r} is not implemented for variant {variant!r}"
        )
        super().__init__(
            f"no implementation for variant={variant!r} method={method!r} "
            f"backend={backend!r}; {hint}"
        )


_REGISTRY: dict[tuple[str, str, str], Callable] = {}


def _check_axes(variant: str, method: str, backend: str, *, allow_auto: bool) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    ok = BACKENDS if allow_auto else CONCRETE_BACKENDS
    if backend not in ok:
        raise ValueError(f"unknown backend {backend!r}; expected one of {ok}")


def validate_axes(variant: str, method: str, backend: str) -> None:
    """Reject unknown axis values (typos) with a plain ValueError."""
    _check_axes(variant, method, backend, allow_auto=True)


def register(variant: str, method: str, backend: str):
    """Decorator: install ``fn(a, b, ctx) -> (value, lower, upper, stats)``
    as the implementation of one cell."""
    _check_axes(variant, method, backend, allow_auto=False)

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(variant, method, backend)] = fn
        return fn

    return deco


def resolve(variant: str, method: str, backend: str) -> Callable:
    """The implementation of a concrete cell, or raise."""
    _check_axes(variant, method, backend, allow_auto=False)
    impl = _REGISTRY.get((variant, method, backend))
    if impl is None:
        raise UnsupportedCombination(variant, method, backend)
    return impl


def is_supported(variant: str, method: str, backend: str) -> bool:
    return (variant, method, backend) in _REGISTRY


def supported_backends(variant: str, method: str) -> tuple[str, ...]:
    """Concrete backends registered for (variant, method), registry order."""
    return tuple(b for b in CONCRETE_BACKENDS if (variant, method, b) in _REGISTRY)


def supported_combinations() -> tuple[tuple[str, str, str], ...]:
    """Every registered (variant, method, backend), in matrix order."""
    return tuple(
        (v, m, b)
        for v in VARIANTS
        for m in METHODS
        for b in CONCRETE_BACKENDS
        if (v, m, b) in _REGISTRY
    )
