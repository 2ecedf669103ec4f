"""``repro_torch.hd`` — the set-distance front door of the port.

    from repro_torch.hd import HDConfig, set_distance

    res = set_distance(a, b)                       # variant/method/backend dispatch
    res.value, res.lower, res.upper, res.stats     # uniform HDResult

    res = search(query, store, k=10)               # corpus top-k (repro_torch.index)
    out = search_batch(queries, store, k=10)       # one result per query

    res = set_distance(a_rows, b_rows, backend="distributed", mesh=mesh)
                                                   # SPMD over a DeviceMesh

Layout (as in ``repro.hd``): registry, resolver, config, result, methods,
engine, search.
"""
from repro_torch.hd.config import BACKEND_FOR_SUBSET, HDConfig
from repro_torch.hd.engine import HDEngine, set_distance
from repro_torch.hd import methods as _methods  # noqa: F401  (populates the registry)
from repro_torch.hd.registry import (
    BACKENDS,
    METHODS,
    VARIANTS,
    UnsupportedCombination,
    register,
    supported_backends,
    supported_combinations,
)
from repro_torch.hd.resolver import TILE_THRESHOLD, resolve_backend, resolve_block_sizes
from repro_torch.hd.result import HDMeta, HDResult
from repro_torch.hd.search import search, search_batch

__all__ = [
    "set_distance",
    "search",
    "search_batch",
    "HDEngine",
    "HDConfig",
    "BACKEND_FOR_SUBSET",
    "HDResult",
    "HDMeta",
    "UnsupportedCombination",
    "register",
    "supported_backends",
    "supported_combinations",
    "resolve_backend",
    "resolve_block_sizes",
    "TILE_THRESHOLD",
    "VARIANTS",
    "METHODS",
    "BACKENDS",
]
