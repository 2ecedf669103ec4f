"""Front-door corpus retrieval: ``repro_torch.hd.search``.

Counterpart of ``repro/hd/search.py``: one entry point that takes a query
cloud and a :class:`repro_torch.index.SetStore` and returns the top-k
nearest stored sets under a set distance.  The work lives in
``repro_torch.index.cascade`` (imported lazily: the index dispatches its
exact refines back through this package).  ``search_batch`` comes with the
multi-query slice of the port.
"""
from __future__ import annotations

from repro_torch.hd.config import HDConfig

__all__ = ["search"]


def search(
    query,
    store,
    k: int,
    *,
    variant: str = "hausdorff",
    method: str = "cascade",
    backend: str = "auto",
    stage2: str = "batched",
    masked_backend: str | None = None,
    config: HDConfig | None = None,
    measure: bool = False,
    deadline_s: float | None = None,
    on_fault: str = "degrade",
    validate: bool = True,
    mode: str = "exact",
    epsilon: float = 0.0,
    budget: int | None = None,
    shards: int | None = None,
):
    """Top-k nearest stored sets to ``query``; see
    ``repro_torch.index.cascade.search``.  The cascade's top-k is identical
    to ``method="exact"`` (brute force); on the card its bucket passes run
    the batched bucket kernel and its refines the fused scan kernel."""
    from repro_torch.index import cascade

    return cascade.search(
        query, store, k,
        variant=variant, method=method, backend=backend, stage2=stage2,
        masked_backend=masked_backend, config=config, measure=measure,
        deadline_s=deadline_s, on_fault=on_fault, validate=validate,
        mode=mode, epsilon=epsilon, budget=budget, shards=shards,
    )
