"""Front-door corpus retrieval: ``repro_torch.hd.search`` / ``search_batch``.

Counterpart of ``repro/hd/search.py``: entry points that take a query
cloud (or a batch of them) and a :class:`repro_torch.index.SetStore` and
return the top-k nearest stored sets under a set distance.  The work lives
in ``repro_torch.index.cascade`` and ``repro_torch.index.multiquery``
(imported lazily: the index dispatches its exact refines back through this
package).
"""
from __future__ import annotations

from repro_torch.hd.config import HDConfig

__all__ = ["search", "search_batch"]


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


def search_batch(
    queries,
    store,
    k,
    *,
    variant: str = "hausdorff",
    backend: str = "auto",
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
    """Top-k for every query of a batch in ONE call; see
    ``repro_torch.index.multiquery.search_batch``.  Shares one stage-0
    pass across the batch, deduplicates repeated queries, and tightens
    every query's frontier in one multi-query pass per bucket (kernel 3 on
    the card).  Per query, the result is bit for bit that query's own
    ``search(...)`` (hence brute force) unless degraded; ``k`` may be one
    int or one per query."""
    from repro_torch.index import multiquery

    return multiquery.search_batch(
        queries, store, k,
        variant=variant, backend=backend, masked_backend=masked_backend,
        config=config, measure=measure, deadline_s=deadline_s,
        on_fault=on_fault, validate=validate,
        mode=mode, epsilon=epsilon, budget=budget, shards=shards,
    )
