"""``repro_torch.index`` — corpus-scale Hausdorff retrieval.

Counterpart of ``repro.index``: a :class:`SetStore` packs many
variable-size point sets into power-of-two padded buckets with per-set
summaries, and :func:`search` runs the certified bound cascade whose top-k
is identical to brute force::

    from repro_torch.hd import search
    from repro_torch.index import SetStore

    store = SetStore(dim=16)              # on the card; device="cpu" here
    store.add_many(sets)
    res = search(query, store, k=10)      # res.ids, res.values, res.stats
    out = search_batch(queries, store, 10)  # one SearchResult per query

Not ported yet: ``shards=``.
"""
from repro_torch.index.cascade import (
    ON_FAULT_MODES,
    SEARCH_METHODS,
    SEARCH_MODES,
    SEARCH_VARIANTS,
    STAGE2_MODES,
    SearchResult,
    anytime_frontier,
    bound_scale,
    certified_margins,
    certified_recall,
    fp_margin,
    fp_value_margin,
    interval_bounds,
    search,
)
from repro_torch.index.multiquery import search_batch
from repro_torch.index.store import (
    SNAPSHOT_FORMAT,
    PackedBucket,
    SetStore,
    SetSummary,
    bucket_capacity,
    direction_bank,
    latest_snapshot,
    summarize_set,
)

__all__ = [
    "SetStore",
    "SetSummary",
    "PackedBucket",
    "bucket_capacity",
    "direction_bank",
    "latest_snapshot",
    "summarize_set",
    "SNAPSHOT_FORMAT",
    "search",
    "search_batch",
    "SearchResult",
    "SEARCH_VARIANTS",
    "SEARCH_METHODS",
    "SEARCH_MODES",
    "STAGE2_MODES",
    "ON_FAULT_MODES",
    "anytime_frontier",
    "certified_recall",
    "interval_bounds",
    "bound_scale",
    "certified_margins",
    "fp_margin",
    "fp_value_margin",
]
