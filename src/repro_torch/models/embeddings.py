"""Sparse embedding substrate for recsys: sharded lookup + EmbeddingBag.

Counterpart of ``repro/models/embeddings.py``, with the reference's
``jnp.take`` and ``jax.ops.segment_sum`` / ``segment_max`` semantics:

* :func:`lookup` is ``jnp.take(table, ids, axis=0)``: a negative id in
  ``[-V, 0)`` reads row ``V + id``; an id past either end reads a row of
  NaN (``jnp.take``'s default fill), where ``index_select`` would raise.
* :func:`segment_sum` drops segment ids outside ``[0, num_segments)``;
  :func:`segment_max` gives −inf to a segment that receives nothing.  Both
  scatter into one spare row that is cut off, so no pass over the data
  masks it.  ``index_add`` adds in another order than XLA's scatter, so
  sums agree within rounding, not bitwise.

Distribution: tables are ROW-sharded over the "model" axis.
:func:`sharded_lookup` is the rank's body of the reference's
``shard_map``: each rank resolves the ids its block of rows owns (masked
local take) and an ``all_reduce`` SUM over the mesh's "model" group
assembles the full embeddings — one (batch, dim)-sized all-reduce, never
an all-gather of the table.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.axes import MeshRules, current_rules
from repro_torch.sharding.collectives import all_reduce_sum

__all__ = ["lookup", "embedding_bag", "sharded_lookup", "segment_sum", "segment_max"]


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).long()


def _spare_row(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment ids with every id outside ``[0, num_segments)`` sent to the
    spare row ``num_segments``."""
    ids = _ids(segment_ids, segment_ids.device)
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: (num_segments, *data.shape[1:])."""
    out = data.new_zeros((num_segments + 1, *data.shape[1:]))
    return out.index_add(0, _spare_row(segment_ids, num_segments), data)[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: −inf where a segment receives nothing."""
    out = data.new_full((num_segments + 1, *data.shape[1:]), float("-inf"))
    idx = _spare_row(segment_ids, num_segments).view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)[:num_segments]


def lookup(table: torch.Tensor, ids) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: (*ids.shape, *table.shape[1:])."""
    v = table.shape[0]
    ids = _ids(ids, table.device)
    idx = torch.where(ids < 0, ids + v, ids)
    ok = (idx >= 0) & (idx < v)
    rows = table.index_select(0, idx.clamp(0, max(v - 1, 0)).reshape(-1)).view(*ids.shape, *table.shape[1:])
    return torch.where(ok.view(*ok.shape, *([1] * (table.dim() - 1))), rows, float("nan"))


def embedding_bag(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    combiner: str = "sum",
    vocab: int | None = None,
) -> torch.Tensor:
    """torch.nn.EmbeddingBag equivalent: gather rows, segment-reduce.

    flat_ids: (T,) indices into table; segment_ids: (T,) bag index per id
    (monotone not required).  Returns (num_segments, D); an empty bag is 0
    for "sum" and "mean", −inf for "max".  With ``vocab`` (the global row
    count) the rows come from :func:`sharded_lookup`, so under rules with a
    "model" axis ``table`` may be this rank's block of rows.
    """
    emb = lookup(table, flat_ids) if vocab is None else sharded_lookup(table, flat_ids, vocab=vocab)
    if combiner == "max":
        return segment_max(emb, segment_ids, num_segments)
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    summed = segment_sum(emb, segment_ids, num_segments)
    if combiner == "sum":
        return summed
    counts = segment_sum(torch.ones(emb.shape[0], dtype=emb.dtype, device=emb.device), segment_ids,
                         num_segments)
    return summed / torch.clamp(counts[:, None], min=1.0)


def sharded_lookup(table: torch.Tensor, ids, rules: MeshRules | None = None, *,
                   vocab: int | None = None) -> torch.Tensor:
    """Row-sharded table lookup: masked local take + all_reduce over "model".

    ``vocab`` is the global table's row count (None: ``table`` is the whole
    table).  Under rules with a "model" axis of P ranks and a vocab that P
    divides, rank r owns rows ``[r·V/P, (r+1)·V/P)``; ``table`` is either
    that block or the whole table (the rank then takes its block).  Every
    rank passes the ids it holds; the result, (*ids.shape, D), is the same
    on every rank of the "model" group.  The reference's fallbacks are
    kept: no rules (or no mesh) and a vocab that P does not divide give a
    plain :func:`lookup` of the whole table.  Its third, ids replicated
    over the batch axes when their rows do not divide, changes only where
    the reference's ids live: here each rank passes its own either way.

    An id no block owns (out of range) reads zeros, as in the reference.
    Under autograd each rank's block gets the gradient of the rows it owns
    from its own copy of the loss (``sharding.collectives.all_reduce_sum``);
    with the ids replicated over the "model" group, the reference's
    layout, every copy is the same loss and that is the whole gradient.
    """
    rules = rules or current_rules()
    v = table.shape[0] if vocab is None else vocab
    if rules.model is None or rules.mesh is None:
        return lookup(table, ids)
    from repro_torch.core.distributed import batch_group

    group = batch_group(rules.mesh, (rules.model,))
    n_shards = dist.get_world_size(group)
    if v % n_shards != 0:
        return lookup(table, ids)  # non-divisible vocab: the whole table on every rank
    rows = v // n_shards
    my = dist.get_rank(group)
    if table.shape[0] == v:
        table = table[my * rows:(my + 1) * rows]
    elif table.shape[0] != rows:
        raise ValueError(f"table of {table.shape[0]} rows is neither the whole table ({v}) nor one block of "
                         f"{rows} rows over {n_shards} ranks")
    loc = _ids(ids, table.device) - my * rows
    ok = (loc >= 0) & (loc < rows)
    emb = table.index_select(0, loc.clamp(0, rows - 1).reshape(-1)).view(*loc.shape, *table.shape[1:])
    emb = torch.where(ok.view(*ok.shape, *([1] * (table.dim() - 1))), emb, 0.0)
    return all_reduce_sum(emb, group)
