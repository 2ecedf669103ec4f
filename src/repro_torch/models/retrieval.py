"""Retrieval scoring: B queries vs 10⁶ candidates — batched dot + distributed
top-k, not a loop.

Counterpart of ``repro/models/retrieval.py``: candidates row-sharded over
the batch axes, local top-k per shard, gathered (P, k) re-top-k.  Scoring
modes: "dot" (two-tower / BERT4Rec / BST / FM) and "l2" (nearest
neighbour, ``−max(|q|² − 2q·c + |c|², 0)``).  The reference's docstring
says "l2" uses the Pallas Hausdorff kernel's min-distance form; its code
is the einsum above, and the port follows the code.

Ties: ``lax.top_k`` returns tied values lowest index first.
``torch.topk`` promises no order among ties on the card, so :func:`top_k`
takes the k first entries of a stable descending sort, which gives the
reference's order; the sharded merge then keeps it, since the gathered
candidates stand in rank order and each rank's in index order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.device import lm_precision, widen
from repro_torch.sharding.axes import MeshRules, current_rules

__all__ = ["TopK", "top_k", "retrieval_topk"]


class TopK(NamedTuple):
    scores: torch.Tensor  # (B, k)
    ids: torch.Tensor     # (B, k) int32 — candidate row indices


def top_k(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: values and int64 positions, ties
    lowest position first."""
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _local_scores(cand: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "dot":
        return widen(q) @ widen(cand).T
    if metric == "l2":
        q32, c32 = widen(q), widen(cand)
        q2 = torch.sum(q32 ** 2, -1, keepdim=True)
        c2 = torch.sum(c32 ** 2, -1)
        d2 = q2 - 2.0 * (q32 @ c32.T) + c2[None]
        return -torch.clamp(d2, min=0.0)  # negative distance → top-k = nearest
    raise ValueError(metric)


@lm_precision()
def retrieval_topk(
    candidates: torch.Tensor,   # (N, D), or this rank's (N/P, D) rows when sharded
    queries: torch.Tensor,      # (B, D) — the same on every rank
    k: int,
    *,
    metric: str = "dot",
    rules: MeshRules | None = None,
    shard_axes: tuple[str, ...] | None = None,
) -> TopK:
    """Distributed brute-force top-k.

    ``shard_axes`` (default: the rules' batch axes) names the mesh dims the
    candidate rows are sharded over; then ``candidates`` is this rank's
    contiguous block of rows (rank r of the flattened group holds rows
    ``[r·n_local, (r+1)·n_local)``), and every rank returns the same global
    top-k.  A rank with fewer than k rows pads its k results with −inf and
    id −1.  With no axes or no mesh: one local top-k.
    """
    rules = rules or current_rules()
    if shard_axes is None:
        shard_axes = rules.batch
    s = _local_scores(candidates, queries, metric)
    if not shard_axes or rules.mesh is None:
        vals, idx = top_k(s, k)
        return TopK(vals, idx.to(torch.int32))

    from repro_torch.core.distributed import batch_group

    group = batch_group(rules.mesh, tuple(shard_axes))
    n_local = candidates.shape[0]
    k_loc = min(k, s.shape[1])
    vals, idx = top_k(s, k_loc)                                   # (B, k_loc)
    gids = (idx + dist.get_rank(group) * n_local).to(torch.int32)
    if k_loc < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_loc), value=float("-inf"))
        gids = torch.nn.functional.pad(gids, (0, k - k_loc), value=-1)
    n = dist.get_world_size(group)
    g_vals = [torch.empty_like(vals) for _ in range(n)]
    g_ids = [torch.empty_like(gids) for _ in range(n)]
    dist.all_gather(g_vals, vals.contiguous(), group=group)
    dist.all_gather(g_ids, gids.contiguous(), group=group)
    top_vals, top_pos = top_k(torch.cat(g_vals, dim=1), k)        # (B, P·k) → (B, k)
    return TopK(top_vals, torch.gather(torch.cat(g_ids, dim=1), 1, top_pos))
