"""Corpus-parallel stage 0 / stage 1 over several devices of one process.

Counterpart of ``repro/index/sharded.py``.  ``search(..., shards=P)`` and
``search_batch(..., shards=P)`` split the cascade's two bucket-granularity
passes across the first P visible devices of the store's kind
(:func:`visible_devices`), in one process, as the reference's one
``shard_map`` call over its first P devices does:

  stage 0 — the (N,)-stacked summaries are split into P contiguous row
      blocks; each device runs the SAME ``cascade.interval_bounds`` /
      ``bound_scale`` on its block and the raw bounds are concatenated on
      the store's device.  Every bound is row-local arithmetic, so
      sharding stage 0 is a layout change.
  stage 1 — a bucket's frontier lanes are dealt to the devices in P
      contiguous blocks; each device runs the cascade's own
      ``_stage1_batch`` (on the card kernel 2's directed instance) on its
      block, gathered and padded to a power of two exactly as the
      unsharded path gathers a bucket, and the certificates come back in
      frontier order.
  merge — the certificates land in the one (lb, ub) interval state, and
      :func:`merge_topk` re-applies the prune rule ``lb > k-th smallest
      certified ub`` over the whole corpus; stage 2 is unchanged.

An unsharded search runs these same functions on a one-device
:class:`ShardContext` (the store's device), so ``shards=1`` is that call
and every stat but ``shards`` is the same.

The reference pads the lanes to a common width, deals them round-robin and
vmaps the certificate per shard (``sharded.py:162-215``); that costs it
8.64 s at shards=1 against 0.1 s unsharded (``BENCH_PR10.json``) and is
not copied.  The top-k is brute force's bit for bit at every P: its values
come from stage-2 raw refines on the unpadded points and its membership is
the brute-force top-k under any certified bounds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.index import cascade as _cascade
from repro_torch.index.store import SetSummary

__all__ = [
    "ShardContext",
    "visible_devices",
    "make_shard_context",
    "stage0_bounds",
    "stage1_certs",
    "merge_topk",
]


def visible_devices(kind: str) -> list[torch.device]:
    """The devices of ``kind`` this process sees: every CUDA device, or the
    one CPU."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


class ShardContext:
    """The devices one sharded search call runs on, in shard order."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.n_shards = len(self.devices)


def make_shard_context(shards: int, kind: str = "cuda") -> ShardContext:
    """A :class:`ShardContext` over the first ``shards`` visible devices of
    ``kind`` (the store's device type)."""
    shards = int(shards)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    devices = visible_devices(kind)
    if shards > len(devices):
        raise ValueError(
            f"shards={shards} exceeds the {len(devices)} visible {kind} "
            "device(s); lower shards"
        )
    return ShardContext(devices[:shards])


def _blocks(n: int, p: int) -> list[tuple[int, int]]:
    """The non-empty [lo, hi) of n items dealt to p shards in contiguous
    blocks (sizes differ by at most one, the larger first)."""
    edges = np.cumsum([0] + [len(b) for b in np.array_split(np.arange(n), p)])
    return [(int(lo), int(hi)) for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]


def stage0_bounds(ctx: ShardContext, qsum: SetSummary, ssums: SetSummary, *, directed: bool):
    """Sharded stage 0: the raw certified ``(lb, ub, scale)`` on the
    store's device, the corpus rows split across ``ctx``'s devices; (N,)
    fp32 each for one query, (Q, N) for ``search_batch``'s stacked
    summaries ((Q, 1, ...) per field, so the corpus axis is the last).
    Callers apply ``certified_margins`` before pruning."""
    n = int(ssums.count.shape[0])
    home = ssums.centroid.device
    parts = []
    for dev, (lo, hi) in zip(ctx.devices, _blocks(n, ctx.n_shards)):
        qs = SetSummary(*(f.to(dev) for f in qsum))
        ss = SetSummary(*(f[lo:hi].to(dev) for f in ssums))
        lb, ub = _cascade.interval_bounds(qs, ss, directed=directed)
        parts.append((lb, ub, _cascade.bound_scale(qs, ss)))
    return tuple(torch.cat([p[i].to(home) for p in parts], dim=-1) for i in range(3))


def stage1_certs(ctx: ShardContext, q: torch.Tensor, bucket, rows: np.ndarray, *,
                 alpha: float, m: int, directed: bool, backend: str):
    """Sharded stage 1 for one bucket: masked ProHD certificates of the
    frontier ``rows``, dealt to the devices in contiguous blocks.

    Returns ``(hd, lower, upper, batch)``: three (rows.size,) float64 numpy
    arrays in frontier order and the lanes launched in all (power-of-two
    padding included).
    """
    certs = []
    for dev, (lo, hi) in zip(ctx.devices, _blocks(int(rows.size), ctx.n_shards)):
        take = _cascade._pow2_take(rows[lo:hi], bucket.points.device)
        pts = bucket.points.index_select(0, take).to(dev)
        val = bucket.valid.index_select(0, take).to(dev)
        cert = _cascade._stage1_batch(
            q.to(dev), pts, val, alpha=alpha, m=m, directed=directed, backend=backend,
        )
        certs.append((cert, hi - lo, int(take.shape[0])))
    hd, lower, upper = (
        np.concatenate([getattr(c, f).double().cpu().numpy()[:n] for c, n, _ in certs])
        for f in ("hd", "lower", "upper")
    )
    return hd, lower, upper, sum(b for _, _, b in certs)


def merge_topk(lb: np.ndarray, ub: np.ndarray, alive: np.ndarray, k: int):
    """Cross-shard certified top-k merge: τ = the k-th smallest certified
    upper bound over the WHOLE corpus, survivors ``lb ≤ τ``.  The shards'
    certificates are already folded into the global (lb, ub); this is the
    unsharded stage-1 epilogue, which is what lets the sharded frontier feed
    the unchanged stage 2.  Returns ``(tau, still_alive)``."""
    tau = _cascade._kth_smallest(ub, k)
    return tau, alive & (lb <= tau)
