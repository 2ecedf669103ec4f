"""Graph data pipeline: CSR storage + fanout neighbour sampling.

Counterpart of ``repro/data/graphs.py``, a copy of its numpy (the port
imports nothing of the reference): for the same ``np.random.Generator``
state every function gives the reference's arrays bit for bit.

``minibatch_lg`` (Reddit-scale: 233k nodes / 115M edges, batch 1024,
fanout 15-10) requires a REAL neighbour sampler.  The sampler is host-side
numpy (it is I/O, not accelerator work), emits the fixed-shape padded
subgraph format the GAT model consumes, and is deterministic given a seed.

Layout contract:
  seeds (B,) → layer-1 neighbours (B·f0) → layer-2 neighbours (B·f0·f1)
  nodes  = [seeds | hop1 | hop2]               (n = B·(1 + f0 + f0·f1))
  edges  = hop1→seeds ∪ hop2→hop1, child → parent (messages flow to seeds)
  missing neighbours (degree < fanout) are masked, not resampled.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed sparse row adjacency + features + labels."""

    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (E,) int32
    feats: np.ndarray    # (N, F) float32
    labels: np.ndarray   # (N,) int32

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    @staticmethod
    def random(rng: np.random.Generator, n_nodes: int, avg_degree: int, d_feat: int, n_classes: int) -> "CSRGraph":
        """Synthetic power-law-ish graph for tests/benchmarks."""
        degrees = np.clip(
            rng.pareto(2.0, n_nodes) * avg_degree / 2 + 1, 1, 50 * avg_degree
        ).astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(degrees)])
        indices = rng.integers(0, n_nodes, indptr[-1], dtype=np.int32)
        return CSRGraph(
            indptr=indptr,
            indices=indices,
            feats=rng.standard_normal((n_nodes, d_feat), dtype=np.float32),
            labels=rng.integers(0, n_classes, n_nodes, dtype=np.int32),
        )


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
):
    """Layer-wise fanout sampling → fixed-shape padded subgraph.

    Returns dict with feats, edge_src, edge_dst, edge_mask, labels,
    label_mask — directly consumable by gat_node_loss (seeds carry labels,
    sampled neighbours are masked out of the loss).
    """
    b = len(seeds)
    frontier = seeds.astype(np.int64)
    all_nodes = [frontier]
    src_list, dst_list, mask_list = [], [], []
    node_offset = 0

    for f in fanouts:
        parents = frontier
        n_par = len(parents)
        children = np.zeros(n_par * f, dtype=np.int64)
        mask = np.zeros(n_par * f, dtype=np.float32)
        for i, p in enumerate(parents):
            lo, hi = graph.indptr[p], graph.indptr[p + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = rng.choice(deg, size=take, replace=False) + lo
            children[i * f : i * f + take] = graph.indices[picks]
            mask[i * f : i * f + take] = 1.0
        child_offset = node_offset + n_par
        # edges: child (position-indexed) → parent (position-indexed)
        src = child_offset + np.arange(n_par * f)
        dst = node_offset + np.repeat(np.arange(n_par), f)
        src_list.append(src)
        dst_list.append(dst)
        mask_list.append(mask)
        all_nodes.append(children)
        frontier = children
        node_offset = child_offset

    nodes = np.concatenate(all_nodes)
    n_total = len(nodes)
    src = np.concatenate(src_list).astype(np.int32)
    dst = np.concatenate(dst_list).astype(np.int32)
    emask = np.concatenate(mask_list)
    # self-loops on every position (real, unmasked)
    loops = np.arange(n_total, dtype=np.int32)
    src = np.concatenate([src, loops])
    dst = np.concatenate([dst, loops])
    emask = np.concatenate([emask, np.ones(n_total, np.float32)])

    label_mask = np.zeros(n_total, bool)
    label_mask[:b] = True
    return {
        "feats": graph.feats[nodes],
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": emask,
        "labels": graph.labels[nodes],
        "label_mask": label_mask,
    }


def partition_edges_by_dst(
    src: np.ndarray,
    dst: np.ndarray,
    mask: np.ndarray,
    n_nodes: int,
    n_shards: int,
):
    """Group edges by their DST's owner shard, equal edges per shard.

    Owner of node v = v // (n_nodes / n_shards) — contiguous ownership
    blocks.  Each shard's slice is padded with masked edges (pointing at
    the shard's first node) so the global edge array shape is static and
    evenly shardable.  Returns (src, dst, mask, n_nodes_padded).

    This is the input contract of gat_forward_partitioned: all segment
    reductions become shard-local.
    """
    n_pad = ((n_nodes + n_shards - 1) // n_shards) * n_shards
    n_local = n_pad // n_shards
    owner = dst // n_local
    per_shard = [np.where((owner == s) & (mask > 0))[0] for s in range(n_shards)]
    cap = max(len(ix) for ix in per_shard)
    cap = ((cap + 127) // 128) * 128  # lane-friendly
    out_src = np.zeros((n_shards, cap), np.int32)
    out_dst = np.zeros((n_shards, cap), np.int32)
    out_mask = np.zeros((n_shards, cap), np.float32)
    for s, ix in enumerate(per_shard):
        out_src[s, : len(ix)] = src[ix]
        out_dst[s, : len(ix)] = dst[ix]
        out_dst[s, len(ix):] = s * n_local  # padded edges stay owner-local
        out_mask[s, : len(ix)] = 1.0
    return (
        out_src.reshape(-1),
        out_dst.reshape(-1),
        out_mask.reshape(-1),
        n_pad,
    )


def minibatch_iterator(graph: CSRGraph, batch_size: int, fanouts: tuple[int, ...], seed: int = 0):
    """Infinite epoch-shuffled seed batches → sampled subgraphs."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(graph.n_nodes)
        for i in range(0, graph.n_nodes - batch_size + 1, batch_size):
            yield sample_subgraph(graph, order[i : i + batch_size], fanouts, rng)
