"""GAT (Veličković et al., arXiv:1710.10903) via edge-list message passing.

Counterpart of ``repro/models/gnn.py``.  Message passing is gathers
(``index_select``) and scatter reductions over an edge index
(``embeddings.segment_sum`` / ``segment_max``, the reference's
``jax.ops.segment_*`` semantics): SDDMM (edge scores) → segment-softmax →
SpMM (weighted aggregation).  Parameters live in a
:class:`~repro_torch.models.param_tree.ParamTree` under the reference's
names (``l1.w``, ``l1.a_src``, ``l2.b``, ...).  Every entry point runs
under ``device.lm_precision`` (no TF32 in its fp32 products).

Shapes with multiple graphs (``molecule``) arrive pre-flattened as one
block-diagonal graph with ``graph_ids`` for readout — the standard batching.

The partitioned forms run SPMD over the mesh's batch group
(``core.distributed.batch_group``): rank r owns the contiguous node block
``[r·N/P, (r+1)·N/P)`` and passes its own node rows and its own edge
slice (every edge's dst in its block; ``data.graphs.partition_edges_by_dst``
builds such slices).  The one collective per layer is an all-gather of
the projected features and source scores, in ``gather_dtype``; the loss's
sums are all-reduced, so every rank returns the global loss.  Under
autograd every rank runs the backward of its copy of the loss and the
parameter gradients of the ranks add up to the global loss's
(``sharding.collectives``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.device import lm_precision, widen
from repro_torch.models.embeddings import segment_max, segment_sum
from repro_torch.models.param_tree import ParamTree, spec_tree
from repro_torch.sharding.axes import MeshRules
from repro_torch.sharding.collectives import all_gather_rows, all_reduce_sum

__all__ = ["init_gat_params", "gat_param_specs", "with_self_loops", "gat_forward", "gat_node_loss",
           "gat_graph_loss", "gat_forward_partitioned", "gat_node_loss_partitioned"]


def init_gat_params(gen: torch.Generator, cfg: GNNConfig, in_dim: int, n_classes: int) -> ParamTree:
    """2-layer GAT: (in → heads×hidden, ELU) → (heads·hidden → classes),
    glorot-uniform weights and zero biases, on ``gen``'s device."""
    h, dh = cfg.n_heads, cfg.d_hidden
    mid = h * dh

    def glorot(shape):
        lim = (6.0 / (shape[0] + shape[-1])) ** 0.5
        u = torch.rand(shape, generator=gen, device=gen.device, dtype=cfg.dtype)
        return u * (2 * lim) - lim

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=gen.device)

    return ParamTree({
        "l1": {"w": glorot((in_dim, h, dh)), "a_src": glorot((h, dh)), "a_dst": glorot((h, dh)),
               "b": zeros((h, dh))},
        # output layer: single averaged head over n_classes (GAT paper)
        "l2": {"w": glorot((mid, h, n_classes)), "a_src": glorot((h, n_classes)),
               "a_dst": glorot((h, n_classes)), "b": zeros((h, n_classes))},
    })


def gat_param_specs(params: ParamTree, rules: MeshRules):
    # weights are tiny → replicated
    return spec_tree(params, rules)


def _project(x, lp):
    """(N, F) @ (F, H, Dh) → (N, H, Dh) and the per-node source and
    destination scores (N, H)."""
    h = (x @ lp.w.reshape(lp.w.shape[0], -1)).view(x.shape[0], *lp.w.shape[1:])
    return h, torch.sum(h * lp.a_src, dim=-1), torch.sum(h * lp.a_dst, dim=-1)


def _aggregate(h_src_rows, a_src, a_dst, lp, src, dst, emask, n_nodes, negative_slope, concat_heads):
    """SDDMM → segment-softmax over each dst's incoming edges → SpMM.
    ``h_src_rows`` and ``a_src`` are indexed by ``src``; ``a_dst`` and the
    output (n_nodes rows) by ``dst``."""
    e = a_src.index_select(0, src) + a_dst.index_select(0, dst)
    e = F.leaky_relu(e, negative_slope)                               # (E, H)
    e = torch.where(emask[:, None] > 0, e, -1e30)
    e_max = torch.clamp(segment_max(e, dst, n_nodes), min=-1e29)      # nodes with no real edges
    w = torch.exp(e - e_max.index_select(0, dst)) * emask[:, None]
    denom = segment_sum(w, dst, n_nodes)
    w = w / torch.clamp(denom.index_select(0, dst), min=1e-9)
    msg = h_src_rows.index_select(0, src) * w[..., None]              # (E, H, Dh)
    out = segment_sum(msg, dst, n_nodes) + lp.b
    if concat_heads:
        return out.reshape(n_nodes, -1)
    return torch.mean(out, dim=1)


def _gat_layer(x, lp, src, dst, emask, n_nodes, *, negative_slope, concat_heads):
    """x: (N, F_in) → (N, H·F_out) (concat) or (N, F_out) (head-mean).

    emask: (E,) {0,1} — padded/invalid edges contribute nothing (their
    softmax logit is -1e30).
    """
    h, a_src, a_dst = _project(x, lp)
    return _aggregate(h, a_src, a_dst, lp, src, dst, emask, n_nodes, negative_slope, concat_heads)


def with_self_loops(src, dst, n_nodes, *, pad_to: int | None = None):
    """Append self-loops and (optionally) pad to a shard-divisible length.

    Returns (src, dst, mask) — the canonical preprocessing for gat_forward.
    """
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    loops = torch.arange(n_nodes, dtype=src.dtype, device=src.device)
    src = torch.cat([src, loops])
    dst = torch.cat([dst, loops])
    mask = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    if pad_to is not None and pad_to > src.shape[0]:
        extra = pad_to - src.shape[0]
        src = torch.cat([src, src.new_zeros(extra)])
        dst = torch.cat([dst, dst.new_zeros(extra)])
        mask = torch.cat([mask, mask.new_zeros(extra)])
    return src, dst, mask


def _edges(batch):
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    if emask is None:
        emask = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    return src, dst, emask


@lm_precision()
def gat_forward(params: ParamTree, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """batch: feats (N,F), edge_src/edge_dst (E,) int (self-loops included
    by the pipeline — see with_self_loops), optional edge_mask (E,)."""
    x = batch["feats"]
    n = x.shape[0]
    src, dst, emask = _edges(batch)
    h = _gat_layer(x, params.l1, src, dst, emask, n, negative_slope=cfg.negative_slope, concat_heads=True)
    h = F.elu(h)
    return _gat_layer(h, params.l2, src, dst, emask, n, negative_slope=cfg.negative_slope, concat_heads=False)


def _node_ce(logits, labels, label_mask, reduce=lambda t: t):
    """Masked CE and accuracy; ``reduce`` sums a partial sum over ranks."""
    logp = torch.log_softmax(widen(logits), dim=-1)
    ll = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    mask = label_mask.float()
    count = torch.clamp(reduce(torch.sum(mask)), min=1.0)
    loss = -reduce(torch.sum(ll * mask)) / count
    hits = (torch.argmax(logits, -1) == labels.long()).float()
    acc = reduce(torch.sum(hits * mask).detach()) / count.detach()
    return loss, {"ce_loss": loss, "acc": acc}


@lm_precision()
def gat_node_loss(params: ParamTree, batch: dict, cfg: GNNConfig):
    """Node classification CE on masked (labelled) nodes."""
    return _node_ce(gat_forward(params, batch, cfg), batch["labels"], batch["label_mask"])


@lm_precision()
def gat_graph_loss(params: ParamTree, batch: dict, cfg: GNNConfig):
    """Graph classification: mean-readout per graph_id then CE (molecule)."""
    node_out = gat_forward(params, batch, cfg)  # (N, C)
    gids = batch["graph_ids"]
    labels = batch["labels"].long()
    n_graphs = labels.shape[0]
    summed = segment_sum(node_out, gids, n_graphs)
    counts = segment_sum(node_out.new_ones((node_out.shape[0], 1)), gids, n_graphs)
    logits = widen(summed / torch.clamp(counts, min=1.0))
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, 1, labels[:, None])[:, 0]
    loss = -torch.mean(ll)
    return loss, {"ce_loss": loss}


# ---------------------------------------------------------------------------
# Partitioned GAT: dst-owner node partitioning (no node-field all-reduces)
# ---------------------------------------------------------------------------


@lm_precision()
def gat_forward_partitioned(params: ParamTree, batch: dict, cfg: GNNConfig, rules: MeshRules, *,
                            gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """This rank's logits (n_local, C).

    ``batch`` holds this rank's node block (``feats`` (n_local, F)) and its
    edge slice (``edge_src`` global ids, ``edge_dst`` global ids inside the
    block, ``edge_mask``).  Each layer projects the local rows, all-gathers
    ``h`` and the source scores over the batch group (cast to
    ``gather_dtype`` for the gather and back), and reduces locally.
    """
    from repro_torch.core.distributed import batch_group

    import torch.distributed as dist

    group = batch_group(rules.mesh, rules.batch)
    x = batch["feats"]
    n_local = x.shape[0]
    src, dst, emask = _edges(batch)
    dst_local = dst - dist.get_rank(group) * n_local                  # owner-local ids

    def layer(x_local, lp, concat):
        h_local, a_src_local, a_dst_local = _project(x_local, lp)
        g_dtype = gather_dtype or h_local.dtype
        h_full = all_gather_rows(h_local.to(g_dtype), group).to(h_local.dtype)
        a_src_full = all_gather_rows(a_src_local.to(g_dtype), group).to(h_local.dtype)
        return _aggregate(h_full, a_src_full, a_dst_local, lp, src, dst_local, emask, n_local,
                          cfg.negative_slope, concat)

    h = F.elu(layer(x, params.l1, True))
    return layer(h, params.l2, False)                                 # (n_local, C)


@lm_precision()
def gat_node_loss_partitioned(params: ParamTree, batch: dict, cfg: GNNConfig, rules: MeshRules,
                              gather_dtype: torch.dtype | None = None):
    """The global masked CE and accuracy, the same on every rank: each
    rank's sums and label count are all-reduced over the batch group."""
    from repro_torch.core.distributed import batch_group

    group = batch_group(rules.mesh, rules.batch)
    logits = gat_forward_partitioned(params, batch, cfg, rules, gather_dtype=gather_dtype)
    return _node_ce(logits, batch["labels"], batch["label_mask"], lambda t: all_reduce_sum(t, group))
