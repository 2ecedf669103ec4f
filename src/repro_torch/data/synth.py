"""Synthetic batch generators for every architecture family.

Counterpart of ``repro/data/synth.py``.  Each draws from an explicit
``torch.Generator`` on the generator's device; the numbers differ from
``jax.random``'s for the same seed (tests hand both packages the same
numpy batches instead), while the keys, shapes, dtypes and value ranges
are the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.models.gnn import with_self_loops
from repro_torch.models.recsys import N_PROFILE

__all__ = ["lm_batch", "gnn_batch", "recsys_batch"]


def _randint(gen, low, high, shape) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=gen, device=gen.device, dtype=torch.int32)


def lm_batch(gen: torch.Generator, cfg: LMConfig, batch: int, seq: int) -> dict:
    """Uniform token ids (batch, seq + 1), int32, in ``[0, cfg.vocab)``."""
    return {"tokens": _randint(gen, 0, cfg.vocab, (batch, seq + 1))}


def gnn_batch(
    gen: torch.Generator,
    cfg: GNNConfig,
    *,
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    n_classes: int,
    n_graphs: int = 0,
    pad_edges_to: int | None = None,
) -> dict:
    """Uniform random edges (int32) plus self-loops (``with_self_loops``),
    N(0, 1) fp32 features, int32 labels per node (or per graph with
    ``n_graphs``, then ``graph_ids`` splits the nodes into equal runs)."""
    src = _randint(gen, 0, n_nodes, (n_edges,))
    dst = _randint(gen, 0, n_nodes, (n_edges,))
    src, dst, mask = with_self_loops(src, dst, n_nodes, pad_to=pad_edges_to)
    dev = gen.device
    batch = {
        "feats": torch.randn((n_nodes, d_feat), generator=gen, device=dev, dtype=torch.float32),
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": mask,
        "labels": _randint(gen, 0, n_classes, (n_graphs or n_nodes,)),
    }
    if n_graphs:
        batch["graph_ids"] = (torch.arange(n_nodes, device=dev) * n_graphs // n_nodes).to(torch.int32)
    else:
        batch["label_mask"] = torch.ones((n_nodes,), dtype=torch.bool, device=dev)
    return batch


def recsys_batch(gen: torch.Generator, cfg: RecsysConfig, batch: int, *, train: bool = True) -> dict:
    """The reference's batch of ``cfg.interaction``'s model: int32 ids in
    each table's range, fp32 masks and labels (Bernoulli 0.3)."""
    dev = gen.device
    kind = cfg.interaction
    if kind == "fm-2way":
        sizes = torch.tensor(cfg.vocab_sizes, dtype=torch.int64, device=dev)
        ids = torch.randint(0, 1 << 30, (batch, cfg.n_sparse), generator=gen, device=dev) % sizes[None, :]
        out = {"ids": ids.to(torch.int32)}
    elif kind == "augru":
        v_item, v_cate, v_user = cfg.vocab_sizes
        lengths = _randint(gen, 1, cfg.seq_len + 1, (batch,))
        out = {
            "profile_ids": _randint(gen, 0, v_user, (batch, N_PROFILE)),
            "seq_items": _randint(gen, 0, v_item, (batch, cfg.seq_len)),
            "seq_cates": _randint(gen, 0, v_cate, (batch, cfg.seq_len)),
            "seq_mask": (torch.arange(cfg.seq_len, device=dev)[None, :] < lengths[:, None]).float(),
            "target_item": _randint(gen, 0, v_item, (batch,)),
            "target_cate": _randint(gen, 0, v_cate, (batch,)),
        }
    elif kind == "bidir-seq":
        out = {
            "seq": _randint(gen, 0, cfg.item_vocab, (batch, cfg.seq_len)),
            "pad_mask": torch.ones((batch, cfg.seq_len), dtype=torch.float32, device=dev),
        }
        if train:
            n_mask = max(1, cfg.seq_len // 10)
            out.update(
                masked_pos=_randint(gen, 0, cfg.seq_len, (batch, n_mask)),
                masked_ids=_randint(gen, 0, cfg.item_vocab, (batch, n_mask)),
                neg_ids=_randint(gen, 0, cfg.item_vocab, (min(1024, cfg.item_vocab),)),
            )
        else:
            out["target_item"] = _randint(gen, 0, cfg.item_vocab, (batch,))
    elif kind == "transformer-seq":
        out = {
            "seq_items": _randint(gen, 0, cfg.item_vocab, (batch, cfg.seq_len)),
            "target_item": _randint(gen, 0, cfg.item_vocab, (batch,)),
        }
    else:
        raise KeyError(kind)
    if train and kind != "bidir-seq":
        out["label"] = (torch.rand((batch,), generator=gen, device=dev) < 0.3).float()
    return out
