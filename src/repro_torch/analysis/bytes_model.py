"""Analytic per-device HBM-traffic model (the roofline memory term).

A copy of ``repro/analysis/bytes_model.py`` with identical formulas, so
the port's dry run and the reference's give the same memory term and the
same microbatch choice for every cell.  The coefficients (traversals of
each tensor per step, written next to each term) model the reference's
target: XLA's TPU fusion of elementwise chains into neighbouring matmuls,
bf16 activations and weights, fp32 scores and optimizer state.  They are
a model of that program, not of the card's: what the card's kernels move
is measured on the card (``chip_smoke.py``'s kernel table, the dry run's
``MemTracker`` peak beside :func:`lm_peak_memory`), not derived here.

All formulas return BYTES PER DEVICE PER STEP.
"""
from __future__ import annotations

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, ShapeCell


def _lm_weight_shards(cfg: LMConfig, ms: int, bs: int) -> int:
    return ms * (bs if cfg.fsdp else 1)


def lm_bytes(cfg: LMConfig, cell: ShapeCell, *, ms: int, bs: int) -> float:
    """ms = model-axis shards, bs = batch-axis shards."""
    p_total = cfg.params_billions() * 1e9
    shards_w = _lm_weight_shards(cfg, ms, bs)
    w_dev = 2.0 * p_total / shards_w                  # bf16 weights
    g_dev = 2.0 * p_total / shards_w                  # bf16 grads
    adafactor = cfg.params_billions() > 100
    o_dev = (4.0 if adafactor else 12.0) * p_total / shards_w

    seq = cell.dim("seq_len")
    gb = cell.dim("global_batch")
    L, D, H, KV, hd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.vocab)
    if cell.kind == "train":
        tokens_dev = gb * seq / bs
        # weights: fwd read + remat read + bwd read; grads write+read;
        # optimizer state read+write
        weights = 3 * w_dev + 2 * g_dev + 2 * o_dev
        # residual-stream & projection activations: ~16 traversals of a
        # (tokens, D) bf16 tensor per layer, TP-sharded (/ms)
        resid = L * 16 * tokens_dev * D * 2 / ms
        # attention scores: the chunked online-softmax materialises the
        # (B, H/ms, S, S) fp32 score field; ~6 traversals across
        # fwd + remat + bwd (write+read each).  THE dominant term at 4k+ —
        # a Pallas flash kernel would keep it in VMEM (see §Perf).
        b_loc = gb / bs
        scores = L * 6 * b_loc * (H / ms) * seq * seq * 4
        if cfg.moe_experts:
            # dispatched activations (tokens·top_k·cf·D) ~6 traversals
            disp = L * 6 * tokens_dev * cfg.moe_top_k * cfg.capacity_factor * D * 2
            resid += disp
        logits = 4 * tokens_dev * (V / ms) * 4        # fp32 logits + softmax bwd
        return weights + resid + scores + logits

    if cell.kind == "prefill":
        tokens_dev = gb * seq / bs
        weights = 1 * w_dev
        resid = L * 8 * tokens_dev * D * 2 / ms
        b_loc = gb / bs
        scores = L * 2 * b_loc * (H / ms) * seq * seq * 4
        return weights + resid + scores

    # decode: weight-read bound + KV cache stream
    b_loc = gb / bs
    weights = 1 * w_dev
    cache = L * b_loc * (seq / ms) * KV * hd * 2 * 2  # K and V, bf16, read
    logits = b_loc * (V / ms) * 4
    return weights + cache + logits


def lm_peak_memory(cfg: LMConfig, cell: ShapeCell, *, ms: int, bs: int, microbatches: int = 1) -> float:
    """Analytic per-device PEAK HBM bytes — the TPU 'fits in 16 GB' check.

    Needed because the CPU backend's memory_analysis() stores bf16 buffers
    f32-legalised (≈2× inflation, verified on the deepseek dump).
    Terms: params + grads + optimizer state + saved residual carries
    (seq-sharded bf16) + the largest transient (attention chunk carries /
    MoE dispatch / logits).
    """
    p_total = cfg.params_billions() * 1e9
    shards_w = _lm_weight_shards(cfg, ms, bs)
    adafactor = cfg.params_billions() > 100
    params = 2.0 * p_total / shards_w
    seq = cell.dim("seq_len")
    gb = cell.dim("global_batch")
    L, D, H, KV, hd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.vocab)
    b_loc = gb / bs
    tokens_dev = gb * seq / bs

    if cell.kind == "train":
        mb = max(1, microbatches)
        tokens_mb = tokens_dev / mb
        b_mb = b_loc / mb
        grads = params
        opt = (4.0 if adafactor else 12.0) * p_total / shards_w
        # saved residual carries live per microbatch (accumulation scan
        # backprops each microbatch inside its own iteration)
        carries = L * tokens_mb * D * 2 / ms           # bf16, seq-sharded
        # largest transients (live one layer at a time under remat):
        n_chunks = max(1, seq // cfg.attn_chunk)
        attn_carry = n_chunks * b_mb * (H / ms) * seq * (hd + 2) * 4
        moe = 0.0
        if cfg.moe_experts:
            slots = tokens_mb * cfg.moe_top_k * cfg.capacity_factor
            ep = cfg.moe_experts % ms == 0
            if ep:  # dispatched activations expert-sharded over model
                moe = slots * (4 * D + 4 * cfg.d_ff) / ms
            else:   # expert-TP: xd/y replicated over model, h ff-sharded
                moe = slots * (4 * D + 4 * cfg.d_ff / ms)
        logits = tokens_mb * (V / ms) * 4 * 2
        transient = max(attn_carry, moe, logits)
        return params + grads + opt + carries + transient
    if cell.kind == "prefill":
        act = 4 * tokens_dev * D * 2 / ms + b_loc * (H / ms) * seq * cfg.attn_chunk * 4
        return params + act
    cache = L * b_loc * (seq / ms) * KV * hd * 2 * 2
    return params + cache + b_loc * (V / ms) * 4


def gnn_bytes(cfg: GNNConfig, dims: dict, *, n_shards: int) -> float:
    """Edge-parallel GAT train step; nodes replicated."""
    n, e, f = dims["n"], dims["e_total"], dims["d_feat"]
    mid = cfg.n_heads * cfg.d_hidden
    e_dev = e / n_shards
    # features: every device streams the full node table fwd+bwd
    feats = 2 * n * f * 4
    # edge gathers/scatters: gather h[src] + scatter msg, fwd+bwd ≈ 6
    # traversals of an (E/P, mid) fp32 tensor (both layers)
    edges = 2 * 6 * e_dev * mid * 4
    # node partials + psum buffers: ~4 traversals of (N, mid) fp32 per layer
    nodes = 2 * 4 * n * mid * 4
    return feats + edges + nodes


def recsys_bytes(cfg: RecsysConfig, cell: ShapeCell, *, ms: int, bs: int) -> float:
    d = cfg.embed_dim
    b = cell.dim("batch")
    b_dev = b / bs
    if cfg.interaction == "fm-2way":
        rows = cfg.n_sparse
        v_total = sum(cfg.vocab_sizes)
    elif cfg.interaction == "augru":
        rows = 2 * cfg.seq_len + rec_n_profile() + 2
        v_total = sum(cfg.vocab_sizes)
    else:
        rows = cfg.seq_len + 1
        v_total = cfg.item_vocab

    gathers = b_dev * rows * d * 4 * (2 if cell.kind == "train" else 1)
    tower = b_dev * _tower_width(cfg) * 4 * (6 if cell.kind == "train" else 2)
    table_opt = 0.0
    if cell.kind == "train":
        # DENSE AdamW over the whole sharded table: every row's m/v/master
        # read+written each step — the honest cost of a non-lazy embedding
        # optimizer (see §Perf for the lazy-optimizer iteration)
        table_opt = (v_total * d / ms) * (4 + 12) * 2
    retrieval = 0.0
    if cell.kind == "retrieval":
        retrieval = cell.dim("n_candidates") * d * 4 / (ms * bs)
    return gathers + tower + table_opt + retrieval


def _tower_width(cfg: RecsysConfig) -> float:
    if cfg.interaction == "fm-2way":
        return cfg.n_sparse * cfg.embed_dim
    if cfg.interaction == "augru":
        per_t = 2 * cfg.embed_dim + 3 * cfg.gru_dim
        return cfg.seq_len * per_t * 4
    t = cfg.seq_len + (1 if cfg.interaction == "transformer-seq" else 0)
    return t * cfg.embed_dim * 8 * cfg.n_blocks


def rec_n_profile() -> int:
    from repro_torch.models.recsys import N_PROFILE

    return N_PROFILE
