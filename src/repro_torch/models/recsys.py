"""Recsys model zoo: FM, DIEN (GRU + AUGRU), BERT4Rec, BST.

Counterpart of ``repro/models/recsys.py``.  Common anatomy: huge
row-sharded embedding tables (``models.embeddings``) → feature-interaction
tower → small replicated MLP:

  fm        pairwise ⟨vᵢ,vⱼ⟩ via the O(nk) sum-square trick (Rendle ICDM'10)
  augru     DIEN: GRU interest extraction + attention-scaled AUGRU evolution
  bidir-seq BERT4Rec: bidirectional encoder, masked-item sampled softmax
  transformer-seq  BST: behaviours+target through one transformer block → MLP

Every model implements init / param_specs / loss (train) / score
(pointwise serving) / query_embedding / candidate_table (for
``retrieval_cand``, which shares ``models.retrieval``'s top-k); ``get_model``
returns the six in the reference's order.

Parameters live in a :class:`~repro_torch.models.param_tree.ParamTree`
under the reference's tree paths (``embed``, ``mlp.0.w``, ``gru.wx``,
``blocks.1.wqkv``).  ``*_init(gen, cfg)`` draws the reference's
distributions on ``gen``'s device (``jax.random``'s numbers cannot be
redrawn; tests carry the reference's values across with
``interop.recsys_params_from_reference``); ``gen=None`` builds on the meta
device, shapes only, which is what ``*_param_specs`` reads (the
reference's ``jax.eval_shape``): no table is allocated.  Every table
lookup names its global vocab to ``sharded_lookup``, so under rules with
a "model" axis a rank may hold its block of the table's rows.

The GRUs are Python loops over time, as the reference's ``lax.scan``
steps (each step projects its own input, so a (B, T, 3H) projection of
every step is never held).  Every entry point runs under
``device.lm_precision`` (no TF32 in its fp32 products); the reference's
fp32 upcasts are ``device.widen``, so a float64 copy of a model is a
float64 oracle.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import lm_precision, widen
from repro_torch.models.embeddings import embedding_bag, sharded_lookup
from repro_torch.models.param_tree import ParamTree, spec_tree
from repro_torch.sharding.axes import MeshRules, current_rules

__all__ = ["N_PROFILE", "gru_scan", "augru_scan", "get_model",
           "fm_init", "fm_param_specs", "fm_score", "fm_loss", "fm_query_embedding", "fm_candidate_table",
           "dien_init", "dien_param_specs", "dien_score", "dien_loss", "dien_query_embedding",
           "dien_candidate_table",
           "bert4rec_init", "bert4rec_param_specs", "bert4rec_encode", "bert4rec_loss", "bert4rec_score",
           "bert4rec_query_embedding", "bert4rec_candidate_table",
           "bst_init", "bst_param_specs", "bst_score", "bst_loss", "bst_query_embedding",
           "bst_candidate_table"]

_META = torch.device("meta")


def _dense(gen, shape, dtype=torch.float32, scale=None):
    scale = scale if scale is not None else shape[0] ** -0.5
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=_META)
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device) * scale


def _zeros(gen, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=_META if gen is None else gen.device)


def _mlp_init(gen, dims, dtype=torch.float32):
    return [{"w": _dense(gen, (dims[i], dims[i + 1]), dtype), "b": _zeros(gen, (dims[i + 1],), dtype)}
            for i in range(len(dims) - 1)]


def _mlp_apply(layers, x, final_act=False):
    for i, layer in enumerate(layers):
        x = x @ layer.w + layer.b
        if i < len(layers) - 1 or final_act:
            x = F.relu(x)
    return x


def _bce(logit, label):
    logit = widen(logit)
    return torch.mean(torch.clamp(logit, min=0) - logit * label + torch.log1p(torch.exp(-torch.abs(logit))))


def _specs_like(init_fn, cfg, rules: MeshRules, sharded_tables: tuple[str, ...]):
    """Replicated specs for everything except row-sharded embedding tables
    (the parameters built on the meta device: shapes only)."""
    return spec_tree(init_fn(None, cfg), rules, sharded_tables)


# ===========================================================================
# FM — factorization machine over 39 hashed categorical fields
# ===========================================================================


def _fm_offsets(cfg: RecsysConfig, device) -> torch.Tensor:
    sizes = torch.tensor(cfg.vocab_sizes, dtype=torch.int32, device=device)
    return torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0, dtype=torch.int32)[:-1]])


def fm_init(gen: torch.Generator | None, cfg: RecsysConfig) -> ParamTree:
    total = sum(cfg.vocab_sizes)
    return ParamTree({
        "embed": _dense(gen, (total, cfg.embed_dim), scale=0.01),
        "linear": _dense(gen, (total, 1), scale=0.01),
        "bias": _zeros(gen, ()),
    })


def fm_param_specs(cfg: RecsysConfig, rules: MeshRules) -> dict:
    return {"embed": rules.spec("model", None), "linear": rules.spec("model", None), "bias": rules.spec()}


def _fm_ids(batch, cfg):
    ids = batch["ids"]
    return ids + _fm_offsets(cfg, ids.device)[None, :]               # (B, F) global ids, int32


@lm_precision()
def fm_score(params: ParamTree, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    ids = _fm_ids(batch, cfg)
    total = sum(cfg.vocab_sizes)
    emb = sharded_lookup(params.embed, ids, vocab=total)            # (B, F, D)
    lin = sharded_lookup(params.linear, ids, vocab=total)[..., 0]   # (B, F)
    s = torch.sum(emb, dim=1)                                       # (B, D)
    s2 = torch.sum(emb * emb, dim=1)
    pairwise = 0.5 * torch.sum(s * s - s2, dim=-1)                  # sum-square trick
    return params.bias + torch.sum(lin, dim=1) + pairwise


@lm_precision()
def fm_loss(params, batch, cfg):
    loss = _bce(fm_score(params, batch, cfg), batch["label"])
    return loss, {"bce_loss": loss}


@lm_precision()
def fm_query_embedding(params, batch, cfg):
    """User-side vector = sum of all non-target field embeddings."""
    ids = _fm_ids(batch, cfg)
    emb = sharded_lookup(params.embed, ids[:, :-1], vocab=sum(cfg.vocab_sizes))  # exclude item field
    return torch.sum(emb, dim=1)                                                 # (B, D)


def fm_candidate_table(params, cfg, n_candidates):
    off = sum(cfg.vocab_sizes[:-1])                      # item = last field
    return params.embed[off:off + n_candidates]


# ===========================================================================
# DIEN — GRU interest extraction + AUGRU interest evolution
# ===========================================================================


def _gru_init(gen, d_in, d_h):
    return {"wx": _dense(gen, (d_in, 3 * d_h)), "wh": _dense(gen, (d_h, 3 * d_h)),
            "b": _zeros(gen, (3 * d_h,))}


def _gru_gates(w, x_t, h):
    gx = x_t @ w.wx + w.b
    gh = h @ w.wh
    xr, xz, xn = torch.chunk(gx, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return z, n


def _scan(w, xs, h0, mask, update, att=None):
    """The recurrence over T steps; a padding step (mask 0) keeps the state."""
    ms = torch.ones(xs.shape[:2], dtype=xs.dtype, device=xs.device) if mask is None else mask
    h, ys = h0, []
    for t in range(xs.shape[1]):
        z, n = _gru_gates(w, xs[:, t], h)
        h_new = update(h, z if att is None else z * att[:, t, None], n)
        h = torch.where(ms[:, t, None] > 0, h_new, h)
        ys.append(h)
    return h, torch.stack(ys, dim=1)


def gru_scan(w, xs, h0, mask=None, *, unroll=False):
    """xs: (B, T, D) → (h_T, outputs (B, T, H)).  mask freezes state on padding.
    ``unroll`` is inert (the loop is Python's)."""
    return _scan(w, xs, h0, mask, lambda h, z, n: (1.0 - z) * n + z * h)


def augru_scan(w, xs, att, h0, mask=None, *, unroll=False):
    """AUGRU (DIEN eq. 5): update gate scaled by attention score a_t."""
    return _scan(w, xs, h0, mask, lambda h, z, n: (1.0 - z) * h + z * n, att=att)


N_PROFILE = 5  # multi-hot user-profile slots (bagged)


def dien_init(gen: torch.Generator | None, cfg: RecsysConfig) -> ParamTree:
    d = cfg.embed_dim
    d_seq = 2 * d  # item ⊕ cate
    gh = cfg.gru_dim
    v_item, v_cate, v_user = cfg.vocab_sizes
    feat_dim = d + 2 * d + gh + d_seq  # profile + target + final interest + seq-sum
    return ParamTree({
        "item": _dense(gen, (v_item, d), scale=0.01),
        "cate": _dense(gen, (v_cate, d), scale=0.01),
        "user": _dense(gen, (v_user, d), scale=0.01),
        "gru": _gru_init(gen, d_seq, gh),
        "augru": _gru_init(gen, d_seq, gh),
        "att_w": _dense(gen, (gh, d_seq)),
        "aux_w": _dense(gen, (gh, d_seq)),
        "mlp": _mlp_init(gen, (feat_dim, *cfg.mlp_dims, 1)),
    })


def dien_param_specs(cfg: RecsysConfig, rules: MeshRules) -> dict:
    return _specs_like(dien_init, cfg, rules, ("item", "cate", "user"))


def _dien_seq(params, batch, cfg):
    v_item, v_cate, _ = cfg.vocab_sizes
    return torch.cat([sharded_lookup(params.item, batch["seq_items"], vocab=v_item),
                      sharded_lookup(params.cate, batch["seq_cates"], vocab=v_cate)], dim=-1)  # (B, T, 2D)


def _batch_group():
    """The process group of the batch's rows under the current rules, or
    None when the batch is whole (no rules, no mesh, no batch axes)."""
    rules = current_rules()
    if rules.mesh is None or not rules.batch:
        return None
    from repro_torch.core.distributed import batch_group

    return batch_group(rules.mesh, rules.batch)


def _batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch's ranks (the reference's sum over a
    batch-sharded axis); its backward sums too, the exact adjoint, since
    every rank's loss uses the total."""
    group = _batch_group()
    return t if group is None else dist_nn.all_reduce(t, group=group)


def _roll_batch(x: torch.Tensor) -> torch.Tensor:
    """``roll(x, 1)`` along the batch: each row takes the one before it, the
    first the last.  Under rules with batch axes and a mesh, ``x`` is this
    rank's block of the batch's rows and the roll is the global one: the
    block's first row is the previous rank's last (the reference's
    ``jnp.roll`` over a batch-sharded axis)."""
    group = _batch_group()
    if group is None:
        return torch.roll(x, 1, dims=0)
    from repro_torch.sharding.collectives import all_gather_rows

    lasts = all_gather_rows(x[-1:], group)  # every rank's last row, in rank order
    return torch.cat([lasts[dist.get_rank(group) - 1][None], x[:-1]])


def _dien_features(params, batch, cfg):
    v_item, v_cate, v_user = cfg.vocab_sizes
    seq_e = _dien_seq(params, batch, cfg)
    mask = batch["seq_mask"].float()
    tgt = torch.cat([sharded_lookup(params.item, batch["target_item"], vocab=v_item),
                     sharded_lookup(params.cate, batch["target_cate"], vocab=v_cate)], dim=-1)  # (B, 2D)
    b = seq_e.shape[0]
    prof_ids = batch["profile_ids"]  # (B, P) multi-hot → bag-mean
    prof = embedding_bag(params.user, prof_ids.reshape(-1),
                         torch.arange(b, device=prof_ids.device).repeat_interleave(prof_ids.shape[1]),
                         num_segments=b, combiner="mean", vocab=v_user)

    h0 = seq_e.new_zeros((b, cfg.gru_dim))
    _, interest = gru_scan(params.gru, seq_e, h0, mask=mask)         # (B, T, GH)

    # DIEN auxiliary loss: interest state at t should predict behaviour t+1
    # against an in-batch negative (rolled sequence).
    nxt = seq_e[:, 1:]
    neg = _roll_batch(seq_e[:, 1:])
    pred = interest[:, :-1] @ params.aux_w                           # (B, T-1, 2D)
    m = mask[:, 1:]
    pos_logit = torch.sum(pred * nxt, -1)
    neg_logit = torch.sum(pred * neg, -1)
    zero = torch.zeros_like(pos_logit)
    aux = (_batch_sum(torch.sum((torch.logaddexp(zero, -pos_logit) + torch.logaddexp(zero, neg_logit)) * m))
           / torch.clamp(_batch_sum(torch.sum(m)), min=1.0))

    # attention of target on interest states → AUGRU
    att_logits = torch.einsum("btg,bg->bt", interest, tgt @ params.att_w.T)
    att_logits = torch.where(mask > 0, att_logits, -1e30)
    att = torch.softmax(att_logits, dim=-1)
    h_t, _ = augru_scan(params.augru, seq_e, att, h0, mask=mask)

    feats = torch.cat([prof, tgt, h_t, torch.sum(seq_e * mask[..., None], 1)], dim=-1)
    return feats, aux


@lm_precision()
def dien_score(params, batch, cfg):
    feats, _ = _dien_features(params, batch, cfg)
    return _mlp_apply(params.mlp, feats)[:, 0]


@lm_precision()
def dien_loss(params, batch, cfg):
    feats, aux = _dien_features(params, batch, cfg)
    logit = _mlp_apply(params.mlp, feats)[:, 0]
    bce = _bce(logit, batch["label"])
    loss = bce + 0.5 * aux
    return loss, {"bce_loss": bce, "aux_loss": aux}


@lm_precision()
def dien_query_embedding(params, batch, cfg):
    """Interest summary projected to item space for retrieval."""
    seq_e = _dien_seq(params, batch, cfg)
    mask = batch["seq_mask"].float()
    h0 = seq_e.new_zeros((seq_e.shape[0], cfg.gru_dim))
    h_t, _ = gru_scan(params.gru, seq_e, h0, mask=mask)
    return (h_t @ params.aux_w)[:, :cfg.embed_dim]  # item-side half


def dien_candidate_table(params, cfg, n_candidates):
    return params.item[:n_candidates]


# ===========================================================================
# Small bidirectional transformer encoder (BERT4Rec / BST share it)
# ===========================================================================


def _enc_block_init(gen, d, n_heads, d_ff):
    return {
        "ln1": _zeros(gen, (d,)),
        "ln2": _zeros(gen, (d,)),
        "wqkv": _dense(gen, (d, 3 * d)),
        "wo": _dense(gen, (d, d)),
        "w1": _dense(gen, (d, d_ff)),
        "b1": _zeros(gen, (d_ff,)),
        "w2": _dense(gen, (d_ff, d)),
        "b2": _zeros(gen, (d,)),
    }


def _layernorm(x, scale, eps=1e-6):
    """Population variance, eps 1e-6, scale ``1 + scale``, in fp32 (not nn.LayerNorm)."""
    x32 = widen(x)
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.var(x32, -1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def _enc_block(x, bp, n_heads, pad_mask=None):
    """Full (bidirectional) attention block — seq ≤ a few hundred, dense scores."""
    b, t, d = x.shape
    hd = d // n_heads
    h = _layernorm(x, bp.ln1)
    q, k, v = torch.chunk(h @ bp.wqkv, 3, dim=-1)
    q = q.reshape(b, t, n_heads, hd).transpose(1, 2)                 # (B, H, T, hd)
    k = k.reshape(b, t, n_heads, hd).transpose(1, 2)
    v = v.reshape(b, t, n_heads, hd).transpose(1, 2)
    s = (widen(q) @ widen(k).transpose(-1, -2)) / (hd ** 0.5)       # (B, H, Tq, Tk)
    if pad_mask is not None:
        s = torch.where(pad_mask[:, None, None, :] > 0, s, -1e30)
    a = torch.softmax(s, dim=-1)
    o = (a @ widen(v)).transpose(1, 2).reshape(b, t, d)
    x = x + (o.to(x.dtype) @ bp.wo)
    h = _layernorm(x, bp.ln2)
    h = F.gelu(h @ bp.w1 + bp.b1, approximate="tanh") @ bp.w2 + bp.b2  # jax.nn.gelu's default
    return x + h


# ===========================================================================
# BERT4Rec
# ===========================================================================


def bert4rec_init(gen: torch.Generator | None, cfg: RecsysConfig) -> ParamTree:
    d = cfg.embed_dim
    return ParamTree({
        "item": _dense(gen, (cfg.item_vocab, d), scale=0.02),
        "pos": _dense(gen, (cfg.seq_len, d), scale=0.02),
        "out_b": _zeros(gen, ()),
        "blocks": [_enc_block_init(gen, d, cfg.n_heads, 4 * d) for _ in range(cfg.n_blocks)],
        "final_ln": _zeros(gen, (d,)),
    })


def bert4rec_param_specs(cfg: RecsysConfig, rules: MeshRules) -> dict:
    return _specs_like(bert4rec_init, cfg, rules, ("item",))


@lm_precision()
def bert4rec_encode(params, batch, cfg):
    x = sharded_lookup(params.item, batch["seq"], vocab=cfg.item_vocab) + params.pos[None]
    pm = batch.get("pad_mask")
    for bp in params.blocks:
        x = _enc_block(x, bp, cfg.n_heads, pad_mask=pm)
    return _layernorm(x, params.final_ln)


@lm_precision()
def bert4rec_loss(params, batch, cfg):
    """Masked-item prediction with sampled softmax (1 pos + shared negatives)."""
    h = bert4rec_encode(params, batch, cfg)                                       # (B, T, D)
    pos = batch["masked_pos"].long()
    hm = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))           # (B, M, D)
    pos_e = sharded_lookup(params.item, batch["masked_ids"], vocab=cfg.item_vocab)  # (B, M, D)
    neg_e = sharded_lookup(params.item, batch["neg_ids"], vocab=cfg.item_vocab)     # (N, D)
    logit_pos = torch.sum(hm * pos_e, -1, keepdim=True)                           # (B, M, 1)
    logit_neg = hm @ neg_e.T                                                      # (B, M, N)
    logits = widen(torch.cat([logit_pos, logit_neg], -1))
    logp = torch.log_softmax(logits + params.out_b, dim=-1)
    loss = -torch.mean(logp[..., 0])
    return loss, {"sampled_ce": loss}


@lm_precision()
def bert4rec_score(params, batch, cfg):
    h_last = bert4rec_encode(params, batch, cfg)[:, -1]
    tgt = sharded_lookup(params.item, batch["target_item"], vocab=cfg.item_vocab)
    return torch.sum(h_last * tgt, -1)


@lm_precision()
def bert4rec_query_embedding(params, batch, cfg):
    return bert4rec_encode(params, batch, cfg)[:, -1]


def bert4rec_candidate_table(params, cfg, n_candidates):
    return params.item[:n_candidates]


# ===========================================================================
# BST — Behavior Sequence Transformer
# ===========================================================================


def bst_init(gen: torch.Generator | None, cfg: RecsysConfig) -> ParamTree:
    d = cfg.embed_dim
    t = cfg.seq_len + 1  # behaviours + target
    return ParamTree({
        "item": _dense(gen, (cfg.item_vocab, d), scale=0.02),
        "pos": _dense(gen, (t, d), scale=0.02),
        "blocks": [_enc_block_init(gen, d, cfg.n_heads, 4 * d) for _ in range(cfg.n_blocks)],
        "mlp": _mlp_init(gen, (t * d, *cfg.mlp_dims, 1)),
    })


def bst_param_specs(cfg: RecsysConfig, rules: MeshRules) -> dict:
    return _specs_like(bst_init, cfg, rules, ("item",))


def _bst_encode(params, seq, cfg):
    x = sharded_lookup(params.item, seq, vocab=cfg.item_vocab) + params.pos[None]
    for bp in params.blocks:
        x = _enc_block(x, bp, cfg.n_heads)
    return x


@lm_precision()
def bst_score(params, batch, cfg):
    seq = torch.cat([batch["seq_items"], batch["target_item"][:, None]], dim=1)
    x = _bst_encode(params, seq, cfg)
    return _mlp_apply(params.mlp, x.reshape(x.shape[0], -1))[:, 0]


@lm_precision()
def bst_loss(params, batch, cfg):
    loss = _bce(bst_score(params, batch, cfg), batch["label"])
    return loss, {"bce_loss": loss}


@lm_precision()
def bst_query_embedding(params, batch, cfg):
    seq = torch.cat([batch["seq_items"], torch.zeros_like(batch["seq_items"][:, :1])], dim=1)
    return torch.mean(_bst_encode(params, seq, cfg), dim=1)


def bst_candidate_table(params, cfg, n_candidates):
    return params.item[:n_candidates]


# ===========================================================================
# Dispatch
# ===========================================================================

_MODELS = {
    "fm-2way": (fm_init, fm_param_specs, fm_loss, fm_score, fm_query_embedding, fm_candidate_table),
    "augru": (dien_init, dien_param_specs, dien_loss, dien_score, dien_query_embedding, dien_candidate_table),
    "bidir-seq": (bert4rec_init, bert4rec_param_specs, bert4rec_loss, bert4rec_score, bert4rec_query_embedding,
                  bert4rec_candidate_table),
    "transformer-seq": (bst_init, bst_param_specs, bst_loss, bst_score, bst_query_embedding, bst_candidate_table),
}


def get_model(cfg: RecsysConfig):
    """Returns (init, param_specs, loss, score, query_embedding, candidates)."""
    return _MODELS[cfg.interaction]
