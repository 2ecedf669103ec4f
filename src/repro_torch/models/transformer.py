"""Decoder-only transformer LM of the port: training, prefill and cached decode.

Counterpart of ``repro/models/transformer.py`` for the dense and MoE LMs.
:class:`TransformerLM` holds the reference's parameter dict under the same
names and shapes — ``embed``, ``out``, ``final_norm`` and
``layers.{ln1, ln2, wq, wk, wv, wo, wi_gate, wi_up, wo_ffn}`` stacked on a
leading L axis; an MoE config adds ``layers.router`` (L, D, E), kept in
fp32 whatever ``cfg.dtype`` is, and stacks the FFN weights per expert
(L, E, D, F) / (L, E, F, D) — so weights carry across name for name
(``repro_torch.interop.lm_params_from_reference``).  The functions keep the
reference's names and signatures, with the module in place of the params
pytree.

Every parameter takes a gradient.  ``lm_forward``, ``lm_logits`` and
``lm_loss`` run under the caller's grad mode; ``prefill_step`` and
``serve_step`` never record one.  The layer stack is a Python loop over L
in place of ``lax.scan``: each stacked parameter is taken apart once per
forward (``unbind(0)``, whose backward writes one stacked gradient, where
indexing per layer would write a full-size zero tensor per layer), and
with ``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` when a
gradient is recorded — the reference's ``jax.checkpoint(...,
nothing_saveable)``: only the layer inputs are kept, and the backward runs
the layer's forward again.

The KV cache is updated in place (the reference returns a new one).  On the
card every layer's attention in a forward pass runs kernel 4, the
hand-written flash kernel (see ``models.layers.causal_attention``; under
autograd its backward recomputes the plain chunk body); decode attention
is plain PyTorch, as the reference's is plain JAX.  An MoE layer's FFN is
GShard ``layers.moe_block`` in the forward pass (its aux loss averaged over
the layers) and ``layers.moe_dense_decode`` in decode.

Sharding: ``lm_rules``, ``lm_param_specs``, ``zero1_opt_specs`` and
``kv_cache_specs`` are the reference's, spec for spec (``sharding.axes``).
With the parameters DTensors placed by ``lm_param_specs`` (``axes.
distribute_module``) and the rules active (``axes.use_rules``), the same
functions run on the mesh: Megatron TP over "model", a sequence-parallel
residual stream, FSDP weights gathered layer by layer, MoE experts (or
FFN columns) over "model", the vocab-sharded cross entropy combined by a
max and two sums, and split-KV decode over the cache's S blocks.  The
reference's ``shard(...)`` constraints are redistributions there and no-ops
on plain tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import LMConfig
from repro_torch.device import as_tensor, lm_precision, resolve_device
from repro_torch.models import layers as L
from repro_torch.sharding.axes import MeshRules, block_of, current_rules, replicated, shard, use_rules

__all__ = ["TransformerLM", "init_lm_params", "lm_forward", "lm_logits", "lm_loss", "prefill_step",
           "KVCache", "init_kv_cache", "serve_step", "lm_rules", "zero1_opt_specs", "lm_param_specs",
           "kv_cache_specs", "nested_shapes"]


def _param_shapes(cfg: LMConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape, in the reference's order."""
    d, hd = cfg.d_model, cfg.head_dim
    nl, h, kv, f, v = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab
    shapes = {
        "embed": (v, d), "out": (d, v), "final_norm": (d,),
        "layers.ln1": (nl, d), "layers.ln2": (nl, d),
        "layers.wq": (nl, d, h * hd), "layers.wk": (nl, d, kv * hd),
        "layers.wv": (nl, d, kv * hd), "layers.wo": (nl, h * hd, d),
    }
    if cfg.moe_experts:
        e = cfg.moe_experts
        shapes.update({"layers.router": (nl, d, e), "layers.wi_gate": (nl, e, d, f),
                       "layers.wi_up": (nl, e, d, f), "layers.wo_ffn": (nl, e, f, d)})
    else:
        shapes.update({"layers.wi_gate": (nl, d, f), "layers.wi_up": (nl, d, f),
                       "layers.wo_ffn": (nl, f, d)})
    return shapes


class TransformerLM(nn.Module):
    """A decoder-only LM's parameters (zeros until filled) on one device:
    ``cuda`` unless ``device`` says otherwise.  Every parameter is in
    ``cfg.dtype`` but an MoE router, which is fp32 as the reference's.
    Every parameter takes a gradient."""

    def __init__(self, cfg: LMConfig, *, device=None):
        super().__init__()
        dev = resolve_device(None, device)
        self.cfg = cfg

        def param(shape, dtype=cfg.dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev))

        shapes = _param_shapes(cfg)
        self.embed = param(shapes["embed"])
        self.out = param(shapes["out"])
        self.final_norm = param(shapes["final_norm"])
        self.layers = nn.ParameterDict({
            n.removeprefix("layers."): param(shape, torch.float32 if n == "layers.router" else cfg.dtype)
            for n, shape in shapes.items() if n.startswith("layers.")})


def init_lm_params(gen: torch.Generator, cfg: LMConfig) -> TransformerLM:
    """A model on ``gen``'s device with the reference's initial values'
    distributions: embed N(0, 1); every matrix N(0, 1/fan_in) with fan_in
    its second-to-last dim (the router's is D); norms 0.  Drawn in fp32,
    stored in each parameter's dtype.  ``jax.random``'s numbers themselves
    cannot be redrawn: tests carry the reference's values across instead."""
    model = TransformerLM(cfg, device=gen.device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("final_norm", "layers.ln1", "layers.ln2"):
                continue
            scale = 1.0 if name == "embed" else p.shape[-2] ** -0.5
            p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32,
                                device=gen.device).mul_(scale))
    return model


# ---------------------------------------------------------------------------
# Sharding specs (the reference's, as tuples)
# ---------------------------------------------------------------------------


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def lm_rules(cfg: LMConfig, mesh) -> MeshRules:
    """The reference's rules: Megatron TP over "model" with batch over
    ("pod", "data") and FSDP there for ``cfg.fsdp``; with
    ``model_axis_role == "batch"`` every axis is a batch axis (ZeRO-1, or
    ZeRO-3 with ``cfg.fsdp``)."""
    axes = tuple(mesh.mesh_dim_names)
    if cfg.model_axis_role == "batch":
        batch = tuple(a for a in ("pod", "data", "model") if a in axes)
        return MeshRules(batch=batch, model=None, fsdp=batch if cfg.fsdp else (), mesh=mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    model = "model" if "model" in axes else None
    n_model = _axis_sizes(mesh).get("model", 1)
    return MeshRules(batch=batch, model=model, fsdp=batch if cfg.fsdp else (), mesh=mesh,
                     shard_kv=(cfg.n_kv_heads % n_model == 0),
                     shard_expert=(cfg.moe_experts % n_model == 0) if cfg.moe_experts else False)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def zero1_opt_specs(param_specs: dict, params_shapes: dict, mesh) -> dict:
    """ZeRO-1: optimizer state sharded over ALL mesh axes on the last dim
    when the mesh's size divides it (replicated otherwise); the parameters
    stay replicated.  ``params_shapes`` nests like ``param_specs``, each
    leaf a shape or a tensor."""
    n = mesh.size()
    axes = tuple(mesh.mesh_dim_names)

    def mk(spec, shape):
        shape = tuple(getattr(shape, "shape", shape))
        if len(shape) >= 1 and shape[-1] % n == 0:
            return (*([None] * (len(shape) - 1)), axes)
        return ()

    return _tree_map(mk, param_specs, params_shapes)


def lm_param_specs(cfg: LMConfig, rules: MeshRules) -> dict:
    """The spec of every parameter, nested as the reference's params."""
    s = rules.spec
    specs = {
        "embed": s("model", "fsdp"),
        "out": s("fsdp", "model"),
        "final_norm": s(None),
        "layers": {
            "ln1": s(None, None), "ln2": s(None, None),
            "wq": s(None, "fsdp", "model"), "wk": s(None, "fsdp", "kv_model"),
            "wv": s(None, "fsdp", "kv_model"), "wo": s(None, "model", "fsdp"),
        },
    }
    if cfg.moe_experts:
        specs["layers"].update(router=s(None, "fsdp", None),
                               wi_gate=s(None, "expert_model", "fsdp", "ff_model"),
                               wi_up=s(None, "expert_model", "fsdp", "ff_model"),
                               wo_ffn=s(None, "expert_model", "ff_model", "fsdp"))
    else:
        specs["layers"].update(wi_gate=s(None, "fsdp", "model"), wi_up=s(None, "fsdp", "model"),
                               wo_ffn=s(None, "model", "fsdp"))
    return specs


def nested_shapes(cfg: LMConfig) -> dict:
    """Every parameter's shape, nested as :func:`lm_param_specs`."""
    out: dict = {"layers": {}}
    for name, shape in _param_shapes(cfg).items():
        if name.startswith("layers."):
            out["layers"][name.removeprefix("layers.")] = shape
        else:
            out[name] = shape
    return out


def _unfsdp(w):
    """A weight with its FSDP shards gathered (the reference's per-layer
    all-gather under ZeRO-3); plain tensors and other dims untouched."""
    rules = current_rules()
    if not isinstance(w, DTensor) or not rules.fsdp:
        return w
    names = tuple(w.device_mesh.mesh_dim_names)
    target = [Replicate() if names[i] in rules.fsdp else p for i, p in enumerate(w.placements)]
    return w if list(w.placements) == target else w.redistribute(w.device_mesh, target)


def _tokens(tokens, params: TransformerLM) -> torch.Tensor:
    """Token ids on the model's device; ids from outside (numpy, lists)
    are checked against the vocabulary.  With DTensor parameters, ids given
    whole on every rank become a DTensor sharded over the batch axes."""
    if isinstance(tokens, DTensor):
        return tokens
    if not isinstance(tokens, torch.Tensor):
        arr = np.asarray(tokens)
        if arr.size and (arr.min() < 0 or arr.max() >= params.cfg.vocab):
            raise ValueError(f"token ids must lie in [0, {params.cfg.vocab})")
        tokens = arr
    tokens = as_tensor(tokens, params.embed.device)
    if isinstance(params.embed, DTensor):
        tokens = shard(replicated(tokens, params.embed), "batch", *([None] * (tokens.ndim - 1)))
    return tokens


def _lookup(tokens, table):
    """``embedding(tokens, table)``; on a DTensor table sharded by rows, each
    rank reads the rows it holds (zeros for the others) and the result is a
    partial sum over the row-sharding dims."""
    if not isinstance(table, DTensor):
        return torch.nn.functional.embedding(tokens, table)
    mesh = table.device_mesh
    rows, off = block_of(table, 0)
    vocab_dims = [i for i, p in enumerate(table.placements) if p.is_shard() and p.dim == 0]
    out_place = [Partial() if i in vocab_dims else p for i, p in enumerate(tokens.placements)]
    # each rank's rows take the gradient of its own tokens: a partial sum where the tokens are sharded
    grad_place = [Partial() if p == Replicate() and tokens.placements[i] != Replicate() else p
                  for i, p in enumerate(table.placements)]

    def body(tk, tb):
        loc = tk.long() - off
        hit = (loc >= 0) & (loc < rows)
        emb = torch.nn.functional.embedding(loc.clamp(0, rows - 1), tb)
        return torch.where(hit[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))

    return local_map(body, out_placements=out_place, in_placements=(tokens.placements, table.placements),
                     in_grad_placements=(tokens.placements, grad_place), device_mesh=mesh)(tokens, table)


def _embed(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = _lookup(tokens, _unfsdp(params.embed)).to(cfg.dtype)
    # the vocab-sharded lookup's partial rows summed: into the sequence-
    # parallel residual (prefill, train) or whole rows (decode)
    return shard(x, "batch", "model", None) if x.ndim == 3 else shard(x, "batch", None)


def _attn_spec(cfg: LMConfig) -> L.AttnSpec:
    return L.AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                      chunk=cfg.attn_chunk, window=cfg.window, unroll=cfg.unroll)


def _layer(params: TransformerLM, i: int) -> dict[str, torch.Tensor]:
    """Layer i's parameters (decode, under no_grad)."""
    return {n: p[i] for n, p in params.layers.items()}


def _layer_fwd(cfg: LMConfig, x, lp, positions):
    """One transformer block (training and prefill path).  x: (B, S, D).  Returns x and
    the layer's aux loss (fp32; 0 for a dense FFN)."""
    b, s_len, _ = x.shape
    hd = cfg.head_dim
    lp = {n: _unfsdp(w) for n, w in lp.items()}
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    h = shard(h, "batch", None, None)  # gather the sequence on the norm's output
    q = shard(torch.matmul(h, lp["wq"]).reshape(b, s_len, cfg.n_heads, hd), "batch", None, "model", None)
    k = shard(torch.matmul(h, lp["wk"]).reshape(b, s_len, cfg.n_kv_heads, hd), "batch", None, "kv_model", None)
    v = shard(torch.matmul(h, lp["wv"]).reshape(b, s_len, cfg.n_kv_heads, hd), "batch", None, "kv_model", None)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    attn = L.causal_attention(q, k, v, _attn_spec(cfg)).reshape(b, s_len, cfg.n_heads * hd)
    x = x + shard(torch.matmul(attn, lp["wo"]), "batch", "model", None).to(x.dtype)  # sequence-parallel
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    h = shard(h, "batch", None, None)
    if cfg.moe_experts:
        y, metrics = L.moe_block(h, lp["router"], lp["wi_gate"], lp["wi_up"], lp["wo_ffn"],
                                 top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
        aux = shard(metrics.aux_loss)
    else:
        y = L.swiglu(h, lp["wi_gate"], lp["wi_up"], lp["wo_ffn"])
        aux = replicated(torch.zeros((), dtype=torch.float32, device=x.device), x)
    return x + shard(y, "batch", "model", None).to(x.dtype), aux


def _layer_fwd_under(rules: MeshRules, cfg: LMConfig, x, lp, positions):
    with use_rules(rules):
        return _layer_fwd(cfg, x, lp, positions)


@lm_precision()
def lm_forward(params: TransformerLM, tokens, cfg: LMConfig):
    """Token ids (B, S) → final hidden states (B, S, D) and the mean aux
    loss over the layers (fp32; 0 for a dense model).  With ``cfg.remat``
    and a gradient recorded, each layer is recomputed in the backward."""
    tokens = _tokens(tokens, params)
    x = _embed(params, tokens, cfg)
    positions = replicated(torch.arange(tokens.shape[1], device=x.device), x)
    stacked = {n: p.unbind(0) for n, p in params.layers.items()}
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(cfg.n_layers):
        lp = {n: ps[i] for n, ps in stacked.items()}
        if remat:
            # the recompute may run on the autograd engine's device thread: it takes the rules along
            x, aux = torch.utils.checkpoint.checkpoint(_layer_fwd_under, current_rules(), cfg, x, lp, positions,
                                                       use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _layer_fwd(cfg, x, lp, positions)
        auxes.append(aux)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, torch.mean(torch.stack(auxes))


@lm_precision()
def lm_logits(params: TransformerLM, hidden: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Hidden states (..., D) → logits (..., V), fp32 (V sharded over "model"
    on a mesh)."""
    hidden = shard(hidden, "batch", *([None] * (hidden.ndim - 1)))
    logits = L.matmul_wide(hidden, _unfsdp(params.out))
    return shard(logits, "batch", *([None] * (hidden.ndim - 2)), "model")


def _target_logp(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log p(target) from fp32 logits (..., V): ``log_softmax`` and a gather;
    on logits whose V is sharded, each rank's block combines by one max and
    two sums over the sharding dim (the reference's one-hot contraction
    keeps V local the same way).  A vocab held whole takes the plain path."""
    if not isinstance(logits, DTensor):
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, targets[..., None].long())[..., 0]
    from repro_torch.sharding.collectives import all_reduce_sum

    mesh = logits.device_mesh
    last = logits.ndim - 1
    v_dims = [i for i, p in enumerate(logits.placements) if p.is_shard() and p.dim == last and mesh.size(i) > 1]
    v_loc, v_off = block_of(logits, last)
    out_place = [Replicate() if p.is_shard() and p.dim == last else p for p in logits.placements]
    group = mesh.get_group(v_dims[0]) if len(v_dims) == 1 else None
    if len(v_dims) > 1:
        raise ValueError(f"V may be sharded over one mesh dim, got {logits.placements}")

    def body(lg, tg):
        if group is None:
            return _target_logp(lg, tg)
        m = funcol.all_reduce(lg.detach().amax(dim=-1), "max", (mesh, v_dims[0]))
        se = all_reduce_sum(torch.sum(torch.exp(lg - m[..., None]), dim=-1), group)
        loc = tg.long() - v_off
        hit = (loc >= 0) & (loc < v_loc)
        tl = torch.gather(lg, -1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
        tl = all_reduce_sum(torch.where(hit, tl, 0.0), group)
        return (tl - m) - torch.log(se)

    return local_map(body, out_placements=out_place, in_placements=(logits.placements, out_place),
                     in_grad_placements=(logits.placements, out_place), device_mesh=mesh,
                     redistribute_inputs=True)(logits, targets)


def lm_loss(params: TransformerLM, batch: dict, cfg: LMConfig):
    """Next-token cross entropy.  batch: tokens (B, S+1) int.  Returns
    ``(ce + 0.01·aux, {"ce_loss": ce, "aux_loss": aux})``, as the reference.

    The log-likelihood of each target is gathered from the fp32
    ``log_softmax``: the same values as the reference's one-hot
    contraction, which it chose to keep a vocab-sharded axis local."""
    tokens = _tokens(batch["tokens"], params)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden, aux = lm_forward(params, inputs, cfg)
    ll = _target_logp(lm_logits(params, hidden, cfg), targets)
    loss = -torch.mean(ll)
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}


@torch.no_grad()
def prefill_step(params: TransformerLM, tokens, cfg: LMConfig) -> torch.Tensor:
    """Full-sequence forward for serving: the last position's logits (B, V), fp32."""
    hidden, _ = lm_forward(params, tokens, cfg)
    hidden = shard(hidden, "batch", None, None)  # the last position of every sequence
    return lm_logits(params, hidden[:, -1], cfg)


class KVCache(NamedTuple):
    k: torch.Tensor       # (L, B, S, KV, hd)
    v: torch.Tensor
    length: torch.Tensor  # 0-d int32: number of valid positions


def kv_cache_specs(cfg: LMConfig, rules: MeshRules) -> KVCache:
    """The cache's specs: S sharded over "model", the batch over the batch axes."""
    spec = rules.spec(None, "batch", "model", None, None)
    return KVCache(k=spec, v=spec, length=())


def init_kv_cache(cfg: LMConfig, batch: int, seq_len: int, *, device=None) -> KVCache:
    """An empty cache on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(None, device)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=torch.zeros((), dtype=torch.int32, device=dev))


def _layer_decode(cfg: LMConfig, x, lp, kc, vc, length):
    """One block for a single new token.  x: (B, D); kc/vc: (B, S, KV, hd),
    written in place at position ``length`` — clamped to the last slot, as
    the reference's ``dynamic_update_slice`` clamps."""
    b, _ = x.shape
    hd = cfg.head_dim
    lp = {n: _unfsdp(w) for n, w in lp.items()}
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q = torch.matmul(h, lp["wq"]).reshape(b, cfg.n_heads, hd)
    k_new = torch.matmul(h, lp["wk"]).reshape(b, cfg.n_kv_heads, hd)
    v_new = torch.matmul(h, lp["wv"]).reshape(b, cfg.n_kv_heads, hd)
    pos = length.reshape(1)
    q = L.rope(q[:, None], pos, cfg.rope_theta)[:, 0]
    k_new = L.rope(k_new[:, None], pos, cfg.rope_theta)[:, 0]
    _write_slot(kc, k_new, pos)
    _write_slot(vc, v_new, pos)
    attn = L.decode_attention(q, kc, vc, _attn_spec(cfg), length=length + 1)
    x = x + shard(torch.matmul(attn.reshape(b, -1), lp["wo"]), "batch", None).to(x.dtype)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe_experts:
        # every expert runs on the new token: no dispatch, no dropping
        y = L.moe_dense_decode(h, lp["router"], lp["wi_gate"], lp["wi_up"], lp["wo_ffn"],
                               top_k=cfg.moe_top_k)
    else:
        y = L.swiglu(h, lp["wi_gate"], lp["wi_up"], lp["wo_ffn"])
    x = x + shard(y, "batch", None).to(x.dtype)
    return x, kc, vc


def _write_slot(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """``cache[:, pos] = new`` in place, ``pos`` (1,) clamped to the last
    slot.  On a DTensor cache sharded along S, the rank that owns the slot
    writes it (a select and a masked write, no host sync); ``new`` is
    gathered to every rank of the S-sharding dims first."""
    if not isinstance(cache, DTensor):
        slot = torch.clamp(pos, max=cache.shape[1] - 1).long()
        cache.index_copy_(1, slot, new[:, None])
        return
    mesh = cache.device_mesh
    place = [p if p.is_shard() and p.dim == 0 else Replicate() for p in cache.placements]
    new = new.redistribute(mesh, place).to_local() if isinstance(new, DTensor) else new
    pos = pos.to_local() if isinstance(pos, DTensor) else pos
    local = cache.to_local()
    s_loc, s_off = block_of(cache, 1)
    slot = torch.clamp(pos, max=cache.shape[1] - 1).long() - s_off
    hit = (slot >= 0) & (slot < s_loc)
    idx = slot.clamp(0, s_loc - 1)
    local.index_copy_(1, idx, torch.where(hit, new[:, None], local.index_select(1, idx)))


@torch.no_grad()
@lm_precision()
def serve_step(params: TransformerLM, cache: KVCache, tokens, cfg: LMConfig):
    """Decode one token per sequence.  tokens: (B,) int (the new inputs).

    Returns (logits (B, V) fp32, greedy next-token ids (B,) int32 — the
    first index on ties — and the cache, whose k and v were updated in
    place, with ``length + 1``)."""
    tokens = _tokens(tokens, params)
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x, _, _ = _layer_decode(cfg, x, _layer(params, i), cache.k[i], cache.v[i], cache.length)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    next_tok = torch.argmax(shard(logits, "batch", None), dim=-1).to(torch.int32)
    return logits, next_tok, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
