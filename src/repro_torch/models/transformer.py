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
the layers) and ``layers.moe_dense_decode`` in decode.  The sharding specs
wait with sharding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.device import as_tensor, lm_precision, resolve_device
from repro_torch.models import layers as L

__all__ = ["TransformerLM", "init_lm_params", "lm_forward", "lm_logits", "lm_loss", "prefill_step",
           "KVCache", "init_kv_cache", "serve_step"]


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


def _tokens(tokens, params: TransformerLM) -> torch.Tensor:
    """Token ids on the model's device; ids from outside (numpy, lists)
    are checked against the vocabulary."""
    if not isinstance(tokens, torch.Tensor):
        arr = np.asarray(tokens)
        if arr.size and (arr.min() < 0 or arr.max() >= params.cfg.vocab):
            raise ValueError(f"token ids must lie in [0, {params.cfg.vocab})")
        tokens = arr
    return as_tensor(tokens, params.embed.device)


def _embed(params: TransformerLM, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    return torch.nn.functional.embedding(tokens, params.embed).to(cfg.dtype)


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
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q = torch.matmul(h, lp["wq"]).reshape(b, s_len, cfg.n_heads, hd)
    k = torch.matmul(h, lp["wk"]).reshape(b, s_len, cfg.n_kv_heads, hd)
    v = torch.matmul(h, lp["wv"]).reshape(b, s_len, cfg.n_kv_heads, hd)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    attn = L.causal_attention(q, k, v, _attn_spec(cfg)).reshape(b, s_len, cfg.n_heads * hd)
    x = x + torch.matmul(attn, lp["wo"]).to(x.dtype)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe_experts:
        y, metrics = L.moe_block(h, lp["router"], lp["wi_gate"], lp["wi_up"], lp["wo_ffn"],
                                 top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
        aux = metrics.aux_loss
    else:
        y = L.swiglu(h, lp["wi_gate"], lp["wi_up"], lp["wo_ffn"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y.to(x.dtype), aux


@lm_precision()
def lm_forward(params: TransformerLM, tokens, cfg: LMConfig):
    """Token ids (B, S) → final hidden states (B, S, D) and the mean aux
    loss over the layers (fp32; 0 for a dense model).  With ``cfg.remat``
    and a gradient recorded, each layer is recomputed in the backward."""
    tokens = _tokens(tokens, params)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    stacked = {n: p.unbind(0) for n, p in params.layers.items()}
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(cfg.n_layers):
        lp = {n: ps[i] for n, ps in stacked.items()}
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(_layer_fwd, cfg, x, lp, positions, use_reentrant=False,
                                                       preserve_rng_state=False)
        else:
            x, aux = _layer_fwd(cfg, x, lp, positions)
        auxes.append(aux)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, torch.mean(torch.stack(auxes))


@lm_precision()
def lm_logits(params: TransformerLM, hidden: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Hidden states (..., D) → logits (..., V), fp32."""
    return L.matmul_wide(hidden, params.out)


def lm_loss(params: TransformerLM, batch: dict, cfg: LMConfig):
    """Next-token cross entropy.  batch: tokens (B, S+1) int.  Returns
    ``(ce + 0.01·aux, {"ce_loss": ce, "aux_loss": aux})``, as the reference.

    The log-likelihood of each target is gathered from the fp32
    ``log_softmax``: the same values as the reference's one-hot
    contraction, which it chose to keep a vocab-sharded axis local."""
    tokens = _tokens(batch["tokens"], params)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden, aux = lm_forward(params, inputs, cfg)
    logp = torch.log_softmax(lm_logits(params, hidden, cfg), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    loss = -torch.mean(ll)
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}


@torch.no_grad()
def prefill_step(params: TransformerLM, tokens, cfg: LMConfig) -> torch.Tensor:
    """Full-sequence forward for serving: the last position's logits (B, V), fp32."""
    hidden, _ = lm_forward(params, tokens, cfg)
    return lm_logits(params, hidden[:, -1], cfg)


class KVCache(NamedTuple):
    k: torch.Tensor       # (L, B, S, KV, hd)
    v: torch.Tensor
    length: torch.Tensor  # 0-d int32: number of valid positions


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
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q = torch.matmul(h, lp["wq"]).reshape(b, cfg.n_heads, hd)
    k_new = torch.matmul(h, lp["wk"]).reshape(b, cfg.n_kv_heads, hd)
    v_new = torch.matmul(h, lp["wv"]).reshape(b, cfg.n_kv_heads, hd)
    pos = length.reshape(1)
    q = L.rope(q[:, None], pos, cfg.rope_theta)[:, 0]
    k_new = L.rope(k_new[:, None], pos, cfg.rope_theta)[:, 0]
    slot = torch.clamp(pos, max=kc.shape[1] - 1).long()
    kc.index_copy_(1, slot, k_new[:, None])
    vc.index_copy_(1, slot, v_new[:, None])
    attn = L.decode_attention(q, kc, vc, _attn_spec(cfg), length=length + 1)
    x = x + torch.matmul(attn.reshape(b, -1), lp["wo"]).to(x.dtype)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe_experts:
        # every expert runs on the new token: no dispatch, no dropping
        y = L.moe_dense_decode(h, lp["router"], lp["wi_gate"], lp["wi_up"], lp["wo_ffn"],
                               top_k=cfg.moe_top_k)
    else:
        y = L.swiglu(h, lp["wi_gate"], lp["wi_up"], lp["wo_ffn"])
    x = x + y.to(x.dtype)
    return x, kc, vc


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
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, next_tok, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
