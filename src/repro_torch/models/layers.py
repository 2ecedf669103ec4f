"""Transformer building blocks of the port: RMSNorm, RoPE, GQA attention
(prefill and cached decode), SwiGLU, and GShard MoE (``moe_block`` for
prefill, ``moe_dense_decode`` for decode).

Counterpart of ``repro/models/layers.py``.  The reference's ``shard(...)``
annotations are dropped: the port runs on one device with no mesh.

Precision: where the reference upcasts (``astype(f32)``) or contracts with
``preferred_element_type=f32``, the port computes in fp32 — in float64 when
the inputs are float64, so that one code path also gives the float64
oracle.  An fp32-output product of bf16 inputs is an fp32 matmul of the
upcast operands: bf16 products are exact in fp32, so it is the reference's
bf16 × bf16 → fp32 contraction (TF32 stays off, see
:func:`repro_torch.device.lm_precision`).

``causal_attention`` on a CUDA tensor runs the hand-written flash kernel
(kernel 4, :func:`repro_torch.kernels.flash_attention.flash.flash_attention`)
for every case the reference serves: any head dim up to 256, a sliding
window, a query offset; under autograd it goes through
``flash.flash_attention_grad``, kernel 4's forward with the reference's
recomputing backward (plain PyTorch, as the reference's is plain JAX).  On
the CPU every case runs the plain chunked recurrence under ordinary
autograd.  The reference's ``_expand_kv`` is
:func:`repro_torch.kernels.flash_attention.flash.expand_kv` (the plain
recurrence there needs it; the kernel indexes kv heads instead).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash as F

__all__ = ["wide_dtype", "matmul_wide", "einsum_wide", "rmsnorm", "rope", "AttnSpec",
           "causal_attention", "decode_attention", "swiglu", "MoEMetrics", "MoERoute", "moe_capacity",
           "moe_route", "moe_block", "moe_block_routed", "moe_dense_decode"]


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or float64 for float64: the reference's fp32 upcast."""
    return torch.promote_types(dtype, torch.float32)


def matmul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a wide (fp32 / float64) output and accumulation: the
    reference's ``einsum(..., preferred_element_type=f32)``."""
    wide = wide_dtype(a.dtype)
    return torch.matmul(a.to(wide), b.to(wide))


def einsum_wide(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` on upcast operands: the reference's
    ``einsum(eq, a, b, preferred_element_type=f32)``."""
    wide = wide_dtype(a.dtype)
    return torch.einsum(eq, a.to(wide), b.to(wide))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # variance in fp32; the output multiplies in x's dtype, as the reference's
    x32 = x.to(wide_dtype(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, n, head_dim); positions: (S,) or (B, S).
    Angles in fp32, as the reference computes them."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class AttnSpec(NamedTuple):
    n_heads: int
    n_kv_heads: int
    head_dim: int
    chunk: int
    window: int | None  # sliding window; None = full
    unroll: bool = False  # inert: the reference's scan unrolling


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, spec: AttnSpec, *,
                     q_offset: int = 0) -> torch.Tensor:
    """Causal attention, q (B, Sq, H, hd), k/v (B, Sk, KV, hd) → (B, Sq, H, hd).

    CUDA: kernel 4, with ``spec.window`` and ``q_offset``; when a gradient
    is recorded, through ``flash.flash_attention_grad``, whose backward
    recomputes the plain recurrence over ``spec.chunk`` keys at a time.
    CPU: the plain chunked recurrence over ``spec.chunk`` keys at a time."""
    if q.device.type == "cpu":
        return F.flash_attention_plain(q, k, v, causal=True, chunk=spec.chunk,
                                       q_offset=q_offset, window=spec.window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return F.flash_attention_grad(q, k, v, causal=True, chunk=spec.chunk, q_offset=q_offset,
                                      window=spec.window)
    return F.flash_attention(q, k, v, causal=True, q_offset=q_offset, window=spec.window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     spec: AttnSpec, *, length) -> torch.Tensor:
    """One-token decode against the cache.  q (B, H, hd); caches (B, S, KV, hd);
    positions ``< length`` attend (``length`` an int or a 0-d tensor).
    Scale folded into q in fp32, as the reference does."""
    b, h, hd = q.shape
    s = k_cache.shape[1]
    kv = spec.n_kv_heads
    groups = h // kv
    wide = wide_dtype(q.dtype)
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, kv, groups, hd).to(wide) * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(wide))  # (B, KV, G, S)
    pos = torch.arange(s, device=q.device)
    valid = pos < length
    if spec.window is not None:
        valid &= pos >= (length - spec.window)
    logits = torch.where(valid, logits, F.NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(wide))
    out = out / denom[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def swiglu(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: gate and up products wide, the down product in x's dtype."""
    g = matmul_wide(x, wi_gate)
    u = matmul_wide(x, wi_up)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h, wo)


# ---------------------------------------------------------------------------
# GShard MoE
# ---------------------------------------------------------------------------


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor      # load-balance loss (Switch-style), fp32
    dropped_frac: torch.Tensor  # fraction of (token, choice) slots over capacity, fp32


class MoERoute(NamedTuple):
    """What the router and GShard's choice loop decided for token groups."""
    experts: torch.Tensor   # (k, G, S) int64: the expert taken at each of the k choice steps
    combine: torch.Tensor   # (G, S, E, C) wide: each kept slot's renormalised gate, else 0
    metrics: MoEMetrics


def moe_capacity(g_size: int, top_k: int, capacity_factor: float, e: int) -> int:
    """Slots per expert and group: ``g_size·top_k·cf / E`` truncated, at least 1."""
    return max(1, int(g_size * top_k * capacity_factor / e))


def _token_groups(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """(B, S, D) or (T, D) → (G, min(group_size, T), D)."""
    tokens = x.reshape(-1, x.shape[-1])
    t = tokens.shape[0]
    g_size = min(group_size, t)
    n_groups = t // g_size
    if n_groups * g_size != t:
        raise ValueError(f"{t} tokens not divisible into {g_size}-groups")
    return tokens.reshape(n_groups, g_size, x.shape[-1])


def moe_route(xs: torch.Tensor, router_w: torch.Tensor, *, top_k: int, cap: int,
              experts: torch.Tensor | None = None) -> MoERoute:
    """The router (wide, on upcast ``xs`` (G, S, D)) and the reference's top-k
    choice loop: each step takes the first argmax of the probabilities not
    yet taken, the token's place in its expert is its rank in the group
    after the expert's earlier fills, and places ``>= cap`` are dropped.

    ``experts`` (k, G, S), when given, stands in for each step's argmax and
    everything else — gates, places, drops, the aux loss — follows from it
    as usual: a float64 oracle thereby takes a bf16 run's routing.

    ``combine`` is scattered slot by slot: each (g, s, e, c) slot receives
    at most one nonzero gate, so it holds the values of the reference's sum
    of one-hot products without materialising a (G, S, E, C) temporary per
    step."""
    wide = wide_dtype(xs.dtype)
    g, s, _ = xs.shape
    e = router_w.shape[1]
    probs = torch.softmax(matmul_wide(xs, router_w), dim=-1)  # (G, S, E)
    dev = xs.device
    gi = torch.arange(g, device=dev)[:, None]
    si = torch.arange(s, device=dev)[None, :]
    combine = torch.zeros((g, s, e, cap), dtype=wide, device=dev)
    remaining = probs
    base_count = torch.zeros((g, 1, e), dtype=torch.long, device=dev)
    gates_sum = torch.zeros((g, s), dtype=wide, device=dev)
    dropped = torch.zeros((), dtype=torch.long, device=dev)
    aux_me = torch.zeros((g, e), dtype=wide, device=dev)
    aux_ce = torch.zeros((g, e), dtype=wide, device=dev)
    taken = []
    for j in range(top_k):
        idx = torch.argmax(remaining, dim=-1) if experts is None else experts[j]  # (G, S)
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]  # the max when idx is the argmax
        onehot = torch.nn.functional.one_hot(idx, e)  # (G, S, E) int64
        pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot + base_count, -1, idx[..., None])[..., 0]
        base_count = base_count + onehot.sum(dim=1, keepdim=True)
        keep = (pos < cap).to(wide)
        dropped = dropped + (pos >= cap).sum()
        # a dropped choice adds 0 to its expert's last slot: no value changes
        combine.index_put_((gi, si, idx, torch.clamp(pos, max=cap - 1)), gate * keep, accumulate=True)
        gates_sum = gates_sum + gate * keep
        aux_me = aux_me + torch.mean(probs, dim=1)
        aux_ce = aux_ce + torch.mean(onehot.to(wide), dim=1)
        remaining = remaining * (1.0 - onehot.to(wide))
        taken.append(idx)
    # renormalise combine weights over the k kept choices
    combine = combine / torch.clamp(gates_sum, min=1e-9)[..., None, None]
    aux_loss = torch.mean(torch.sum((aux_me / top_k) * (aux_ce / top_k), dim=-1)) * e
    metrics = MoEMetrics(aux_loss=aux_loss.to(torch.float32),
                         dropped_frac=dropped.to(torch.float32) / (g * s * top_k))
    return MoERoute(experts=torch.stack(taken), combine=combine, metrics=metrics)


def moe_block_routed(x: torch.Tensor, router_w: torch.Tensor, wi_gate: torch.Tensor,
                     wi_up: torch.Tensor, wo: torch.Tensor, *, top_k: int,
                     capacity_factor: float = 1.25, group_size: int = 2048,
                     experts: torch.Tensor | None = None):
    """:func:`moe_block` that also returns the routing it took, (k, G, S)
    expert ids, and takes one (``experts``) in place of its own argmaxes
    (:func:`moe_route`).  Returns (out, MoEMetrics, experts)."""
    xs = _token_groups(x, group_size)
    cap = moe_capacity(xs.shape[1], top_k, capacity_factor, router_w.shape[1])
    route = moe_route(xs, router_w, top_k=top_k, cap=cap, experts=experts)
    dispatch = (route.combine > 0.0).to(x.dtype)
    xd = einsum_wide("gsec,gsd->gecd", dispatch, xs).to(x.dtype)
    del dispatch
    hg = einsum_wide("gecd,edf->gecf", xd, wi_gate)
    hu = einsum_wide("gecd,edf->gecf", xd, wi_up)
    h = (torch.nn.functional.silu(hg) * hu).to(x.dtype)
    del hg, hu
    y = torch.einsum("gecf,efd->gecd", h, wo)  # in x's dtype, as the reference's
    out = einsum_wide("gsec,gecd->gsd", route.combine.to(x.dtype), y)
    return out.reshape(x.shape).to(x.dtype), route.metrics, route.experts


def moe_block(x: torch.Tensor, router_w: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
              wo: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              group_size: int = 2048) -> tuple[torch.Tensor, MoEMetrics]:
    """GShard top-k routing with capacity + dispatch/combine einsums.

    x (B, S, D) or (T, D); router_w (D, E); wi_gate, wi_up (E, D, F); wo
    (E, F, D).  Tokens are split into groups of ``group_size``; each group
    has expert capacity C = ``moe_capacity``.  Over-capacity (token, choice)
    pairs are dropped (their combine weight is 0); ``dropped_frac`` reports
    them."""
    out, metrics, _ = moe_block_routed(x, router_w, wi_gate, wi_up, wo, top_k=top_k,
                                       capacity_factor=capacity_factor, group_size=group_size)
    return out, metrics


def moe_dense_decode(x: torch.Tensor, router_w: torch.Tensor, wi_gate: torch.Tensor,
                     wi_up: torch.Tensor, wo: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Decode-path MoE: every expert runs on every token (B, D), combined with
    the top-k gates renormalised.  The top k are every probability at or
    above the k-th largest, so a tie at that threshold takes more than k
    experts, as the reference's does."""
    probs = torch.softmax(matmul_wide(x, router_w), dim=-1)  # (B, E)
    thresh = torch.topk(probs, top_k, dim=-1).values[:, -1:]
    gates = torch.where(probs >= thresh, probs, 0.0)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    hg = einsum_wide("bd,edf->bef", x, wi_gate)
    hu = einsum_wide("bd,edf->bef", x, wi_up)
    h = (torch.nn.functional.silu(hg) * hu).to(x.dtype)
    y = torch.einsum("bef,efd->bed", h, wo)  # in x's dtype, as the reference's
    return einsum_wide("bed,be->bd", y, gates.to(x.dtype)).to(x.dtype)
