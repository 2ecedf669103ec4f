"""Transformer building blocks of the port: RMSNorm, RoPE, GQA attention
(prefill and cached decode), SwiGLU.

Counterpart of ``repro/models/layers.py``.  The reference's ``shard(...)``
annotations are dropped: the port runs on one device with no mesh.  The
MoE blocks (``moe_block``, ``moe_dense_decode``) wait with the MoE configs.

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
window, a query offset; on the CPU every case runs the plain chunked
recurrence.  The reference's ``_expand_kv`` is
:func:`repro_torch.kernels.flash_attention.flash.expand_kv` (the plain
recurrence there needs it; the kernel indexes kv heads instead).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash as F

__all__ = ["wide_dtype", "matmul_wide", "rmsnorm", "rope", "AttnSpec", "causal_attention",
           "decode_attention", "swiglu"]


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32, or float64 for float64: the reference's fp32 upcast."""
    return torch.promote_types(dtype, torch.float32)


def matmul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a wide (fp32 / float64) output and accumulation: the
    reference's ``einsum(..., preferred_element_type=f32)``."""
    wide = wide_dtype(a.dtype)
    return torch.matmul(a.to(wide), b.to(wide))


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

    CUDA: kernel 4, with ``spec.window`` and ``q_offset``.  CPU: the plain
    chunked recurrence over ``spec.chunk`` keys at a time."""
    if q.device.type == "cpu":
        return F.flash_attention_plain(q, k, v, causal=True, chunk=spec.chunk,
                                       q_offset=q_offset, window=spec.window)
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
