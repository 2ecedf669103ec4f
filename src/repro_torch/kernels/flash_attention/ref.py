"""Naive attention with full (Sq, Sk) scores and a softmax: the oracle of
the flash-attention kernel.

Counterpart of ``repro/kernels/flash_attention/ref.py``.  Computes in fp32
for bf16/fp32 inputs, as the reference does, and in float64 for float64
inputs (the chip check's oracle).  k/v may carry fewer heads than q (GQA):
query head h reads kv head ``h // (H // KV)``, which is what the
reference's pre-expanded k/v hold.
"""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) with KV dividing H."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads do not divide into {kv} kv heads")
    wide = torch.promote_types(q.dtype, torch.float32)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(wide), k.to(wide)) * scale
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = torch.arange(sk, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(wide))
    return out.to(q.dtype)
