"""Gradient compression for the data-parallel all-reduce.

Counterpart of ``repro/train/compression.py``.  Two compressors, both with
error feedback (each step's residual is added into the next step's
gradient, so compression error does not bias the optimizer — Karimireddy
et al. 2019):

  * int8 linear quantization, per-tensor symmetric (``round`` is half to
    even in both packages, so the int8 words are the reference's bit for
    bit on the same fp32 values),
  * PowerSGD rank r (Vogels et al. 2019): G ≈ P Qᵀ with two skinny
    all-reduces of (n·r + m·r) instead of n·m.

Gradients, errors and factors are dicts of named tensors.  The
``compressed_*`` primitives all-reduce the compressed representation over
a ``torch.distributed`` process group — the reference's ``psum`` over the
``shard_map`` batch axes — for the explicit data-parallel step
(``repro_torch.train.loop.make_explicit_dp_step``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["quantize_int8", "dequantize_int8", "int8_compress_tree", "init_error_tree",
           "compressed_psum_int8", "PowerSGDState", "init_powersgd", "powersgd_round",
           "compression_ratio"]


# ---------------------------------------------------------------------------
# int8 linear quantization + error feedback
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_compress_tree(grads: dict, error: dict) -> tuple[dict, dict]:
    """Error-feedback int8: returns (dequantized grads, new error)."""
    deq, err = {}, {}
    for n, g in grads.items():
        g32 = g.to(torch.float32) + error[n]
        q, s = quantize_int8(g32)
        deq[n] = dequantize_int8(q, s)
        err[n] = g32 - deq[n]
    return deq, err


def init_error_tree(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}


def compressed_psum_int8(local_grads: dict, error: dict, group) -> tuple[dict, dict]:
    """DP all-reduce in int8: quantize locally, all-reduce int32 counts,
    dequantize.  Returns (mean gradient, new error).

    Each rank quantizes (g + e) with its own scale; the scales are maxed
    across the group so the sum is exact in the shared grid.  Wire bytes
    per leaf: n·1 (int8, widened to int32 for the sum) + 1 scale."""
    n_ranks = dist.get_world_size(group)
    mean, err = {}, {}
    for n, g in local_grads.items():
        g32 = g.to(torch.float32) + error[n]
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)  # shared grid
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        err[n] = g32 - q.to(torch.float32) * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        mean[n] = total.to(torch.float32) * scale / float(n_ranks)
    return mean, err


# ---------------------------------------------------------------------------
# PowerSGD (rank-r) + error feedback
# ---------------------------------------------------------------------------


class PowerSGDState(NamedTuple):
    q: dict       # per-leaf right factors (m, r), warm-started across steps; (0,) for ≤1-d leaves
    error: dict   # per-leaf fp32 error feedback


def _orthonormalize(m: torch.Tensor) -> torch.Tensor:
    q, _ = torch.linalg.qr(m)
    return q


def _matrix_shape(shape) -> tuple[int, int] | None:
    """A ≥2-d leaf's (rows, cols) as PowerSGD factors it; None for ≤1-d
    leaves, which ride uncompressed."""
    if len(shape) <= 1:
        return None
    rows = shape[0]
    cols = 1
    for s in shape[1:]:
        cols *= s
    return rows, cols


def init_powersgd(params: dict, rank: int, generator: torch.Generator) -> PowerSGDState:
    """Random normal right factors (m, rank), fp32, drawn from ``generator``
    in the params' order (the reference folds a process-salted ``hash`` of
    each leaf's path into its key, so its draws cannot be matched; tests
    carry its factors across with ``interop.powersgd_state_from_reference``)."""
    q = {}
    for n, p in params.items():
        mat = _matrix_shape(p.shape)
        q[n] = (torch.zeros((0,), dtype=torch.float32, device=p.device) if mat is None else
                torch.randn((mat[1], rank), generator=generator, dtype=torch.float32, device=generator.device)
                .to(p.device))
    return PowerSGDState(q=q, error=init_error_tree(params))


def powersgd_round(local_grads: dict, state: PowerSGDState, group=None) -> tuple[dict, PowerSGDState]:
    """One PowerSGD round.  With a ``group``, the two skinny factors are
    summed over it (the compressed all-reduce); without, it is a pure
    low-rank filter.  Returns (approximated mean gradient, new state)."""
    n_ranks = dist.get_world_size(group) if group is not None else 1
    approx, new_q, new_e = {}, {}, {}
    for n, g in local_grads.items():
        q, e = state.q[n], state.error[n]
        g32 = g.to(torch.float32) + e
        mat = _matrix_shape(g32.shape)
        if mat is None:
            if group is not None:
                mean = g32.clone()
                dist.all_reduce(mean, group=group)
                mean = mean / n_ranks
                approx[n], new_q[n], new_e[n] = mean, q, g32 - mean
            else:
                approx[n], new_q[n], new_e[n] = g32, q, torch.zeros_like(g32)
            continue
        m2 = g32.reshape(mat)
        p = m2 @ q                                    # (n, r)
        if group is not None:
            dist.all_reduce(p, group=group)
        p = _orthonormalize(p)
        nq = m2.T @ p                                 # (m, r)
        if group is not None:
            dist.all_reduce(nq, group=group)
            nq = nq / float(n_ranks)
        a = (p @ nq.T).reshape(g.shape)
        approx[n], new_q[n], new_e[n] = a, nq, g32 - a
    return approx, PowerSGDState(q=new_q, error=new_e)


def compression_ratio(params: dict, rank: int) -> float:
    """Wire bytes (PowerSGD) / wire bytes (dense fp32) — for logging."""
    dense = wire = 0
    for p in params.values():
        n = p.numel()
        dense += n * 4
        mat = _matrix_shape(p.shape)
        wire += n * 4 if mat is None else (mat[0] + mat[1]) * rank * 4
    return wire / max(dense, 1)
