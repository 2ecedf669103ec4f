"""Exact Hausdorff distances in plain PyTorch — the fused kernel's plain version.

Counterpart of ``repro/core/exact.py``:

- ``directed_hd_dense`` / ``hausdorff_dense``: one (n_a, n_b) distance
  matrix; the oracle for small inputs (``dense`` backend).
- ``directed_hd_tiled``: a loop over B tiles with a running row min.
- ``fused_min_sqdists_tiled`` / ``hausdorff_fused_tiled``: the plain
  version of the fused bidirectional scan kernel
  (``repro_torch.kernels.hausdorff``): each (A-tile, B-tile) d² block is
  computed once and folded into both the row mins (A→B) and the column
  mins (B→A).  With prune tables, tile pairs that provably cannot hold a
  min skip their GEMM.  It runs on any device and is the ``tiled``
  backend; the kernel's wrapper runs it for CPU tensors.
- ``hausdorff_twosweep_tiled``: the paper-era baseline of the fused scan,
  two ``directed_hd_tiled`` sweeps (every d² tile computed twice).  Its
  kernel counterpart, two launches of kernel 1's directed instance, is
  ``repro_torch.kernels.hausdorff.ops.hausdorff_twosweep_tiled``.
- ``directed_hd_earlybreak`` / ``hausdorff_earlybreak``: the EBHD
  early-break double loop (Taha & Hanbury 2015), the paper's exact
  baseline, on the inputs' device.  Not a fast path on any device.

All but the early-break pair take optional validity masks: invalid rows
are zeroed (garbage cannot leak NaN through the GEMM) and their squared
norms poisoned with +inf, so they win neither direction's min.  An empty
query side gives H = 0.0.

Arithmetic contract: ``d² = max((‖a‖² − 2a·b) + ‖b‖², 0)`` in fp32 with
fp32 accumulation; :func:`repro_torch.device.strict_fp32` keeps TF32 off.
"""
from __future__ import annotations

import torch

from repro_torch.core import tile_bounds
from repro_torch.device import strict_fp32

__all__ = [
    "finalize_mins",
    "pairwise_sqdist",
    "directed_hd_dense",
    "directed_hd_tiled",
    "directed_hd_earlybreak",
    "fused_min_sqdists_tiled",
    "hausdorff_dense",
    "hausdorff_fused_tiled",
    "hausdorff_tiled",
    "hausdorff_twosweep_tiled",
    "hausdorff_earlybreak",
]


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, (n_a, n_b), fp32, clamped ≥ 0."""
    strict_fp32()
    a = a.float()
    b = b.float()
    a2 = torch.sum(a * a, dim=1, keepdim=True)
    b2 = torch.sum(b * b, dim=1, keepdim=True)
    d2 = a2 - 2.0 * (a @ b.T) + b2.T
    return torch.clamp(d2, min=0.0)


def finalize_mins(mins, valid) -> torch.Tensor:
    """max over valid rows → sqrt; an empty query set gives 0.0, not NaN."""
    if valid is not None:
        mins = torch.where(valid, mins, -torch.inf)
    return torch.sqrt(torch.clamp(torch.max(mins), min=0.0))


def directed_hd_dense(a, b, *, valid_a=None, valid_b=None) -> torch.Tensor:
    """h(A,B) = max_a min_b ||a-b||, full distance matrix."""
    d2 = pairwise_sqdist(a, b)
    if valid_b is not None:
        d2 = torch.where(valid_b[None, :], d2, torch.inf)
    return finalize_mins(torch.min(d2, dim=1).values, valid_a)


def hausdorff_dense(a, b, *, valid_a=None, valid_b=None) -> torch.Tensor:
    return torch.maximum(
        directed_hd_dense(a, b, valid_a=valid_a, valid_b=valid_b),
        directed_hd_dense(b, a, valid_a=valid_b, valid_b=valid_a),
    )


def _poisoned(x, valid, block):
    """Pad rows to ``block``, zero invalid rows, and poison their norms.

    Returns ``(x32 (n_pad, D), x2 (n_pad,))``: padded and invalid rows are
    zero with a +inf squared norm.
    """
    n = x.shape[0]
    v = valid if valid is not None else torch.ones((n,), dtype=torch.bool, device=x.device)
    v_pad = tile_bounds.pad_rows(v, block, value=False)
    x32 = tile_bounds.pad_rows(x.float(), block)
    x32 = torch.where(v_pad[:, None], x32, 0.0)
    x2 = torch.where(v_pad, torch.sum(x32 * x32, dim=1), torch.inf)
    return x32, x2


def _tile_d2(at, a2t, bt, b2t):
    """One fp32 d² tile, in the reference's op order: (a2 − 2ab) + b2, ≥ 0."""
    d2 = at @ bt.T
    d2.mul_(-2.0).add_(a2t[:, None]).add_(b2t[None, :])
    return d2.clamp_(min=0.0)


def directed_hd_tiled(
    a, b, *, valid_a=None, valid_b=None, block: int = 2048, prune_projs=None
) -> torch.Tensor:
    """h(A,B) via a loop over B tiles with a running per-row min.

    Memory O(n_a · block).  With ``prune_projs=(proj_a, proj_b)``, B tiles
    whose projection-gap lower bound clears the row cutoff skip their GEMM.
    """
    strict_fp32()
    n_a = a.shape[0]
    n_b = b.shape[0]
    block = min(block, n_b)
    a32 = a.float()
    a2 = torch.sum(a32 * a32, dim=1)
    b32, b2 = _poisoned(b, valid_b, block)

    skip = None
    if prune_projs is not None:
        proj_a, proj_b = prune_projs
        tables = tile_bounds.prune_tables(
            a, proj_a, valid_a, b, proj_b, valid_b, n_a, block, directed=True
        )
        skip = tile_bounds.skip_mask(tables)[0].tolist()

    mins = torch.full((n_a,), torch.inf, dtype=torch.float32, device=a.device)
    for j, c0 in enumerate(range(0, b32.shape[0], block)):
        if skip is not None and skip[j]:
            continue
        d2 = _tile_d2(a32, a2, b32[c0:c0 + block], b2[c0:c0 + block])
        mins = torch.minimum(mins, d2.amin(dim=1))
    return finalize_mins(mins, valid_a)


def fused_min_sqdists_tiled(
    a,
    b,
    *,
    valid_a=None,
    valid_b=None,
    block_a: int = 4096,
    block_b: int = 2048,
    prune_projs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused scan: one d² pass, both mins.

    Returns ``(min_a (n_a,), min_b (n_b,))`` fp32; entries of invalid rows
    are +inf.  With ``prune_projs``, tile pairs whose projection lower
    bound clears both witness cutoffs skip the GEMM.
    """
    strict_fp32()
    n_a = a.shape[0]
    n_b = b.shape[0]
    block_a = min(block_a, n_a)
    block_b = min(block_b, n_b)
    a32, a2 = _poisoned(a, valid_a, block_a)
    b32, b2 = _poisoned(b, valid_b, block_b)
    gi = a32.shape[0] // block_a
    gj = b32.shape[0] // block_b

    if gi == 1 and gj == 1 and prune_projs is None:
        # Single tile pair: one d² tile, both reductions, no loop.
        d2 = _tile_d2(a32, a2, b32, b2)
        return d2.amin(dim=1)[:n_a], d2.amin(dim=0)[:n_b]

    skip = None
    if prune_projs is not None:
        proj_a, proj_b = prune_projs
        tables = tile_bounds.prune_tables(
            a, proj_a, valid_a, b, proj_b, valid_b, block_a, block_b
        )
        skip = tile_bounds.skip_mask(tables).tolist()

    dev = a.device
    min_a = torch.full((gi * block_a,), torch.inf, dtype=torch.float32, device=dev)
    min_b = torch.full((gj * block_b,), torch.inf, dtype=torch.float32, device=dev)
    for i in range(gi):
        ra = slice(i * block_a, (i + 1) * block_a)
        for j in range(gj):
            if skip is not None and skip[i][j]:
                continue
            rb = slice(j * block_b, (j + 1) * block_b)
            d2 = _tile_d2(a32[ra], a2[ra], b32[rb], b2[rb])
            min_a[ra] = torch.minimum(min_a[ra], d2.amin(dim=1))
            min_b[rb] = torch.minimum(min_b[rb], d2.amin(dim=0))
    return min_a[:n_a], min_b[:n_b]


def hausdorff_fused_tiled(
    a,
    b,
    *,
    valid_a=None,
    valid_b=None,
    block_a: int = 1024,
    block_b: int = 2048,
    prune_projs=None,
) -> torch.Tensor:
    """Undirected H(A,B) in one fused GEMM pass."""
    min_a, min_b = fused_min_sqdists_tiled(
        a, b, valid_a=valid_a, valid_b=valid_b,
        block_a=block_a, block_b=block_b, prune_projs=prune_projs,
    )
    return torch.maximum(finalize_mins(min_a, valid_a), finalize_mins(min_b, valid_b))


def hausdorff_tiled(a, b, *, valid_a=None, valid_b=None, block: int = 2048) -> torch.Tensor:
    """Undirected H(A,B), tiled: the fused single-pass scan with square blocks."""
    return hausdorff_fused_tiled(
        a, b, valid_a=valid_a, valid_b=valid_b, block_a=block, block_b=block
    )


def hausdorff_twosweep_tiled(a, b, *, valid_a=None, valid_b=None, block: int = 2048) -> torch.Tensor:
    """Historical two-directed-sweep formulation (every d² tile computed
    twice), the baseline the fused scan is measured against."""
    return torch.maximum(
        directed_hd_tiled(a, b, valid_a=valid_a, valid_b=valid_b, block=block),
        directed_hd_tiled(b, a, valid_a=valid_b, valid_b=valid_a, block=block),
    )


# Rows of B per step of the early break's inner loop (the break is checked
# after each); the value does not depend on it.
_EARLYBREAK_CHUNK = 1024


def directed_hd_earlybreak(a, b) -> torch.Tensor:
    """EBHD's exact directed HD (Taha & Hanbury 2015), as the reference runs it.

    An outer loop over the rows of A, in order, keeps the running max ``cmax``
    of d²; for each row an inner loop over B keeps its running min and stops
    as soon as that min is ≤ ``cmax`` (the row cannot raise the max).  d² is
    the difference form ``Σ (aᵢ − bⱼ)²`` in fp32.  The inner loop takes B in
    chunks of ``_EARLYBREAK_CHUNK`` rows with the break checked after each,
    so the work per row is a multiple of the chunk and the value unchanged.
    Each check reads one value back to the host: on a GPU this is a
    host-bound loop, the baseline the paper measures, not a fast path.  An
    empty A gives 0 and an empty B +inf (the reference's loop cannot index
    an empty B)."""
    a = a.float()
    b = b.float()
    cmax = 0.0
    for i in range(a.shape[0]):
        best = float("inf")
        for c0 in range(0, b.shape[0], _EARLYBREAK_CHUNK):
            d2 = torch.sum((a[i] - b[c0:c0 + _EARLYBREAK_CHUNK]) ** 2, dim=1)
            best = min(best, float(d2.min()))
            if best <= cmax:
                break
        cmax = max(cmax, best)
    return torch.sqrt(torch.tensor(cmax, dtype=torch.float32, device=a.device))


def hausdorff_earlybreak(a, b) -> torch.Tensor:
    return torch.maximum(directed_hd_earlybreak(a, b), directed_hd_earlybreak(b, a))
