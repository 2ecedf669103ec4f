"""Public wrappers around the fused bidirectional min-d² scan.

Counterpart of ``repro/kernels/hausdorff/ops.py``.  On a CUDA tensor the
wrappers launch the hand-written kernel (``hausdorff.fused_minscan``) or
raise; on a CPU tensor they run its plain version
(``repro_torch.core.exact.fused_min_sqdists_tiled``).  Around the kernel
they do what it requires:

  - invalid rows zeroed (so garbage cannot leak NaN through the dot
    product) and their squared norms poisoned with +inf, computed once
    here in fp32;
  - prune tables (projection interval gaps + witness cutoffs) built at the
    table block size from caller-supplied projections, or no gate;
  - one launch over all of b: the Pallas kernel chunked b
    (``MAX_RESIDENT_B``) to bound a column-min row held in VMEM, while this
    kernel folds columns into device memory and splits the tile pairs
    across its grid; directed callers (``min_sqdists``,
    ``directed_hausdorff``) get the instance with no column fold;
  - the final max-reduce + sqrt, where an all-invalid query side gives 0.0.

The row counts are not padded: the kernel masks the ragged edge itself.
The launcher zero-pads a D that is not a multiple of 4 and widens bf16
to fp32 (both exact), since the kernel copies 16-byte fp32 chunks.  Pruning callers should pre-sort each cloud along the primary
projection (``tile_bounds.order_by_projection``); results are exact either
way.
"""
from __future__ import annotations

import torch

from repro_torch.core import exact, tile_bounds
from repro_torch.core.exact import finalize_mins as _finalize
from repro_torch.kernels.hausdorff import hausdorff as K
from repro_torch.obs import trace as _obs

__all__ = [
    "fit_block",
    "fused_min_sqdists",
    "min_sqdists",
    "directed_hausdorff",
    "hausdorff",
    "hausdorff_twosweep_tiled",
]

def fit_block(block: int, n: int) -> int:
    """The prune-table block edge the kernel runs for a requested ``block``
    on ``n`` rows: a multiple of the kernel's tile, at most ``n`` rounded
    up to one."""
    t = K.TILE
    return min(-(-block // t) * t, max(t, -(-n // t) * t))


def _poison(x: torch.Tensor, valid: torch.Tensor | None):
    """(x zeroed at invalid rows, contiguous; fp32 norms with +inf there)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    if valid is not None:
        x = torch.where(valid[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    x = x.contiguous()
    x32 = x.float()
    x2 = torch.sum(x32 * x32, dim=1)
    if valid is not None:
        x2 = torch.where(valid, x2, torch.inf)
    return x, x2


def fused_min_sqdists(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    valid_a: torch.Tensor | None = None,
    valid_b: torch.Tensor | None = None,
    prune_projs: tuple[torch.Tensor, torch.Tensor] | None = None,
    block_a: int = K.TABLE_BLOCK,
    block_b: int = K.TABLE_BLOCK,
    directed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One scan, both directions: ``(min_a (n_a,), min_b (n_b,))`` fp32.

    min_a[i] is the min d² from a-row i to the valid b rows; min_b[j] from
    b-row j to the valid a rows.  Entries of invalid rows are +inf.
    ``prune_projs = (proj_a, proj_b)`` — per-row projections (n, m) onto
    shared unit directions, column 0 primary — gates the tiles; results
    are unchanged.  ``directed=True`` launches the kernel's row-min-only
    instance and lets the column side never veto a skip: min_b is then
    not computed on CUDA and not exact on the CPU, and must be ignored.
    """
    # rows x cols pairs of d coordinates: the work handed to the kernel; on
    # CUDA the span also names the kernel instance launched
    with _obs.span("hd.scan", device=a.device, rows=a.shape[0], cols=b.shape[0], d=a.shape[-1],
                   directed=directed, pruned=prune_projs is not None) as sp:
        if a.device.type == "cpu" and b.device.type == "cpu":
            return exact.fused_min_sqdists_tiled(
                a, b, valid_a=valid_a, valid_b=valid_b,
                block_a=block_a, block_b=block_b, prune_projs=prune_projs,
            )
        if a.device.type != "cuda" or b.device != a.device:
            raise ValueError(f"a and b must both be on one CUDA device or on the CPU, got {a.device}, {b.device}")
        n_a = a.shape[0]
        n_b = b.shape[0]
        block_a = fit_block(block_a, n_a)
        block_b = fit_block(block_b, n_b)
        if a.dtype != b.dtype:
            a, b = a.float(), b.float()
        a, a2 = _poison(a, valid_a)
        b, b2 = _poison(b, valid_b)

        lb = cut_a = cut_b = None
        if prune_projs is not None:
            proj_a, proj_b = prune_projs
            tables = tile_bounds.prune_tables(
                a, proj_a, valid_a, b, proj_b, valid_b, block_a, block_b, directed=directed
            )
            lb, cut_a, cut_b = tables

        min_a = torch.full((n_a,), torch.inf, dtype=torch.float32, device=a.device)
        min_b = torch.full((n_b,), torch.inf, dtype=torch.float32, device=a.device)
        sp.set(instance=K.fused_minscan(
            a, b, a2, b2, min_a, min_b, lb=lb, cut_a=cut_a, cut_b=cut_b,
            block_a=block_a, block_b=block_b, directed=directed,
        ))
        return min_a, min_b


def min_sqdists(
    a, b, *, valid_a=None, valid_b=None, prune_projs=None,
    block_a: int = K.TABLE_BLOCK, block_b: int = K.TABLE_BLOCK,
) -> torch.Tensor:
    """Per-row min squared L2 distance from a (n_a, D) to the valid rows of b."""
    min_a, _ = fused_min_sqdists(
        a, b, valid_a=valid_a, valid_b=valid_b, prune_projs=prune_projs,
        block_a=block_a, block_b=block_b, directed=True,
    )
    return min_a


def directed_hausdorff(
    a, b, *, valid_a=None, valid_b=None, prune_projs=None,
    block_a: int = K.TABLE_BLOCK, block_b: int = K.TABLE_BLOCK,
):
    """h(A,B) = max over valid a-rows of the scan's min distances (0.0 if none)."""
    mins = min_sqdists(
        a, b, valid_a=valid_a, valid_b=valid_b, prune_projs=prune_projs,
        block_a=block_a, block_b=block_b,
    )
    return _finalize(mins, valid_a)


def hausdorff(
    a, b, *, valid_a=None, valid_b=None, prune_projs=None,
    block_a: int = K.TABLE_BLOCK, block_b: int = K.TABLE_BLOCK,
):
    """Undirected H(A,B) from one fused scan."""
    min_a, min_b = fused_min_sqdists(
        a, b, valid_a=valid_a, valid_b=valid_b, prune_projs=prune_projs,
        block_a=block_a, block_b=block_b,
    )
    return torch.maximum(_finalize(min_a, valid_a), _finalize(min_b, valid_b))


def hausdorff_twosweep_tiled(a, b, *, valid_a=None, valid_b=None):
    """Undirected H(A,B) as two directed scans, every d² tile computed twice:
    the baseline the fused call is measured against, under the reference's
    name (``exact.hausdorff_twosweep_tiled`` is its plain version).  On CUDA
    tensors two launches of kernel 1's directed instance."""
    return torch.maximum(directed_hausdorff(a, b, valid_a=valid_a, valid_b=valid_b),
                         directed_hausdorff(b, a, valid_a=valid_b, valid_b=valid_a))
