"""Launcher of the hand-written CUDA fused min-d² scan (``csrc/fused_minscan.cu``).

Counterpart of ``repro/kernels/hausdorff/hausdorff.py`` (the Pallas
``_fused_kernel``).  :func:`fused_minscan` folds every entry of
``d² = max((a2 − 2ab) + b2, 0)`` into the row mins and column mins of
outputs that hold +inf (or earlier partial mins) — one launch, both
directions.  Tiles of ``TILE`` rows are gated by the prune tables, read at
the table block they lie in.  The ``kernels.hausdorff.ops`` wrapper does
the validity, norm and prune-table work around it.

Only CUDA tensors are accepted: the plain version for the CPU is
``repro_torch.core.exact.fused_min_sqdists_tiled``, chosen by the ops
wrapper.  The library is built from the checkout's source at first call
(``repro_torch.kernels._build``) and launched on PyTorch's current stream;
the launcher never synchronises.  ``fused_minscan.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

__all__ = ["TILE", "TABLE_BLOCK", "SOURCE", "build", "grid", "fused_minscan"]

# Rows of a and of b per CTA tile; prune-table blocks are multiples of it.
TILE = 128
# Default prune-table block edge: 4 tiles.  The table holds
# (n_a / TABLE_BLOCK)·(n_b / TABLE_BLOCK) entries; finer blocks prove more
# tiles skippable, coarser ones make the tables cheaper.  Not tuned yet.
TABLE_BLOCK = 512
SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_minscan.cu"

# CTAs to aim for per launch, per SM: several waves of 2 resident CTAs.
_CTAS_PER_SM = 8

_lib: ctypes.CDLL | None = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _build.load_library("fused_minscan", [SOURCE])
        fn = lib.fused_minscan
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, i, p, p, p, ctypes.c_longlong, p, p, p, p,
                       i, i, i, i, i, i, p]
        fn.restype = i
        _lib = lib
    return _lib


def grid(n_a: int, n_b: int, sms: int) -> tuple[int, int, int]:
    """The launch grid for an (n_a, n_b) scan on a card with ``sms`` SMs:
    ``(a-tiles, b-chunks, b-tiles per chunk)``.  Each CTA walks its chunk's
    b-tiles in turn, so a small query side still fills the card."""
    tiles_a = math.ceil(n_a / TILE)
    tiles_b = math.ceil(n_b / TILE)
    n_chunks = min(tiles_b, 65535, max(1, math.ceil(_CTAS_PER_SM * sms / tiles_a)))
    per_chunk = math.ceil(tiles_b / n_chunks)
    return tiles_a, math.ceil(tiles_b / per_chunk), per_chunk


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_vec(name, t, n, device):
    if t is None:
        raise ValueError(f"{name} is required")
    if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{name} must be a contiguous float32 ({n},) tensor on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def fused_minscan(
    a: torch.Tensor,
    b: torch.Tensor,
    a2: torch.Tensor,
    b2: torch.Tensor,
    min_a: torch.Tensor,
    min_b: torch.Tensor,
    *,
    lb: torch.Tensor | None = None,
    cut_a: torch.Tensor | None = None,
    cut_b: torch.Tensor | None = None,
    block_a: int = TABLE_BLOCK,
    block_b: int = TABLE_BLOCK,
) -> None:
    """One launch: fold the d² entries of (a, b) into ``min_a`` / ``min_b``.

    a (n_a, D), b (n_b, D): contiguous, fp32 or bf16, same dtype, on one
    CUDA device.  a2 (n_a,), b2 (n_b,): fp32 squared norms, +inf at
    invalid rows.  min_a (n_a,), min_b (n_b,): fp32 outputs, updated in
    place.  lb (gi, gj) with unit column stride, cut_a (gi,), cut_b (gj,):
    the prune tables at ``block_a`` × ``block_b`` rows (multiples of
    ``TILE``), or all None for an ungated scan.
    """
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"fused_minscan takes CUDA tensors, got {dev}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"a and b must share dtype float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a, b must be (n, D) with one D, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()) or b.device != dev:
        raise ValueError("a and b must be contiguous and on one device")
    n_a, d = a.shape
    n_b = b.shape[0]
    _check_vec("a2", a2, n_a, dev)
    _check_vec("b2", b2, n_b, dev)
    _check_vec("min_a", min_a, n_a, dev)
    _check_vec("min_b", min_b, n_b, dev)
    if block_a % TILE or block_b % TILE or block_a <= 0 or block_b <= 0:
        raise ValueError(f"table blocks must be positive multiples of {TILE}, got {block_a}, {block_b}")
    gi, gj = math.ceil(n_a / block_a), math.ceil(n_b / block_b)
    ld_lb = 0
    if lb is not None:
        if lb.dtype != torch.float32 or lb.shape != (gi, gj) or lb.stride(1) != 1 or lb.device != dev:
            raise ValueError(f"lb must be float32 ({gi}, {gj}) with unit column stride on {dev}")
        _check_vec("cut_a", cut_a, gi, dev)
        _check_vec("cut_b", cut_b, gj, dev)
        ld_lb = lb.stride(0)
    if n_a == 0 or n_b == 0:
        return

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, _, tiles_per_chunk = grid(n_a, n_b, sms)

    fn = build().fused_minscan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(), int(a.dtype == torch.bfloat16),
            a2.data_ptr(), b2.data_ptr(), _ptr(lb), ld_lb, _ptr(cut_a), _ptr(cut_b),
            min_a.data_ptr(), min_b.data_ptr(), n_a, n_b, d,
            block_a // TILE, block_b // TILE, tiles_per_chunk, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_minscan launch failed: CUDA error {err}")
    fused_minscan.launches += 1


fused_minscan.launches = 0
