"""Launcher of the hand-written CUDA fused min-d² scan (``csrc/fused_minscan.cu``).

Counterpart of ``repro/kernels/hausdorff/hausdorff.py`` (the Pallas
``_fused_kernel``).  :func:`fused_minscan` folds every entry of
``d² = max((a2 − 2ab) + b2, 0)`` into the row mins and, unless
``directed``, the column mins of outputs that hold +inf (or earlier
partial mins): one launch.  Tile pairs of ``TILE`` rows are gated by the
prune tables, read at the table block they lie in.  The
``kernels.hausdorff.ops`` wrapper does the validity, norm and prune-table
work around it.

:func:`launch_plan` decides how a scan is launched: the persistent grid
(the tile pairs cut into one equal range per CTA), and whether a CTA keeps
its a-tile resident in shared memory (only b streams) or streams both.

Only CUDA tensors are accepted: the plain version for the CPU is
``repro_torch.core.exact.fused_min_sqdists_tiled``, chosen by the ops
wrapper.  The library is built from the checkout's source at first call
(``repro_torch.kernels._build``) and launched on PyTorch's current stream;
the launcher never synchronises.  ``fused_minscan.launches`` counts
launches, ``fused_minscan.instance_launches`` each instance's
(:func:`instance`), and the launcher returns the instance it launched.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, refuse_grad

__all__ = ["TILE", "TABLE_BLOCK", "SOURCE", "MAX_SMEM", "INSTANCES", "LaunchPlan", "build", "tile_b",
           "smem_bytes", "resident_smem_bytes", "plan_smem_bytes", "launch_plan", "pair_range", "instance",
           "fused_minscan"]

# Rows of a per CTA tile, and of b in the streamed instance (the resident
# one's b-tile is ``tile_b(True)``); prune-table blocks are multiples of it.
TILE = 128
# Default prune-table block edge: 4 tiles, a whole number of either
# instance's b-tiles.  The table holds (n_a / TABLE_BLOCK)·(n_b /
# TABLE_BLOCK) entries; finer blocks prove more tiles skippable, coarser
# ones make the tables cheaper.  Not tuned yet.
TABLE_BLOCK = 512
SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_minscan.cu"

# The kernel's constants (csrc/fused_minscan.cu, csrc/minscan_tile.cuh),
# mirrored for the plan; the kernel refuses a launch whose shared-memory
# size disagrees.
_BK = 32            # k-slice per ring slot, both instances
# The streamed instance's tile body (minscan_tile.cuh, shared with kernels
# 2 and 3): 128-row slices of a padded row pitch, STAGES slots.
_STAGES = 3         # ring slots
_PITCH = _BK + 4    # stage row pitch, floats
_SLICE_BYTES = TILE * _PITCH * 4
# The resident instance: 128 × 256 tile pairs, slices of 128-byte swizzled
# rows, a ring of _RING b-slices, 8-byte mbarriers (full and empty per
# slot, a-free per a-slice) and two column-min rows of 256.
_TILE_B = 256
_RING = 3
_ROW_BYTES = _BK * 4
# Shared memory one block can use on sm_90 (227 KB).
MAX_SMEM = 232_448
# A CTA keeps its a-tile resident only if it walks at least this many
# b-tiles per a-tile (kernels 2 and 3 take the same rule for their
# resident query tile, whose load is not overlapped).
_RESIDENT_MIN_WALK = 4
# The instances, named as the launcher reports them.
INSTANCES = ("resident.directed", "resident.bidirectional", "streamed.directed", "streamed.bidirectional")

_lib: ctypes.CDLL | None = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _build.load_library("fused_minscan", [SOURCE])
        fn = lib.fused_minscan
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, p, p, p, p,
                       i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
        lib.fused_minscan_occupancy.argtypes = [i, i, i]
        lib.fused_minscan_occupancy.restype = i
        _lib = lib
    return _lib


def _row_stride(d: int) -> int:
    """Floats per staged row: D rounded up to 4 (16-byte rows), at least 4."""
    return max(4, -(-d // 4) * 4)


def tile_b(resident: bool) -> int:
    """Rows of b per tile pair of an instance."""
    return _TILE_B if resident else TILE


def smem_bytes(d: int, resident: bool) -> int:
    """Dynamic shared memory of one CTA of the tile body of
    ``csrc/minscan_tile.cuh`` (kernels 2 and 3, and this kernel's streamed
    instance, ``resident=False``): the resident query tile's k-slices (if
    any), the ring, and the two column-min rows."""
    n_k = -(-_row_stride(d) // _BK)
    slices = n_k + _STAGES if resident else 2 * _STAGES
    return slices * _SLICE_BYTES + 2 * TILE * 4


def resident_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one CTA of this kernel's resident instance:
    the a-tile's k-slices, the ring of b-slices, the mbarriers and the two
    column-min rows."""
    n_k = -(-_row_stride(d) // _BK)
    return (n_k * TILE + _RING * _TILE_B) * _ROW_BYTES + 8 * (2 * _RING + n_k) + 2 * _TILE_B * 4


def plan_smem_bytes(d: int, resident: bool) -> int:
    """Dynamic shared memory of one CTA of an instance of this kernel."""
    return resident_smem_bytes(d) if resident else smem_bytes(d, False)


def instance(resident: bool, directed: bool) -> str:
    """The name of an instance, as :data:`INSTANCES` lists it."""
    return f"{'resident' if resident else 'streamed'}.{'directed' if directed else 'bidirectional'}"


class LaunchPlan(NamedTuple):
    """How one scan is launched (see :func:`launch_plan`)."""

    resident: bool   # a-tile resident in shared memory, only b streams
    smem: int        # dynamic shared memory per CTA, bytes
    grid: int        # persistent CTAs
    n_pairs: int     # tile pairs of TILE × tile_b(resident) rows, a-tile-major:
                     # pair p = (p // tiles_b, p % tiles_b)
    ld: int          # staged row stride, floats


def pair_range(plan: LaunchPlan, cta: int) -> tuple[int, int]:
    """The tile pairs ``[begin, end)`` that CTA ``cta`` walks, as the kernels
    compute them (kernel 1's plan, or a ``batched.BucketPlan``)."""
    return plan.n_pairs * cta // plan.grid, plan.n_pairs * (cta + 1) // plan.grid


def launch_plan(n_a: int, n_b: int, d: int, sms: int, *, ctas_per_sm: int = 1,
                resident: bool | None = None) -> LaunchPlan:
    """The plan for an (n_a, n_b, D) scan on a card with ``sms`` SMs, of which
    each holds ``ctas_per_sm`` CTAs of the chosen instance.

    The grid is persistent: ``min(pairs, sms · ctas_per_sm)`` CTAs, each
    walking one of equal ranges of the a-tile-major pairs, so every pair is
    covered once and a small query side still fills the card.  The
    resident instance (a-tile in shared memory, 256-row b-tiles) is taken
    when its a-tile fits (D ≤ 256) and a CTA walks at least
    ``_RESIDENT_MIN_WALK`` of its b-tiles per a-tile; ``resident`` forces
    the choice (a resident tile that does not fit raises).
    """
    if min(n_a, n_b, sms, ctas_per_sm) < 1 or d < 0:
        raise ValueError(f"launch_plan needs positive sizes, got {(n_a, n_b, d, sms, ctas_per_sm)}")
    tiles_a = math.ceil(n_a / TILE)
    fits = resident_smem_bytes(d) <= MAX_SMEM
    if resident is None:
        tiles_b = math.ceil(n_b / _TILE_B)
        grid = min(tiles_a * tiles_b, sms * ctas_per_sm)
        resident = fits and min(tiles_b, tiles_a * tiles_b // grid) >= _RESIDENT_MIN_WALK
    elif resident and not fits:
        raise ValueError(f"a resident a-tile at D {d} needs {resident_smem_bytes(d)} B of shared memory")
    n_pairs = tiles_a * math.ceil(n_b / tile_b(resident))
    return LaunchPlan(resident, plan_smem_bytes(d, resident), min(n_pairs, sms * ctas_per_sm), n_pairs,
                      _row_stride(d))


@functools.lru_cache(maxsize=4096)
def _planned(n_a: int, n_b: int, d: int, directed: bool, device: int) -> LaunchPlan:
    """:func:`launch_plan` on a card, with as many CTAs per SM as the CUDA
    occupancy API fits of the chosen instance (cached: the search path
    repeats a few shapes thousands of times)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = launch_plan(n_a, n_b, d, sms)
    with torch.cuda.device(device):
        occ = build().fused_minscan_occupancy(int(plan.resident), int(directed), plan.smem)
    if occ < 1:
        raise RuntimeError(f"fused_minscan: no CTA of {plan.smem} B fits on an SM")
    return launch_plan(n_a, n_b, d, sms, ctas_per_sm=occ, resident=plan.resident)


def _staged(x: torch.Tensor, ld: int) -> torch.Tensor:
    """x (..., D) as the kernels read it: contiguous fp32 rows of ``ld``
    floats, 16-byte aligned, zero past D.  Widening bf16 and zero-padding D
    are exact; a tensor already so is not copied."""
    if x.dtype == torch.float32 and x.shape[-1] == ld and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    out = torch.zeros((*x.shape[:-1], ld), dtype=torch.float32, device=x.device)
    out[..., : x.shape[-1]] = x
    return out


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
    directed: bool = False,
    plan: LaunchPlan | None = None,
) -> str | None:
    """One launch: fold the d² entries of (a, b) into ``min_a`` / ``min_b``.

    a (n_a, D), b (n_b, D): contiguous, fp32 or bf16, same dtype, on one
    CUDA device.  a2 (n_a,), b2 (n_b,): fp32 squared norms, +inf at
    invalid rows.  min_a (n_a,), min_b (n_b,): fp32 outputs, updated in
    place.  lb (gi, gj) with unit column stride, cut_a (gi,), cut_b (gj,):
    the prune tables at ``block_a`` × ``block_b`` rows (multiples of
    ``TILE``), or all None for an ungated scan.  ``directed=True`` launches
    the row-min-only instance and leaves ``min_b`` as given.  ``plan``
    overrides :func:`launch_plan` (for checks that results do not depend on
    it).  Returns the instance launched (:func:`instance`; None when a side
    is empty).  Raises under grad mode when an input requires grad
    (:func:`repro_torch.kernels.refuse_grad`).
    """
    refuse_grad("hausdorff.fused_minscan", a, b, a2, b2, lb, cut_a, cut_b)
    if not isinstance(directed, bool):
        raise TypeError(f"directed must be a bool, got {type(directed).__name__}")
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
        return None

    if plan is None:
        plan = _planned(n_a, n_b, d, directed, dev.index if dev.index is not None else torch.cuda.current_device())
    elif (plan.n_pairs, plan.ld, plan.smem) != (math.ceil(n_a / TILE) * math.ceil(n_b / tile_b(plan.resident)),
                                              _row_stride(d), plan_smem_bytes(d, plan.resident)):
        raise ValueError(f"plan {plan} does not fit an ({n_a}, {n_b}, {d}) scan")
    a = _staged(a, plan.ld)
    b = _staged(b, plan.ld)

    fn = build().fused_minscan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(), a2.data_ptr(), b2.data_ptr(),
            _ptr(lb), ld_lb, _ptr(cut_a), _ptr(cut_b),
            min_a.data_ptr(), min_b.data_ptr(), n_a, n_b, plan.ld,
            int(plan.resident), int(directed), block_a // TILE, block_b // TILE,
            plan.grid, plan.smem, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_minscan launch failed: CUDA error {err}")
    name = instance(plan.resident, directed)
    fused_minscan.launches += 1
    fused_minscan.instance_launches[name] += 1
    return name


fused_minscan.launches = 0
fused_minscan.instance_launches = dict.fromkeys(INSTANCES, 0)
