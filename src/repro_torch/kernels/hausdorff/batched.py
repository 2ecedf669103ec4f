"""Bucket min-d² scans: one query, or a query batch, against a padded slab.

Counterpart of ``repro/kernels/hausdorff/batched.py`` (the Pallas
``_batched_kernel`` and ``_multiquery_kernel`` and their wrappers).

Kernel 2, the batched bucket scan.  For a query (n_q, D) and a slab
(S, cap, D) of padded sets, one launch returns per set the min d² from
every query row to the set's valid rows, (S, n_q), and from every set row
to the valid query rows, (S, cap).  Set s is computed iff
``lb[s] <= cut[s]``; otherwise both of its rows stay +inf, the certified
"farther than cut" sentinel (a NaN bound skips too).

    batched_minscan            the launcher of ``csrc/batched_minscan.cu``
                               (CUDA tensors only; ``launches`` counts launches)
    batched_min_sqdists        the wrapper: zero invalid rows, poison their
                               norms with +inf, launch (CUDA) or run the plain
                               version (CPU)
    batched_bucket_hd          (S,) exact (directed) Hausdorff per set
    batched_min_sqdists_mirror the plain PyTorch version

Either operand may be per set (3-D) or shared by every set (2-D): the
kernel takes a per-set stride for each, 0 for a shared one.  This writes
out the vmap the reference puts around its kernel in the cascade's stage 1
(per-lane subsets against each lane's set, or against the one query).

The plain version accumulates each dot product as one product and one add
per k, k = 0..D-1 in order: the kernel's FFMA chain without the fusing.
Its bits therefore depend on nothing but the two rows, like the kernel's,
so padding, batch size and batch composition cannot move them (CPU
``torch.bmm`` changes bits with the GEMM shape).  Kernel and plain version
differ by the rounding of the fused multiply-add, within
``2·(D+2)·eps32·scale²`` per entry.

Kernel 3, the multi-query bucket scan.  For a query batch (Q, n_q, D)
and a slab (S, cap, D), one launch returns per (query, set) pair the same
two min vectors, (Q, S, n_q) and (Q, S, cap); pair (q, s) is computed iff
``lb[q, s] <= cut[q, s]``:

    multiquery_minscan            the launcher of ``csrc/multiquery_minscan.cu``
    multiquery_min_sqdists        the wrapper (as above)
    multiquery_bucket_hd          (Q, S) exact (directed) Hausdorff per pair
    multiquery_min_sqdists_mirror the plain version: kernel 2's plain version
                                  once per query

Both kernels are one bucket scan (``csrc/bucket_scan.cuh``) on kernel 1's
tile body (``csrc/minscan_tile.cuh``), so a pair of kernel 3 is bitwise
kernel 2 with that query against that set, and a lane of kernel 2 bitwise
kernel 1 on its rows.  :func:`bucket_launch_plan` decides how a pass is
launched: a persistent grid over the (item, query tile, slab tile) pairs,
and whether a CTA keeps its query tile resident in shared memory.  Every
scan takes ``directed``: the row-min-only instance, which leaves ``min_b``
+inf (stage 1 of the cascade runs it).

The libraries are built from the checkout's sources at first launch
(``repro_torch.kernels._build``) and launched on PyTorch's current stream;
nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.hausdorff import hausdorff as K

__all__ = [
    "TILE",
    "SOURCE",
    "BucketPlan",
    "bucket_launch_plan",
    "build",
    "batched_minscan",
    "batched_min_sqdists",
    "batched_min_sqdists_mirror",
    "batched_bucket_hd",
    "SOURCE_MULTIQUERY",
    "build_multiquery",
    "multiquery_minscan",
    "multiquery_min_sqdists",
    "multiquery_min_sqdists_mirror",
    "multiquery_bucket_hd",
]

# Rows of the query and of a set per tile (kernel 1's tile).
TILE = K.TILE
# The C interfaces take counts as int.
_INT_MAX = 2**31 - 1
# A gated pass's ranges: at most this many tile pairs (see bucket_launch_plan).
_GATED_RANGE = 16
SOURCE = Path(__file__).resolve().parent / "csrc" / "batched_minscan.cu"
SOURCE_MULTIQUERY = SOURCE.with_name("multiquery_minscan.cu")

_lib: ctypes.CDLL | None = None
_lib_multiquery: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def _bind(lib: ctypes.CDLL, name: str, argtypes: list) -> ctypes.CDLL:
    getattr(lib, name).argtypes = argtypes
    getattr(lib, name).restype = _I
    occupancy = getattr(lib, f"{name}_occupancy")
    occupancy.argtypes = [_I, _I, _I]
    occupancy.restype = _I
    return lib


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = _bind(_build.load_library("batched_minscan", [SOURCE]), "batched_minscan",
                     [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, *[_I] * 9, _P])
    return _lib


def build_multiquery() -> ctypes.CDLL:
    """Compile (if needed) and load the multi-query kernel library."""
    global _lib_multiquery
    if _lib_multiquery is None:
        _lib_multiquery = _bind(_build.load_library("multiquery_minscan", [SOURCE_MULTIQUERY]),
                                "multiquery_minscan", [_P] * 8 + [_I] * 10 + [_P])
    return _lib_multiquery


class BucketPlan(NamedTuple):
    """How one bucket pass (kernel 2 or 3) is launched (see :func:`bucket_launch_plan`)."""

    resident: bool   # query tile resident in shared memory, only the slab streams
    smem: int        # dynamic shared memory per CTA, bytes
    grid: int        # CTAs, each walking one equal range of the pairs
    n_pairs: int     # tile pairs p = ((g·tiles_q + ti)·n_sets + s')·tiles_s + tj
    ld: int          # staged row stride, floats
    set_step: int    # the order's s'-th set is s'·set_step mod n_sets


def _set_step(n_sets: int) -> int:
    """The step of a pass's set order: the integer nearest n_sets·(√5 − 1)/2
    that is coprime to n_sets (1 for one or two sets), so s' → s'·step mod
    n_sets is a bijection.  Multiples of the golden ratio mod 1 fall evenly
    over any window of them, so each CTA's range of sets samples the whole
    pass, and a run of gated sets is shared out among the CTAs."""
    if n_sets <= 2:
        return 1
    g = round(n_sets * (math.sqrt(5.0) - 1.0) / 2.0)
    for delta in range(n_sets):
        for c in (g - delta, g + delta):
            if 0 < c < n_sets and math.gcd(c, n_sets) == 1:
                return c
    return 1  # not reached: 1 is coprime to every n_sets


def bucket_launch_plan(n_groups: int, n_sets: int, n_q: int, cap: int, d: int, sms: int, *,
                       shared_query: bool, gated: bool = False, ctas_per_sm: int = 1,
                       resident: bool | None = None) -> BucketPlan:
    """The plan for a pass of ``n_groups`` queries of ``n_q`` rows against
    ``n_sets`` sets of ``cap`` rows (kernel 2: one group; kernel 3: Q), D
    ``d``, on a card with ``sms`` SMs, of which each holds ``ctas_per_sm``
    CTAs of the chosen instance.

    Each CTA walks one of equal ranges (``hausdorff.pair_range``) of the
    tile pairs in query-tile-major order, so every (item, query tile, slab
    tile) is covered once.  An ungated pass has a persistent grid of
    ``min(pairs, sms · ctas_per_sm)`` CTAs: equal ranges are equal work, so
    one wave balances it to a pair.  A ``gated`` pass's work per range
    depends on which items the gate keeps, which the host does not see (a
    whole query's share of a kernel-3 pass may be twice another's), so its
    ranges are cut to at most ``_GATED_RANGE`` pairs, more CTAs than fit,
    and the block scheduler balances them as CTAs finish.

    The query tile is resident when the query does not depend on the set
    (``shared_query``), the tile fits in shared memory beside the ring
    (``hausdorff.smem_bytes``) and a CTA walks at least
    ``hausdorff._RESIDENT_MIN_WALK`` pairs per query tile; ``resident``
    forces the choice (a resident tile that cannot be, raises).  Pair p
    visits set ``s'·set_step mod n_sets`` (:func:`_set_step`).
    """
    if min(n_groups, n_sets, n_q, cap, sms, ctas_per_sm) < 1 or d < 0:
        raise ValueError(f"bucket_launch_plan needs positive sizes, got {(n_groups, n_sets, n_q, cap, d, sms, ctas_per_sm)}")
    tiles_q, tiles_s = math.ceil(n_q / TILE), math.ceil(cap / TILE)
    n_pairs = n_groups * tiles_q * n_sets * tiles_s
    slots = sms * ctas_per_sm
    grid = min(n_pairs, max(slots, math.ceil(n_pairs / _GATED_RANGE) if gated else 0))
    can = shared_query and K.smem_bytes(d, True) <= K.MAX_SMEM
    if resident is None:
        resident = can and min(n_sets * tiles_s, n_pairs // grid) >= K._RESIDENT_MIN_WALK
    elif resident and not can:
        raise ValueError(f"a resident query tile needs a shared query and {K.smem_bytes(d, True)} B of "
                         f"shared memory at D {d}, got shared_query={shared_query}")
    return BucketPlan(resident, K.smem_bytes(d, resident), grid, n_pairs, K._row_stride(d), _set_step(n_sets))


def _check_plan(plan: BucketPlan, n_groups: int, n_sets: int, n_q: int, cap: int, d: int,
                shared_query: bool) -> None:
    n_pairs = n_groups * math.ceil(n_q / TILE) * n_sets * math.ceil(cap / TILE)
    ok = (plan.n_pairs == n_pairs and plan.ld == K._row_stride(d) and plan.smem == K.smem_bytes(d, plan.resident)
          and 1 <= plan.grid <= _INT_MAX and 1 <= plan.set_step < max(2, n_sets)
          and math.gcd(plan.set_step, n_sets) == 1 and (shared_query or not plan.resident))
    if not ok:
        raise ValueError(f"plan {plan} does not fit a ({n_groups}, {n_sets}, {n_q}, {cap}, {d}) bucket pass "
                         f"(shared_query={shared_query})")


@functools.lru_cache(maxsize=4096)
def _planned(kernel: str, n_groups: int, n_sets: int, n_q: int, cap: int, d: int, shared_query: bool,
             gated: bool, directed: bool, device: int) -> BucketPlan:
    """:func:`bucket_launch_plan` on a card, with as many CTAs per SM as the
    CUDA occupancy API fits of the chosen instance of ``kernel`` (cached:
    the search path repeats a few shapes many times)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = bucket_launch_plan(n_groups, n_sets, n_q, cap, d, sms, shared_query=shared_query, gated=gated)
    lib = build() if kernel == "batched_minscan" else build_multiquery()
    with torch.cuda.device(device):
        occ = getattr(lib, f"{kernel}_occupancy")(int(plan.resident), int(directed), plan.smem)
    if occ < 1:
        raise RuntimeError(f"{kernel}: no CTA of {plan.smem} B fits on an SM")
    return bucket_launch_plan(n_groups, n_sets, n_q, cap, d, sms, shared_query=shared_query, gated=gated,
                              ctas_per_sm=occ, resident=plan.resident)


def _staged_operand(x: torch.Tensor, ld: int) -> tuple[torch.Tensor, int]:
    """An (S, n, D) operand as the kernel reads it, and its set stride in
    floats: fp32 rows of ``ld`` floats, 16-byte aligned, zero past D
    (``hausdorff._staged``).  An operand shared by every set (set stride 0,
    or S = 1) is staged from the one set it repeats, so an ``expand`` is
    never materialised; at D = ld a contiguous fp32 operand is not copied."""
    if x.shape[0] == 1 or x.stride(0) == 0:
        return K._staged(x[0], ld), 0
    staged = K._staged(x, ld)
    return staged, staged.stride(0)


def _set_stride(name: str, t: torch.Tensor, shape: tuple[int, ...], device) -> int:
    """Check an fp32 (S, ...) operand whose per-set block is contiguous;
    return its set stride (0 for a shared, expanded operand)."""
    if t.dtype != torch.float32 or t.device != device or tuple(t.shape) != shape:
        raise ValueError(
            f"{name} must be a float32 {shape} tensor on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if shape[0] and not t[0].is_contiguous():
        raise ValueError(f"{name}'s per-set block must be contiguous, got strides {t.stride()}")
    return t.stride(0)


def batched_minscan(
    q: torch.Tensor,
    q2: torch.Tensor,
    slab: torch.Tensor,
    b2: torch.Tensor,
    min_a: torch.Tensor,
    min_b: torch.Tensor,
    *,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
    directed: bool = False,
    plan: BucketPlan | None = None,
) -> None:
    """One launch: fold every set's d² entries into ``min_a`` / ``min_b``.

    q (S, n_q, D), slab (S, cap, D): fp32 on one CUDA device, each set's
    block contiguous; a set stride of 0 (``expand``) shares the operand.
    q2 (S, n_q), b2 (S, cap): fp32 squared norms, +inf at invalid rows,
    same stride rule.  min_a (S, n_q), min_b (S, cap): contiguous fp32
    outputs, updated in place.  lb, cut (S,): contiguous fp32 gate operands,
    or both None for an ungated pass.  ``directed=True`` launches the
    row-min-only instance and leaves ``min_b`` as given.  ``plan``
    overrides :func:`bucket_launch_plan` (for checks that results do not
    depend on it); a plan that does not fit the pass raises.  Raises under
    grad mode when an input requires grad (:func:`repro_torch.kernels.refuse_grad`).
    """
    refuse_grad("batched.batched_minscan", q, q2, slab, b2, lb, cut)
    if not isinstance(directed, bool):
        raise TypeError(f"directed must be a bool, got {type(directed).__name__}")
    dev = q.device
    if q.ndim != 3 or slab.ndim != 3 or q.shape[2] != slab.shape[2] or q.shape[0] != slab.shape[0]:
        raise ValueError(f"q, slab must be (S, n, D) with one S and D, got {tuple(q.shape)}, {tuple(slab.shape)}")
    n_sets, n_q, d = q.shape
    cap = slab.shape[1]
    if max(n_sets, n_q, cap) > _INT_MAX:
        raise ValueError(f"counts above {_INT_MAX} do not fit one launch, got {(n_sets, n_q, cap)}")
    _set_stride("q", q, (n_sets, n_q, d), dev)
    _set_stride("slab", slab, (n_sets, cap, d), dev)
    q2s = _set_stride("q2", q2, (n_sets, n_q), dev)
    b2s = _set_stride("b2", b2, (n_sets, cap), dev)
    for name, t, n in (("min_a", min_a, n_q), ("min_b", min_b, cap)):
        if t.dtype != torch.float32 or t.shape != (n_sets, n) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous float32 ({n_sets}, {n}) tensor on {dev}")
    if (lb is None) != (cut is None):
        raise ValueError("lb and cut go together")
    if lb is not None:
        for name, t in (("lb", lb), ("cut", cut)):
            if t.dtype != torch.float32 or t.shape != (n_sets,) or not t.is_contiguous() or t.device != dev:
                raise ValueError(f"{name} must be a contiguous float32 ({n_sets},) tensor on {dev}")
    # A query shared by every set (stride 0, or one set) may stay resident.
    q_shared = n_sets == 1 or q.stride(0) == 0
    q2s = 0 if n_sets == 1 else q2s
    shared_query = q_shared and q2s == 0
    if plan is not None and min(n_sets, n_q, cap):
        _check_plan(plan, 1, n_sets, n_q, cap, d, shared_query)
    if dev.type != "cuda":
        raise ValueError(f"batched_minscan takes CUDA tensors, got {dev}")
    if n_sets == 0 or n_q == 0 or cap == 0:
        return

    if plan is None:
        plan = _planned("batched_minscan", 1, n_sets, n_q, cap, d, shared_query, lb is not None, directed,
                        dev.index if dev.index is not None else torch.cuda.current_device())
    qx, qs = _staged_operand(q, plan.ld)
    sx, ss = _staged_operand(slab, plan.ld)
    fn = build().batched_minscan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            qx.data_ptr(), qs, q2.data_ptr(), q2s, sx.data_ptr(), ss, b2.data_ptr(), b2s,
            None if lb is None else lb.data_ptr(), None if cut is None else cut.data_ptr(),
            min_a.data_ptr(), min_b.data_ptr(), n_sets, n_q, cap, plan.ld,
            int(plan.resident), int(directed), plan.grid, plan.smem, plan.set_step, stream,
        )
    if err != 0:
        raise RuntimeError(f"batched_minscan launch failed: CUDA error {err}")
    batched_minscan.launches += 1


batched_minscan.launches = 0


def _poison(x: torch.Tensor, valid: torch.Tensor | None):
    """(x as fp32, zeroed at invalid rows, contiguous; fp32 norms, +inf
    there).  Works on (n, D) and (S, n, D) alike."""
    x = x.float()
    if valid is not None:
        x = torch.where(valid[..., None], x, torch.zeros((), device=x.device))
    x = x.contiguous()
    x2 = torch.sum(x * x, dim=-1)
    if valid is not None:
        x2 = torch.where(valid, x2, torch.inf)
    return x, x2


def _n_sets(q: torch.Tensor, slab: torch.Tensor) -> int:
    if q.ndim not in (2, 3) or slab.ndim not in (2, 3) or q.shape[-1] != slab.shape[-1]:
        raise ValueError(f"q, slab must be (n, D) or (S, n, D) with one D, got {tuple(q.shape)}, {tuple(slab.shape)}")
    if q.ndim == 3 and slab.ndim == 3 and q.shape[0] != slab.shape[0]:
        raise ValueError(f"q and slab disagree on S: {q.shape[0]} vs {slab.shape[0]}")
    return q.shape[0] if q.ndim == 3 else slab.shape[0] if slab.ndim == 3 else 1


def _gate(lb, cut, shape: tuple[int, ...], device):
    """The gate operands as contiguous fp32 tensors of ``shape`` ((S,), or
    (Q, S) for kernel 3), or (None, None)."""
    if lb is None and cut is None:
        return None, None
    lb = torch.zeros(shape, device=device) if lb is None else torch.as_tensor(lb, device=device)
    cut = torch.full(shape, torch.inf, device=device) if cut is None else torch.as_tensor(cut, device=device)
    return lb.float().contiguous(), cut.float().contiguous()


def _scan_plain(qp: torch.Tensor, q2: torch.Tensor, sp: torch.Tensor, b2: torch.Tensor, n_sets: int,
                directed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's arithmetic on poisoned operands (q (n_q, D) or
    (S, n_q, D), slab (cap, D) or (S, cap, D), norms to match), no gate:
    each cross term one product and one add per k in order, then
    ``(q2 − 2·cross) + b2`` clamped at 0 and the two mins (``min_b`` +inf
    under ``directed``)."""
    dev = qp.device
    qb = qp if qp.ndim == 3 else qp[None]
    sb = sp if sp.ndim == 3 else sp[None]
    q2b = q2 if q2.ndim == 2 else q2[None]
    b2b = b2 if b2.ndim == 2 else b2[None]
    n_q, cap = qb.shape[1], sb.shape[1]
    cross = torch.zeros((max(qb.shape[0], sb.shape[0]), n_q, cap), device=dev)
    for k in range(qb.shape[2]):
        cross.add_(qb[:, :, None, k] * sb[:, None, :, k])
    d2 = cross.mul_(-2.0).add_(q2b[:, :, None]).add_(b2b[:, None, :]).clamp_(min=0.0)
    d2 = d2.expand(n_sets, n_q, cap)
    min_a = d2.amin(dim=2) if cap else torch.full((n_sets, n_q), torch.inf, device=dev)
    min_b = (d2.amin(dim=1) if n_q and not directed else torch.full((n_sets, cap), torch.inf, device=dev))
    return min_a, min_b


def batched_min_sqdists_mirror(
    q: torch.Tensor,
    slab: torch.Tensor,
    *,
    valid_q: torch.Tensor | None = None,
    valid_slab: torch.Tensor | None = None,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
    directed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the batched scan, gate included.

    Same operands and outputs as :func:`batched_min_sqdists`.  The cross
    term is accumulated one k at a time (product, then add) so each entry's
    bits depend only on its two rows; the rest follows the reference
    mirror's op sequence: poisoned norms, ``(q2 − 2·cross) + b2``, clamp at
    0, the two mins, and the gate forcing skipped sets to +inf.  Under
    ``directed`` ``min_b`` is +inf throughout, as the kernel's directed
    instance leaves it.
    """
    qp, q2 = _poison(q, valid_q)
    sp, b2 = _poison(slab, valid_slab)
    n_sets = _n_sets(qp, sp)
    min_a, min_b = _scan_plain(qp, q2, sp, b2, n_sets, directed)
    lb, cut = _gate(lb, cut, (n_sets,), q.device)
    if lb is not None:
        skip = ~(lb <= cut)
        min_a = torch.where(skip[:, None], torch.inf, min_a)
        min_b = torch.where(skip[:, None], torch.inf, min_b)
    return min_a, min_b


def batched_min_sqdists(
    q: torch.Tensor,
    slab: torch.Tensor,
    *,
    valid_q: torch.Tensor | None = None,
    valid_slab: torch.Tensor | None = None,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
    directed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched bidirectional min scan: ``(min_a (S, n_q), min_b (S, cap))``.

    q          — (n_q, D) shared query, or (S, n_q, D) one per set
    slab       — (S, cap, D) padded sets, or (cap, D) one set shared by all
    valid_q    — (n_q,) / (S, n_q) bool, True = real row (None ⇒ all valid)
    valid_slab — (S, cap) / (cap,) bool (None ⇒ all valid)
    lb / cut   — (S,) gate operands: set s is computed iff ``lb[s] <= cut[s]``
                 (None, None ⇒ no gate)
    directed   — row mins only: ``min_b`` comes back +inf, from the kernel's
                 directed instance and the plain version alike

    Entries of invalid rows, and every entry of a gated set, are +inf.
    Inputs of another float type are cast to fp32.  On a CPU tensor this
    runs the plain version; on a CUDA tensor it launches the kernel or
    raises.
    """
    if q.device.type == "cpu" and slab.device.type == "cpu":
        return batched_min_sqdists_mirror(q, slab, valid_q=valid_q, valid_slab=valid_slab, lb=lb, cut=cut,
                                          directed=directed)
    if q.device.type != "cuda" or slab.device != q.device:
        raise ValueError(f"q and slab must both be on one CUDA device or on the CPU, got {q.device}, {slab.device}")
    dev = q.device
    qp, q2 = _poison(q, valid_q)
    sp, b2 = _poison(slab, valid_slab)
    n_sets = _n_sets(qp, sp)
    if qp.ndim == 2:
        qp, q2 = qp.expand(n_sets, *qp.shape), q2.expand(n_sets, *q2.shape)
    if sp.ndim == 2:
        sp, b2 = sp.expand(n_sets, *sp.shape), b2.expand(n_sets, *b2.shape)
    lb, cut = _gate(lb, cut, (n_sets,), dev)
    min_a = torch.full((n_sets, qp.shape[1]), torch.inf, device=dev)
    min_b = torch.full((n_sets, sp.shape[1]), torch.inf, device=dev)
    batched_minscan(qp, q2, sp, b2, min_a, min_b, lb=lb, cut=cut, directed=directed)
    return min_a, min_b


def _finalize_lanes(mins: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """Per-lane ``exact.finalize_mins``: max over valid rows → sqrt; a lane
    with no valid row gives 0.0.  mins (S, n); valid (n,), (S, n) or None."""
    if valid is not None:
        mins = torch.where(valid, mins, -torch.inf)
    return torch.sqrt(torch.clamp(mins.amax(dim=-1), min=0.0))


def batched_bucket_hd(
    q: torch.Tensor,
    slab: torch.Tensor,
    *,
    valid_q: torch.Tensor | None = None,
    valid_slab: torch.Tensor | None = None,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
    directed: bool = False,
    use_kernel: bool = True,
) -> torch.Tensor:
    """(S,) exact (directed) Hausdorff distances of the query vs each set.

    Each lane is finalized like the single-pair paths: an empty query side
    gives 0.0, an empty set side +inf.  Gated lanes come back +inf, except
    under ``directed`` with an all-invalid query, whose 0.0 wins.
    ``directed`` runs the row-min-only scan.  ``use_kernel=False`` runs the
    plain version on any device.
    """
    scan = batched_min_sqdists if use_kernel else batched_min_sqdists_mirror
    min_a, min_b = scan(q, slab, valid_q=valid_q, valid_slab=valid_slab, lb=lb, cut=cut, directed=directed)
    h_a = _finalize_lanes(min_a, valid_q)
    if directed:
        return h_a
    return torch.maximum(h_a, _finalize_lanes(min_b, valid_slab))


# ---------------------------------------------------------------------------
# Kernel 3: a query batch against one slab.
# ---------------------------------------------------------------------------


def multiquery_minscan(
    qs: torch.Tensor,
    q2: torch.Tensor,
    slab: torch.Tensor,
    b2: torch.Tensor,
    min_a: torch.Tensor,
    min_b: torch.Tensor,
    *,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
    directed: bool = False,
    plan: BucketPlan | None = None,
) -> None:
    """One launch: fold every (query, set) pair's d² entries into ``min_a``
    / ``min_b``.

    qs (Q, n_q, D), q2 (Q, n_q), slab (S, cap, D), b2 (S, cap): contiguous
    fp32 on one CUDA device, norms +inf at invalid rows.  min_a (Q, S, n_q),
    min_b (Q, S, cap): contiguous fp32 outputs, updated in place.  lb, cut
    (Q, S): contiguous fp32 gate operands, or both None for an ungated pass.
    ``directed=True`` launches the row-min-only instance and leaves
    ``min_b`` as given.  ``plan`` overrides :func:`bucket_launch_plan`; a
    plan that does not fit the pass raises.  Raises under grad mode when an
    input requires grad (:func:`repro_torch.kernels.refuse_grad`).
    """
    refuse_grad("batched.multiquery_minscan", qs, q2, slab, b2, lb, cut)
    if not isinstance(directed, bool):
        raise TypeError(f"directed must be a bool, got {type(directed).__name__}")
    dev = qs.device
    if qs.ndim != 3 or slab.ndim != 3 or qs.shape[2] != slab.shape[2]:
        raise ValueError(f"qs, slab must be (Q, n_q, D), (S, cap, D) with one D, "
                         f"got {tuple(qs.shape)}, {tuple(slab.shape)}")
    n_queries, n_q, d = qs.shape
    n_sets, cap = slab.shape[:2]
    if max(n_queries, n_sets, n_q, cap) > _INT_MAX:
        raise ValueError(f"counts above {_INT_MAX} do not fit one launch, got {(n_queries, n_sets, n_q, cap)}")
    shapes = {"qs": (qs, (n_queries, n_q, d)), "q2": (q2, (n_queries, n_q)),
              "slab": (slab, (n_sets, cap, d)), "b2": (b2, (n_sets, cap)),
              "min_a": (min_a, (n_queries, n_sets, n_q)), "min_b": (min_b, (n_queries, n_sets, cap))}
    if (lb is None) != (cut is None):
        raise ValueError("lb and cut go together")
    if lb is not None:
        shapes.update(lb=(lb, (n_queries, n_sets)), cut=(cut, (n_queries, n_sets)))
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if plan is not None and min(n_queries, n_sets, n_q, cap):
        _check_plan(plan, n_queries, n_sets, n_q, cap, d, True)
    if dev.type != "cuda":
        raise ValueError(f"multiquery_minscan takes CUDA tensors, got {dev}")
    if n_queries == 0 or n_sets == 0 or n_q == 0 or cap == 0:
        return

    if plan is None:
        plan = _planned("multiquery_minscan", n_queries, n_sets, n_q, cap, d, True, lb is not None, directed,
                        dev.index if dev.index is not None else torch.cuda.current_device())
    qx = K._staged(qs, plan.ld)
    sx = K._staged(slab, plan.ld)
    fn = build_multiquery().multiquery_minscan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            qx.data_ptr(), q2.data_ptr(), sx.data_ptr(), b2.data_ptr(),
            None if lb is None else lb.data_ptr(), None if cut is None else cut.data_ptr(),
            min_a.data_ptr(), min_b.data_ptr(), n_queries, n_sets, n_q, cap, plan.ld,
            int(plan.resident), int(directed), plan.grid, plan.smem, plan.set_step, stream,
        )
    if err != 0:
        raise RuntimeError(f"multiquery_minscan launch failed: CUDA error {err}")
    multiquery_minscan.launches += 1


multiquery_minscan.launches = 0


def multiquery_min_sqdists_mirror(
    qs: torch.Tensor,
    slab: torch.Tensor,
    *,
    valid_qs: torch.Tensor | None = None,
    valid_slab: torch.Tensor | None = None,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
    directed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the multi-query scan, gate included: kernel
    2's plain version (:func:`batched_min_sqdists_mirror`) once per query,
    so each pair has that version's bits and the kernel's gate semantics
    (a NaN bound gates); ``min_b`` +inf under ``directed``."""
    n_queries, n_q = qs.shape[0], qs.shape[1]
    n_sets, cap = slab.shape[0], slab.shape[1]
    lb, cut = _gate(lb, cut, (n_queries, n_sets), qs.device)
    if n_queries == 0:
        return (torch.empty((0, n_sets, n_q), device=qs.device),
                torch.empty((0, n_sets, cap), device=qs.device))
    per_query = [
        batched_min_sqdists_mirror(
            qs[i], slab, valid_q=None if valid_qs is None else valid_qs[i], valid_slab=valid_slab,
            lb=None if lb is None else lb[i], cut=None if cut is None else cut[i], directed=directed,
        )
        for i in range(n_queries)
    ]
    return torch.stack([a for a, _ in per_query]), torch.stack([b for _, b in per_query])


def multiquery_min_sqdists(
    qs: torch.Tensor,
    slab: torch.Tensor,
    *,
    valid_qs: torch.Tensor | None = None,
    valid_slab: torch.Tensor | None = None,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
    directed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-query bidirectional min scan: ``(min_a (Q, S, n_q), min_b
    (Q, S, cap))``.

    qs         — (Q, n_q, D) query batch (each query a padded row prefix)
    slab       — (S, cap, D) padded bucket slab
    valid_qs   — (Q, n_q) bool, True = real row (None ⇒ all valid)
    valid_slab — (S, cap) bool (None ⇒ all valid)
    lb / cut   — (Q, S) gate operands: pair (q, s) is computed iff
                 ``lb[q, s] <= cut[q, s]`` (None, None ⇒ no gate)
    directed   — row mins only: ``min_b`` comes back +inf, from the kernel's
                 directed instance and the plain version alike

    Entries of invalid rows, and every entry of a gated pair, are +inf.
    Inputs of another float type are cast to fp32.  On a CPU tensor this
    runs the plain version; on a CUDA tensor it launches the kernel or
    raises.
    """
    if qs.device.type == "cpu" and slab.device.type == "cpu":
        return multiquery_min_sqdists_mirror(qs, slab, valid_qs=valid_qs, valid_slab=valid_slab, lb=lb, cut=cut,
                                             directed=directed)
    if qs.device.type != "cuda" or slab.device != qs.device:
        raise ValueError(f"qs and slab must both be on one CUDA device or on the CPU, got {qs.device}, {slab.device}")
    dev = qs.device
    qp, q2 = _poison(qs, valid_qs)
    sp, b2 = _poison(slab, valid_slab)
    n_queries, n_sets = qp.shape[0], sp.shape[0]
    lb, cut = _gate(lb, cut, (n_queries, n_sets), dev)
    min_a = torch.full((n_queries, n_sets, qp.shape[1]), torch.inf, device=dev)
    min_b = torch.full((n_queries, n_sets, sp.shape[1]), torch.inf, device=dev)
    multiquery_minscan(qp, q2, sp, b2, min_a, min_b, lb=lb, cut=cut, directed=directed)
    return min_a, min_b


def multiquery_bucket_hd(
    qs: torch.Tensor,
    slab: torch.Tensor,
    *,
    valid_qs: torch.Tensor | None = None,
    valid_slab: torch.Tensor | None = None,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
    directed: bool = False,
    use_kernel: bool = True,
) -> torch.Tensor:
    """(Q, S) exact (directed) Hausdorff distances of each query vs each set.

    Each pair is finalized like the single-pair paths: an empty query side
    gives 0.0, an empty set side +inf.  Gated pairs come back +inf, except
    under ``directed`` with an all-invalid query, whose 0.0 wins.
    ``directed`` runs the row-min-only scan.  ``use_kernel=False`` runs the
    plain version on any device.
    """
    scan = multiquery_min_sqdists if use_kernel else multiquery_min_sqdists_mirror
    min_a, min_b = scan(qs, slab, valid_qs=valid_qs, valid_slab=valid_slab, lb=lb, cut=cut, directed=directed)
    h_a = _finalize_lanes(min_a, None if valid_qs is None else valid_qs[:, None, :])
    if directed:
        return h_a
    return torch.maximum(h_a, _finalize_lanes(min_b, valid_slab))
