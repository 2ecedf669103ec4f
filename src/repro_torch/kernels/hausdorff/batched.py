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
``lb[q, s] <= cut[q, s]``.  The CTAs that read one set run side by side,
so the batch shares the slab through L2:

    multiquery_minscan            the launcher of ``csrc/multiquery_minscan.cu``
    multiquery_min_sqdists        the wrapper (as above)
    multiquery_bucket_hd          (Q, S) exact (directed) Hausdorff per pair
    multiquery_min_sqdists_mirror the plain version: kernel 2's plain version
                                  once per query

Both kernels share one tile body (``csrc/minscan_tile.cuh``), so a pair of
kernel 3 is bitwise kernel 2 with that query against that set.

The libraries are built from the checkout's sources at first launch
(``repro_torch.kernels._build``) and launched on PyTorch's current stream;
nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

__all__ = [
    "TILE",
    "SOURCE",
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

# Rows of the query and of a set per CTA tile.
TILE = 128
# Query tiles per set go on grid.y, which CUDA caps at 65,535.
_MAX_QUERY_ROWS = 65_535 * TILE
# Pairs of one kernel-3 launch go on grid.x, which CUDA caps at 2^31 − 1.
_MAX_PAIRS = 2**31 - 1
SOURCE = Path(__file__).resolve().parent / "csrc" / "batched_minscan.cu"
SOURCE_MULTIQUERY = SOURCE.with_name("multiquery_minscan.cu")

_lib: ctypes.CDLL | None = None
_lib_multiquery: ctypes.CDLL | None = None


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = _build.load_library("batched_minscan", [SOURCE])
        fn = lib.batched_minscan
        p = ctypes.c_void_p
        ll = ctypes.c_longlong
        i = ctypes.c_int
        fn.argtypes = [p, ll, p, ll, p, ll, p, ll, p, p, p, p, i, i, i, i, p]
        fn.restype = i
        _lib = lib
    return _lib


def build_multiquery() -> ctypes.CDLL:
    """Compile (if needed) and load the multi-query kernel library."""
    global _lib_multiquery
    if _lib_multiquery is None:
        lib = _build.load_library("multiquery_minscan", [SOURCE_MULTIQUERY])
        fn = lib.multiquery_minscan
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        _lib_multiquery = lib
    return _lib_multiquery


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
) -> None:
    """One launch: fold every set's d² entries into ``min_a`` / ``min_b``.

    q (S, n_q, D), slab (S, cap, D): fp32 on one CUDA device, each set's
    block contiguous; a set stride of 0 (``expand``) shares the operand.
    q2 (S, n_q), b2 (S, cap): fp32 squared norms, +inf at invalid rows,
    same stride rule.  min_a (S, n_q), min_b (S, cap): contiguous fp32
    outputs, updated in place.  lb, cut (S,): contiguous fp32 gate operands,
    or both None for an ungated pass.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"batched_minscan takes CUDA tensors, got {dev}")
    if q.ndim != 3 or slab.ndim != 3 or q.shape[2] != slab.shape[2] or q.shape[0] != slab.shape[0]:
        raise ValueError(f"q, slab must be (S, n, D) with one S and D, got {tuple(q.shape)}, {tuple(slab.shape)}")
    n_sets, n_q, d = q.shape
    cap = slab.shape[1]
    if n_q > _MAX_QUERY_ROWS:
        raise ValueError(f"at most {_MAX_QUERY_ROWS} query rows per launch, got {n_q}")
    qs = _set_stride("q", q, (n_sets, n_q, d), dev)
    ss = _set_stride("slab", slab, (n_sets, cap, d), dev)
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
    if n_sets == 0 or n_q == 0 or cap == 0:
        return

    fn = build().batched_minscan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q.data_ptr(), qs, q2.data_ptr(), q2s, slab.data_ptr(), ss, b2.data_ptr(), b2s,
            None if lb is None else lb.data_ptr(), None if cut is None else cut.data_ptr(),
            min_a.data_ptr(), min_b.data_ptr(), n_sets, n_q, cap, d, stream,
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


def batched_min_sqdists_mirror(
    q: torch.Tensor,
    slab: torch.Tensor,
    *,
    valid_q: torch.Tensor | None = None,
    valid_slab: torch.Tensor | None = None,
    lb: torch.Tensor | None = None,
    cut: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the batched scan, gate included.

    Same operands and outputs as :func:`batched_min_sqdists`.  The cross
    term is accumulated one k at a time (product, then add) so each entry's
    bits depend only on its two rows; the rest follows the reference
    mirror's op sequence: poisoned norms, ``(q2 − 2·cross) + b2``, clamp at
    0, the two mins, and the gate forcing skipped sets to +inf.
    """
    dev = q.device
    qp, q2 = _poison(q, valid_q)
    sp, b2 = _poison(slab, valid_slab)
    n_sets = _n_sets(qp, sp)
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
    min_b = d2.amin(dim=1) if n_q else torch.full((n_sets, cap), torch.inf, device=dev)
    lb, cut = _gate(lb, cut, (n_sets,), dev)
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched bidirectional min scan: ``(min_a (S, n_q), min_b (S, cap))``.

    q          — (n_q, D) shared query, or (S, n_q, D) one per set
    slab       — (S, cap, D) padded sets, or (cap, D) one set shared by all
    valid_q    — (n_q,) / (S, n_q) bool, True = real row (None ⇒ all valid)
    valid_slab — (S, cap) / (cap,) bool (None ⇒ all valid)
    lb / cut   — (S,) gate operands: set s is computed iff ``lb[s] <= cut[s]``
                 (None, None ⇒ no gate)

    Entries of invalid rows, and every entry of a gated set, are +inf.
    Inputs of another float type are cast to fp32.  On a CPU tensor this
    runs the plain version; on a CUDA tensor it launches the kernel or
    raises.
    """
    if q.device.type == "cpu" and slab.device.type == "cpu":
        return batched_min_sqdists_mirror(q, slab, valid_q=valid_q, valid_slab=valid_slab, lb=lb, cut=cut)
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
    batched_minscan(qp, q2, sp, b2, min_a, min_b, lb=lb, cut=cut)
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
    ``use_kernel=False`` runs the plain version on any device.
    """
    scan = batched_min_sqdists if use_kernel else batched_min_sqdists_mirror
    min_a, min_b = scan(q, slab, valid_q=valid_q, valid_slab=valid_slab, lb=lb, cut=cut)
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
) -> None:
    """One launch: fold every (query, set) pair's d² entries into ``min_a``
    / ``min_b``.

    qs (Q, n_q, D), q2 (Q, n_q), slab (S, cap, D), b2 (S, cap): contiguous
    fp32 on one CUDA device, norms +inf at invalid rows.  min_a (Q, S, n_q),
    min_b (Q, S, cap): contiguous fp32 outputs, updated in place.  lb, cut
    (Q, S): contiguous fp32 gate operands, or both None for an ungated pass.
    """
    dev = qs.device
    if dev.type != "cuda":
        raise ValueError(f"multiquery_minscan takes CUDA tensors, got {dev}")
    if qs.ndim != 3 or slab.ndim != 3 or qs.shape[2] != slab.shape[2]:
        raise ValueError(f"qs, slab must be (Q, n_q, D), (S, cap, D) with one D, "
                         f"got {tuple(qs.shape)}, {tuple(slab.shape)}")
    n_queries, n_q, d = qs.shape
    n_sets, cap = slab.shape[:2]
    if n_q > _MAX_QUERY_ROWS:
        raise ValueError(f"at most {_MAX_QUERY_ROWS} query rows per launch, got {n_q}")
    if n_queries * n_sets > _MAX_PAIRS:
        raise ValueError(f"at most {_MAX_PAIRS} (query, set) pairs per launch, got {n_queries * n_sets}")
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
    if n_queries == 0 or n_sets == 0 or n_q == 0 or cap == 0:
        return

    fn = build_multiquery().multiquery_minscan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            qs.data_ptr(), q2.data_ptr(), slab.data_ptr(), b2.data_ptr(),
            None if lb is None else lb.data_ptr(), None if cut is None else cut.data_ptr(),
            min_a.data_ptr(), min_b.data_ptr(), n_queries, n_sets, n_q, cap, d, stream,
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the multi-query scan, gate included: kernel
    2's plain version (:func:`batched_min_sqdists_mirror`) once per query,
    so each pair has that version's bits and the kernel's gate semantics
    (a NaN bound gates)."""
    n_queries, n_q = qs.shape[0], qs.shape[1]
    n_sets, cap = slab.shape[0], slab.shape[1]
    lb, cut = _gate(lb, cut, (n_queries, n_sets), qs.device)
    if n_queries == 0:
        return (torch.empty((0, n_sets, n_q), device=qs.device),
                torch.empty((0, n_sets, cap), device=qs.device))
    per_query = [
        batched_min_sqdists_mirror(
            qs[i], slab, valid_q=None if valid_qs is None else valid_qs[i], valid_slab=valid_slab,
            lb=None if lb is None else lb[i], cut=None if cut is None else cut[i],
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-query bidirectional min scan: ``(min_a (Q, S, n_q), min_b
    (Q, S, cap))``.

    qs         — (Q, n_q, D) query batch (each query a padded row prefix)
    slab       — (S, cap, D) padded bucket slab
    valid_qs   — (Q, n_q) bool, True = real row (None ⇒ all valid)
    valid_slab — (S, cap) bool (None ⇒ all valid)
    lb / cut   — (Q, S) gate operands: pair (q, s) is computed iff
                 ``lb[q, s] <= cut[q, s]`` (None, None ⇒ no gate)

    Entries of invalid rows, and every entry of a gated pair, are +inf.
    Inputs of another float type are cast to fp32.  On a CPU tensor this
    runs the plain version; on a CUDA tensor it launches the kernel or
    raises.
    """
    if qs.device.type == "cpu" and slab.device.type == "cpu":
        return multiquery_min_sqdists_mirror(qs, slab, valid_qs=valid_qs, valid_slab=valid_slab, lb=lb, cut=cut)
    if qs.device.type != "cuda" or slab.device != qs.device:
        raise ValueError(f"qs and slab must both be on one CUDA device or on the CPU, got {qs.device}, {slab.device}")
    dev = qs.device
    qp, q2 = _poison(qs, valid_qs)
    sp, b2 = _poison(slab, valid_slab)
    n_queries, n_sets = qp.shape[0], sp.shape[0]
    lb, cut = _gate(lb, cut, (n_queries, n_sets), dev)
    min_a = torch.full((n_queries, n_sets, qp.shape[1]), torch.inf, device=dev)
    min_b = torch.full((n_queries, n_sets, sp.shape[1]), torch.inf, device=dev)
    multiquery_minscan(qp, q2, sp, b2, min_a, min_b, lb=lb, cut=cut)
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
    ``use_kernel=False`` runs the plain version on any device.
    """
    scan = multiquery_min_sqdists if use_kernel else multiquery_min_sqdists_mirror
    min_a, min_b = scan(qs, slab, valid_qs=valid_qs, valid_slab=valid_slab, lb=lb, cut=cut)
    h_a = _finalize_lanes(min_a, None if valid_qs is None else valid_qs[:, None, :])
    if directed:
        return h_a
    return torch.maximum(h_a, _finalize_lanes(min_b, valid_slab))
