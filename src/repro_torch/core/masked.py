"""Masked (padding-tolerant) exact HD and ProHD on padded clouds, over lanes.

Counterpart of ``repro/core/masked.py``.  The corpus index works on padded
buckets with row-validity masks; every function here computes on the
VALID rows only, so any padding layout gives the same answer.

Where the reference writes one pair and lets ``jax.vmap`` batch it, the
port writes the lane axis out: an operand is either shared by every lane,
(n, D) with an (n,) mask, or one per lane, (S, n, D) with an (S, n) mask.

- ``masked_exact_hd``: the exact (directed) HD of one padded pair through
  a registered backend (:data:`EXACT_MASKED_BACKENDS`).
- ``masked_exact_hd_batched``: (S,) exact HD of a query against a bucket
  slab, with the per-set gate ``lb <= cut`` (gated lanes give the +inf
  sentinel; under ``directed`` an all-invalid query's 0.0 wins).  The
  ``batched_*`` backends run it as one pass of the batched bucket scan
  (``kernels/hausdorff/batched.py``), the ``multiquery_*`` backends as a
  one-query pass of the multi-query scan; the others run each lane's pair
  in turn and apply the gate as a lane select.
- ``masked_exact_hd_multiquery``: (Q, S) exact HD of a query batch against
  a bucket slab with a per-(query, set) gate — one pass of the multi-query
  scan on the ``multiquery_*`` backends, one ``masked_exact_hd_batched``
  per query on the others.
- ``masked_prohd_certified``: the masked ProHD triple (hd, lower, upper)
  per lane — masked moments, Gram and ``torch.linalg.eigh`` batched over
  the lanes, α-extreme selection with the static capacity, the exact subset
  passes through the chosen backend, and the 1-D projected HD by
  sort/searchsorted.

Empty-side conventions (``exact.finalize_mins``): an all-invalid QUERY
side reduces to 0.0; an all-invalid TARGET side to +inf.

Within the port, a ``batched_*`` or ``multiquery_*`` lane's bits depend on
nothing but its own rows (the scan accumulates each dot product in one
fixed k order), so padded vs raw and batch size or composition cannot move
them.  The other
backends go through ``torch.matmul``, whose CPU bits can change with the
GEMM shape; across backends the contract is ``fp_value_margin``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import exact, selection
from repro_torch.device import strict_fp32
from repro_torch.kernels.hausdorff import batched

__all__ = [
    "MaskedCertificate",
    "EXACT_MASKED_BACKENDS",
    "BATCHED_NATIVE_BACKENDS",
    "MULTIQUERY_NATIVE_BACKENDS",
    "masked_exact_hd",
    "masked_exact_hd_batched",
    "masked_exact_hd_multiquery",
    "masked_centroid",
    "masked_direction_set",
    "masked_projected_hd",
    "masked_additive_bound",
    "masked_prohd_certified",
]

# Same large-but-finite sentinel as the reference: ±inf would poison
# interval arithmetic (inf − inf = NaN) in all-invalid corner cases.
_BIG = 1e30


def _masked_exact_dense(a, b, valid_a, valid_b, *, directed, block_a, block_b):
    del block_a, block_b  # dense is one unblocked GEMM per direction
    if directed:
        return exact.directed_hd_dense(a, b, valid_a=valid_a, valid_b=valid_b)
    return exact.hausdorff_dense(a, b, valid_a=valid_a, valid_b=valid_b)


def _masked_exact_tiled(a, b, valid_a, valid_b, *, directed, block_a, block_b):
    if directed:
        return exact.directed_hd_tiled(a, b, valid_a=valid_a, valid_b=valid_b, block=block_b)
    return exact.hausdorff_fused_tiled(
        a, b, valid_a=valid_a, valid_b=valid_b, block_a=block_a, block_b=block_b
    )


def _masked_exact_fused_mirror(a, b, valid_a, valid_b, *, directed, block_a, block_b):
    min_a, min_b = exact.fused_min_sqdists_tiled(
        a, b, valid_a=valid_a, valid_b=valid_b, block_a=block_a, block_b=block_b
    )
    h = exact.finalize_mins(min_a, valid_a)
    if directed:
        return h
    return torch.maximum(h, exact.finalize_mins(min_b, valid_b))


def _batched_pair(use_kernel: bool):
    """Single-pair view of the batched bucket scan: a slab of one set."""

    def impl(a, b, valid_a, valid_b, *, directed, block_a, block_b):
        del block_a, block_b  # the scan's tile is fixed
        vb = None if valid_b is None else valid_b[None]
        return batched.batched_bucket_hd(
            a, b[None], valid_q=valid_a, valid_slab=vb, directed=directed, use_kernel=use_kernel,
        )[0]

    return impl


def _multiquery_pair(use_kernel: bool):
    """Single-pair view of the multi-query bucket scan: Q = 1, S = 1.  It
    lets the conformance sweeps over this registry hold the query-axis
    scan to the same contract as every other backend."""

    def impl(a, b, valid_a, valid_b, *, directed, block_a, block_b):
        del block_a, block_b  # the scan's tile is fixed
        va = None if valid_a is None else valid_a[None]
        vb = None if valid_b is None else valid_b[None]
        return batched.multiquery_bucket_hd(
            a[None], b[None], valid_qs=va, valid_slab=vb, directed=directed, use_kernel=use_kernel,
        )[0, 0]

    return impl


# Registry: name -> masked exact reduction of one padded pair.  "dense" and
# "tiled" mirror the front door's exact/dense and exact/tiled dispatches;
# "fused_mirror" is the raw min-vector reduction of kernel 1's plain
# version.  "batched_cuda" is the batched bucket kernel (kernel 2) and
# "multiquery_cuda" the multi-query bucket kernel (kernel 3) — their
# wrappers run the plain versions on CPU tensors — and "batched_mirror" /
# "multiquery_mirror" are those plain versions on any device.
EXACT_MASKED_BACKENDS = {
    "dense": _masked_exact_dense,
    "tiled": _masked_exact_tiled,
    "fused_mirror": _masked_exact_fused_mirror,
    "batched_cuda": _batched_pair(True),
    "batched_mirror": _batched_pair(False),
    "multiquery_cuda": _multiquery_pair(True),
    "multiquery_mirror": _multiquery_pair(False),
}

# Backends with a native slab-axis formulation: one pass per bucket with
# the per-set gate in the scan, instead of one pair per lane.
BATCHED_NATIVE_BACKENDS = ("batched_cuda", "batched_mirror")

# Backends with a native query-axis × slab-axis formulation: one pass
# measures a query batch against a bucket with a per-(query, set) gate.
MULTIQUERY_NATIVE_BACKENDS = ("multiquery_cuda", "multiquery_mirror")


def _check_backend(backend: str) -> None:
    if backend not in EXACT_MASKED_BACKENDS:
        raise ValueError(
            f"unknown masked exact backend {backend!r}; expected one of "
            f"{tuple(EXACT_MASKED_BACKENDS)}"
        )


def masked_exact_hd(
    a,
    b,
    *,
    valid_a=None,
    valid_b=None,
    directed: bool = False,
    backend: str = "dense",
    block_a: int = 2048,
    block_b: int = 2048,
) -> torch.Tensor:
    """EXACT (directed) Hausdorff distance of one padded masked pair."""
    _check_backend(backend)
    return EXACT_MASKED_BACKENDS[backend](
        a, b, valid_a, valid_b, directed=directed, block_a=block_a, block_b=block_b
    )


def _lane(x, s: int, per_lane: bool):
    return None if x is None else (x[s] if per_lane else x)


def masked_exact_hd_batched(
    q,
    slab,
    *,
    valid_q=None,
    valid_slab=None,
    lb=None,
    cut=None,
    directed: bool = False,
    backend: str = "batched_mirror",
    block_a: int = 2048,
    block_b: int = 2048,
) -> torch.Tensor:
    """(S,) EXACT (directed) HD of a query against a padded bucket slab.

    q (n_q, D) shared or (S, n_q, D) per lane; slab (S, cap, D) or (cap, D)
    shared; masks to match.  ``lb`` / ``cut`` (S,): lane s is measured iff
    ``lb[s] <= cut[s]`` (a NaN bound gates too); a gated lane gives +inf,
    or 0.0 under ``directed`` when its query side is all-invalid.  The
    ``batched_*`` backends run the whole slab in one scan, and so do the
    ``multiquery_*`` ones for a shared query and a per-lane slab (the Q = 1
    view of the query-axis scan, which lets them serve as rungs of the
    single-query cascade's ladder); every other backend and form measures
    one pair per lane.
    """
    _check_backend(backend)
    if backend in BATCHED_NATIVE_BACKENDS:
        return batched.batched_bucket_hd(
            q, slab, valid_q=valid_q, valid_slab=valid_slab, lb=lb, cut=cut,
            directed=directed, use_kernel=backend == "batched_cuda",
        )
    if backend in MULTIQUERY_NATIVE_BACKENDS and q.ndim == 2 and slab.ndim == 3:
        return masked_exact_hd_multiquery(
            q[None], slab,
            valid_qs=None if valid_q is None else valid_q[None], valid_slab=valid_slab,
            lb=None if lb is None else torch.as_tensor(lb, device=q.device)[None],
            cut=None if cut is None else torch.as_tensor(cut, device=q.device)[None],
            directed=directed, backend=backend,
        )[0]
    q_lanes, s_lanes = q.ndim == 3, slab.ndim == 3
    n_sets = q.shape[0] if q_lanes else slab.shape[0] if s_lanes else 1
    vals = torch.stack([
        masked_exact_hd(
            _lane(q, s, q_lanes), _lane(slab, s, s_lanes),
            valid_a=_lane(valid_q, s, valid_q is not None and valid_q.ndim == 2),
            valid_b=_lane(valid_slab, s, valid_slab is not None and valid_slab.ndim == 2),
            directed=directed, backend=backend, block_a=block_a, block_b=block_b,
        )
        for s in range(n_sets)
    ]) if n_sets else torch.zeros((0,), device=q.device)
    if lb is None and cut is None:
        return vals
    dev = vals.device
    lb = torch.zeros((n_sets,), device=dev) if lb is None else torch.as_tensor(lb, device=dev).float()
    cut = torch.full((n_sets,), torch.inf, device=dev) if cut is None else torch.as_tensor(cut, device=dev).float()
    # Same corner precedence as the native scan: under ``directed`` an
    # all-invalid query side's 0.0 beats the gated +inf sentinel.
    if directed and valid_q is not None:
        empty_q = ~valid_q.any(dim=-1)
        sentinel = torch.where(empty_q, 0.0, torch.inf)
    else:
        sentinel = torch.tensor(torch.inf, device=dev)
    return torch.where(lb <= cut, vals, sentinel)


def masked_exact_hd_multiquery(
    qs,
    slab,
    *,
    valid_qs=None,
    valid_slab=None,
    lb=None,
    cut=None,
    directed: bool = False,
    backend: str = "multiquery_mirror",
    block_a: int = 2048,
    block_b: int = 2048,
) -> torch.Tensor:
    """(Q, S) EXACT (directed) HD of a query batch against a padded bucket
    slab — the multi-query cascade's stage-2a entry.

    qs (Q, n_q, D) with ``valid_qs`` (Q, n_q); slab (S, cap, D) with
    ``valid_slab`` (S, cap).  ``lb`` / ``cut`` (Q, S): pair (q, s) is
    measured iff ``lb[q, s] <= cut[q, s]``, else it gives the +inf sentinel
    (0.0 under ``directed`` for an all-invalid query).  The
    ``multiquery_*`` backends run the whole block in one scan; every other
    backend runs :func:`masked_exact_hd_batched` once per query.
    """
    _check_backend(backend)
    if backend in MULTIQUERY_NATIVE_BACKENDS:
        return batched.multiquery_bucket_hd(
            qs, slab, valid_qs=valid_qs, valid_slab=valid_slab, lb=lb, cut=cut,
            directed=directed, use_kernel=backend == "multiquery_cuda",
        )
    if qs.shape[0] == 0:
        return torch.zeros((0, slab.shape[0]), device=qs.device)
    return torch.stack([
        masked_exact_hd_batched(
            qs[i], slab, valid_q=_lane(valid_qs, i, True), valid_slab=valid_slab,
            lb=_lane(lb, i, True), cut=_lane(cut, i, True), directed=directed,
            backend=backend, block_a=block_a, block_b=block_b,
        )
        for i in range(qs.shape[0])
    ])


# ---------------------------------------------------------------------------
# masked ProHD, lanes written out
# ---------------------------------------------------------------------------


def masked_centroid(points: torch.Tensor, valid_f: torch.Tensor) -> torch.Tensor:
    """Mean over valid rows; points (..., n, D), float mask (..., n)."""
    s = torch.sum(points * valid_f[..., None], dim=-2)
    return s / torch.clamp(torch.sum(valid_f, dim=-1), min=1.0)[..., None]


def masked_direction_set(a, va_f, b, vb_f, m: int) -> torch.Tensor:
    """Centroid direction + top-m masked-Gram PCA directions, (S, D, m+1).

    a, b: (S, n, D) lanes (shared operands expanded by the caller); the
    means and the Gram matrix accumulate valid rows only.  ``eigh`` runs
    batched over the lanes; eigenvectors are defined up to sign, which
    selection (both tails), the projected HD and the bound do not see.
    """
    strict_fp32()
    ca = masked_centroid(a, va_f)
    cb = masked_centroid(b, vb_f)
    u0 = cb - ca
    norm = torch.linalg.vector_norm(u0, dim=-1, keepdim=True)
    e1 = torch.zeros_like(u0)
    e1[..., 0] = 1.0
    u0 = torch.where(norm < 1e-9, e1, u0 / torch.clamp(norm, min=1e-9))

    z = torch.cat([a, b], dim=-2)
    vz = torch.cat([va_f, vb_f], dim=-1)
    mean = torch.sum(z * vz[..., None], dim=-2) / torch.clamp(torch.sum(vz, dim=-1), min=1.0)[..., None]
    zc = (z - mean[..., None, :]) * vz[..., None]
    gram = zc.transpose(-1, -2) @ zc
    _, v = torch.linalg.eigh(gram)  # ascending
    return torch.cat([u0[..., None], v.flip(-1)[..., :m]], dim=-1)


def _masked_directed_hd_1d(pa, va, pb, vb) -> torch.Tensor:
    """max over valid a of min over valid b of |pa − pb|, per lane and
    direction.  pa (S, m1, n_a), va (S, n_a); pb (S, m1, n_b), vb (S, n_b)
    → (S, m1).

    Invalid targets are +BIG-sentineled so they sort to the tail, and the
    candidate indices are clipped into the valid prefix, so every query
    measures a real valid target.  Invalid queries take −inf in the max.
    The result is clamped at 0, and a lane with no valid target gives 0.0
    (the empty-set convention of ``exact.finalize_mins``).
    """
    pbs = torch.sort(torch.where(vb[:, None, :], pb, _BIG), dim=-1).values
    n_valid = vb.sum(dim=-1)
    hi = torch.clamp(n_valid - 1, min=0)[:, None, None]
    pos = torch.searchsorted(pbs.contiguous(), pa.contiguous())
    left = torch.gather(pbs, -1, torch.minimum(torch.clamp(pos - 1, min=0), hi))
    right = torch.gather(pbs, -1, torch.minimum(pos, hi))
    nearest = torch.minimum(torch.abs(pa - left), torch.abs(pa - right))
    nearest = torch.where(va[:, None, :], nearest, -torch.inf)
    best = torch.clamp(nearest.amax(dim=-1), min=0.0)
    return torch.where(n_valid[:, None] > 0, best, 0.0)


def masked_projected_hd(proj_a, valid_a, proj_b, valid_b, *, directed: bool = False):
    """Per lane, max_u H_u over the direction columns, valid rows only —
    certified ≤ H.  proj (S, n, m1), valid (S, n) → (S,)."""
    pa, pb = proj_a.transpose(-1, -2), proj_b.transpose(-1, -2)
    fwd = _masked_directed_hd_1d(pa, valid_a, pb, valid_b)
    if directed:
        return fwd.amax(dim=-1)
    bwd = _masked_directed_hd_1d(pb, valid_b, pa, valid_a)
    return torch.maximum(fwd, bwd).amax(dim=-1)


def _masked_delta(points, projs, valid) -> torch.Tensor:
    """Per-direction max orthogonal deviation over VALID rows, (S, m1)."""
    sq_norms = torch.sum(points * points, dim=-1, keepdim=True)
    orth_sq = torch.clamp(sq_norms - projs**2, min=0.0)
    orth_sq = torch.where(valid[..., None], orth_sq, -torch.inf)
    return torch.sqrt(torch.clamp(orth_sq.amax(dim=-2), min=0.0))


def masked_additive_bound(a, proj_a, valid_a, b, proj_b, valid_b) -> torch.Tensor:
    """Per lane, 2 · min_u max(δ_A(u), δ_B(u)) over valid rows (Eq. 5)."""
    da = _masked_delta(a, proj_a, valid_a)
    db = _masked_delta(b, proj_b, valid_b)
    return 2.0 * torch.maximum(da, db).amin(dim=-1)


class MaskedCertificate(NamedTuple):
    """ProHD estimate + §II-E certificate on masked clouds, per lane.

    ``hd`` (full-inner subset estimate) and ``lower`` (max_u H_u) are both
    certified lower bounds on the true masked H; ``upper`` bounds it from
    above.  For directed queries the same holds against h(A→B).
    """

    hd: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor


def _extreme_mask_lanes(x: torch.Tensor, k: int) -> torch.Tensor:
    """(S, n) bool: the k smallest and k largest entries of each lane."""
    k = min(k, x.shape[-1])
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    mask.scatter_(-1, torch.topk(x, k, dim=-1).indices, True)
    mask.scatter_(-1, torch.topk(-x, k, dim=-1).indices, True)
    return mask


def _select_extreme_mask(proj, valid, k_centroid: int, k_pca: int):
    """Union of per-direction α-extreme masks, invalid rows excluded.
    proj (S, n, m1), valid (S, n) → (S, n)."""
    mask = torch.zeros(valid.shape, dtype=torch.bool, device=proj.device)
    for col in range(proj.shape[-1]):
        k = k_centroid if col == 0 else k_pca
        hi = torch.where(valid, proj[..., col], -_BIG)
        lo = torch.where(valid, proj[..., col], _BIG)
        mask |= _extreme_mask_lanes(hi, k) & valid
        mask |= _extreme_mask_lanes(-lo, k) & valid
    return mask


def _take_selected_lanes(points, mask, capacity: int):
    """Per lane, the selected rows packed to the front in their original
    order into a static ``capacity``; the tail repeats the first selected
    row, masked out by the returned validity.  (S, n, D), (S, n) →
    (S, cap, D), (S, cap)."""
    capacity = min(capacity, points.shape[-2])
    m8 = mask.to(torch.int8)
    order = torch.argsort(1 - m8, dim=-1, stable=True)[..., :capacity]
    valid = torch.gather(mask, -1, order)
    first = torch.argmax(m8, dim=-1, keepdim=True)
    safe = torch.where(valid, order, first)
    return torch.gather(points, -2, safe[..., None].expand(*safe.shape, points.shape[-1])), valid


def masked_prohd_certified(
    a,
    valid_a,
    b,
    valid_b,
    *,
    alpha: float,
    m: int,
    directed: bool = False,
    block: int = 2048,
    backend: str = "tiled",
) -> MaskedCertificate:
    """Masked ProHD per lane: subset estimate + certified interval.

    a: (n_a, D) shared or (S, n_a, D) per lane, with a bool ``valid_a`` to
    match (True = real row); the same for b.  With both operands shared the
    fields are scalars, else (S,).  ``alpha`` / ``m`` as in ``ProHDConfig``
    (k counts from the PADDED sizes; a looser α on a sparse buffer selects
    more rows, never fewer).  ``backend`` names the masked exact reduction
    of the two directed subset passes (the cascade passes its resolved
    bucket backend, so stage 1 runs the same scan as stage 2a).
    """
    _check_backend(backend)
    strict_fp32()
    a = a.float()
    b = b.float()
    unbatched = a.ndim == 2 and b.ndim == 2
    n_sets = a.shape[0] if a.ndim == 3 else b.shape[0] if b.ndim == 3 else 1
    n_a, d = a.shape[-2], a.shape[-1]
    n_b = b.shape[-2]
    # Lane views (no copies) of every operand, for the per-lane statistics.
    al, bl = a.expand(n_sets, n_a, d), b.expand(n_sets, n_b, d)
    val_a, val_b = valid_a.expand(n_sets, n_a), valid_b.expand(n_sets, n_b)
    va_f, vb_f = val_a.float(), val_b.float()

    dirs = masked_direction_set(al, va_f, bl, vb_f, m)
    proj_a = al @ dirs
    proj_b = bl @ dirs

    k_a = selection.alpha_count(n_a, alpha)
    k_b = selection.alpha_count(n_b, alpha)
    k_a_pca = max(1, k_a // max(m, 1))
    k_b_pca = max(1, k_b // max(m, 1))
    mask_a = _select_extreme_mask(proj_a, val_a, k_a, k_a_pca)
    a_sel, va_sel = _take_selected_lanes(al, mask_a, selection.selection_capacity(n_a, m, alpha))
    va_sel = va_sel & mask_a.any(dim=-1, keepdim=True)

    def _directed(qs, vqs, ts, vts):
        return masked_exact_hd_batched(
            qs, ts, valid_q=vqs, valid_slab=vts, directed=True,
            backend=backend, block_a=block, block_b=block,
        )

    if directed:
        hd = _directed(a_sel, va_sel, b, valid_b)
    else:
        mask_b = _select_extreme_mask(proj_b, val_b, k_b, k_b_pca)
        b_sel, vb_sel = _take_selected_lanes(bl, mask_b, selection.selection_capacity(n_b, m, alpha))
        vb_sel = vb_sel & mask_b.any(dim=-1, keepdim=True)
        # Full-inner mode (queries from the subset against the full other
        # cloud): never overestimates, so hd is itself a certified lower
        # bound.  The full side keeps its shared or per-lane form.
        hd = torch.maximum(
            _directed(a_sel, va_sel, b, valid_b),
            _directed(b_sel, vb_sel, a, valid_a),
        )

    lower = masked_projected_hd(proj_a, val_a, proj_b, val_b, directed=directed)
    upper = lower + masked_additive_bound(al, proj_a, val_a, bl, proj_b, val_b)
    if unbatched:
        return MaskedCertificate(hd=hd[0], lower=lower[0], upper=upper[0])
    return MaskedCertificate(hd=hd, lower=lower, upper=upper)
