"""Multi-device ProHD and exact HD over ``torch.distributed`` — the paper's
§Parallelism.

Counterpart of ``repro/core/distributed.py``.  The reference's
``shard_map`` over a ``Mesh`` becomes SPMD: every rank of the mesh's batch
group calls the same function with its OWN rows (a :class:`ShardedCloud`)
and gets the same replicated result.  ``batch_axes`` names the
``DeviceMesh`` dims whose ranks form the group the collectives run over;
several dims are one flattened group, as in the reference's multi-axis
case.  Local row counts are equal on every rank (``shard_map``'s rule), so
the global padded count is ``n_local × group size``; per-rank ``valid``
masks make the padding explicit, and padding rows may hold garbage (NaN):
the masks go down to kernel 1's wrapper, which zeroes those rows and
poisons their norms.

Phase → collective map (the reference's ``psum`` / ``pmin`` / ``pmax`` /
``all_gather`` / ``ppermute`` are ``all_reduce(SUM | MIN | MAX)``,
``all_gather`` and ``batch_isend_irecv`` to the next rank of the group):

  centroids        local masked sums           → all_reduce SUM
  PCA              local centred Gram (D×D)    → all_reduce SUM, ``eigh``
                   on every rank, group rank 0's directions broadcast so
                   every rank projects on the same bits
  selection        local top-k per direction   → all_gather of (P, k)
                   values, global threshold → local membership masks
  subset HD        all_gather of the selected rows; every rank scans them
                   against its LOCAL rows (kernel 1's directed row-min
                   instance) → all_reduce MIN → max
  exact HD (ring)  the b-blocks travel the ring with their running
                   column mins: each step is ONE bidirectional kernel-1
                   scan of the local a-rows against the visiting block,
                   its row mins folded into the local a-mins and its
                   column mins into the block's; after P steps every
                   block has met every a-row → all_reduce MAX

The ring differs from the reference's in one way: the reference runs two
rings of directed scans (h(A→B) and h(B→A)), each moving whole blocks;
here one bidirectional scan per step serves both directions, so the ring
does half the scan work and moves one cloud.  At world size 1 it is one
bidirectional scan and no send.

Guarantees carry over: threshold selection picks a superset of the exact
global top-k under ties, and queries-vs-full never overestimates, so the
distributed estimate equals the single-device one up to fp reduction order.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core import projections
from repro_torch.core import selection as sel_mod
from repro_torch.core.exact import finalize_mins
from repro_torch.core.prohd import ProHDConfig
from repro_torch.device import strict_fp32
from repro_torch.kernels.hausdorff import ops as hd_ops

__all__ = [
    "ShardedCloud",
    "batch_group",
    "batch_size",
    "distributed_prohd",
    "distributed_exact_hd",
]

_NEG = float("-inf")
_POS = float("inf")

# Flattened batch groups per mesh, keyed by the batch axes; an entry lives
# as long as its mesh.
_FLAT_GROUPS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


class ShardedCloud(NamedTuple):
    """This rank's rows of a row-sharded cloud and their validity (True =
    real row); ``points`` (n_local, D), ``valid`` (n_local,) bool."""

    points: torch.Tensor
    valid: torch.Tensor


def _dim_sizes(mesh, batch_axes: Sequence[str]) -> list[int]:
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(batch_axes)
    if not axes:
        raise ValueError("batch_axes must name at least one mesh dim")
    missing = [ax for ax in axes if ax not in names]
    if missing:
        raise ValueError(
            f"batch axes {missing} are not dims of the mesh (dims {names}); "
            "name the DeviceMesh dims that row-shard the clouds"
        )
    return [int(mesh.mesh.shape[names.index(ax)]) for ax in axes]


def batch_size(mesh, batch_axes: Sequence[str] = ("data",)) -> int:
    """Ranks in the mesh's batch group (the product of the named dims)."""
    n = 1
    for s in _dim_sizes(mesh, batch_axes):
        n *= s
    return n


def batch_group(mesh, batch_axes: Sequence[str] = ("data",)):
    """The process group over ``batch_axes`` that holds this rank.

    One dim is the mesh's own group of that dim.  Several dims are flattened
    into one group per combination of the other dims' coordinates, made
    once per mesh and axes by ``new_subgroups_by_enumeration`` (a
    collective of the whole world, so every rank must ask in the same
    order, as SPMD callers do) and cached for as long as the mesh lives.
    """
    _dim_sizes(mesh, batch_axes)
    axes = tuple(batch_axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    flat = _FLAT_GROUPS.setdefault(mesh, {})
    # a mesh equal to one of a process group since destroyed must not get its groups
    if axes in flat and flat[axes] not in dist.distributed_c10d._world.pg_map:
        del flat[axes]
    if axes not in flat:
        names = tuple(mesh.mesh_dim_names)
        dims = [names.index(ax) for ax in axes]
        others = [i for i in range(mesh.mesh.ndim) if i not in dims]
        # the mesh's rank table is host data: read it outside any dispatch mode
        # (under a FakeTensorMode, as in the dry run, it would turn fake)
        with _disable_current_modes():
            rows = mesh.mesh.permute(others + dims).reshape(-1, batch_size(mesh, axes)).tolist()
        flat[axes], _ = dist.new_subgroups_by_enumeration(rows)
    return flat[axes]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _all_gather_list(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t``, in group-rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 (the reference's
    ``all_gather(..., tiled=True)``)."""
    return torch.cat(_all_gather_list(t, group))


def _all_gather_mask(v: torch.Tensor, group) -> torch.Tensor:
    # masks travel as uint8: not every backend moves bool tensors
    return _all_gather_cat(v.to(torch.uint8), group).to(torch.bool)


def _ring_exchange(tensors: list[torch.Tensor], group, tag0: int = 0):
    """Post sends of ``tensors`` to the next rank of the group and receives
    of their like from the previous one; returns (received, requests)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group, tag=tag0 + i) for i, t in enumerate(tensors)]
    ops += [dist.P2POp(dist.irecv, r, prv, group, tag=tag0 + i) for i, r in enumerate(recv)]
    return recv, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


# ---------------------------------------------------------------------------
# ProHD
# ---------------------------------------------------------------------------


def _masked_centroid(pts, valid, group):
    """Global mean of the valid rows; sum and count in one all_reduce."""
    p32 = torch.where(valid[:, None], pts.float(), 0.0)
    stats = torch.cat([p32.sum(dim=0), valid.sum().float()[None]])
    dist.all_reduce(stats, op=dist.ReduceOp.SUM, group=group)
    return stats[:-1] / torch.clamp(stats[-1], min=1.0)


def _global_gram_directions(a, va, b, vb, m: int, group):
    """Centroid direction + top-m eigenvectors of the global centred Gram,
    (D, m+1); group rank 0's bits on every rank."""
    ca = _masked_centroid(a, va, group)
    cb = _masked_centroid(b, vb, group)
    u0 = cb - ca
    norm = torch.linalg.vector_norm(u0)
    e1 = torch.zeros_like(u0)
    e1[0] = 1.0
    u0 = torch.where(norm < 1e-9, e1, u0 / torch.clamp(norm, min=1e-9))

    z = torch.cat([a, b]).float()
    vz = torch.cat([va, vb])
    mean = _masked_centroid(z, vz, group)
    zc = torch.where(vz[:, None], z - mean, 0.0)
    del z
    gram = zc.T @ zc
    del zc
    dist.all_reduce(gram, op=dist.ReduceOp.SUM, group=group)
    _, v = torch.linalg.eigh(gram)  # ascending eigenvalues
    dirs = torch.cat([u0[:, None], v.flip(1)[:, :m]], dim=1).contiguous()
    dist.broadcast(dirs, src=dist.get_global_rank(group, 0), group=group)
    return dirs


def _global_thresholds(vals, k: int, group):
    """k-th largest of each column of ``vals`` (n_local, c) over every
    rank's rows, (c,): local top-k, −inf padded to k, all_gather, top-k."""
    cols = vals.T.contiguous()  # (c, n_local)
    k_local = min(k, cols.shape[1])
    top = torch.topk(cols, k_local, dim=1).values
    if k_local < k:
        top = torch.nn.functional.pad(top, (0, k - k_local), value=_NEG)
    gathered = torch.cat(_all_gather_list(top, group), dim=1)  # (c, P·k)
    return torch.topk(gathered, k, dim=1).values[:, k - 1]


def _select_local_mask(projs, valid, n_global: int, alpha: float, alpha_pca: float, group):
    """Local membership of the global α-extremes (Alg. 1/2/3): column 0 at
    fraction α, the PCA columns at α_pca, each end by threshold."""
    mask = torch.zeros(projs.shape[:1], dtype=torch.bool, device=projs.device)
    groups = [(projs[:, :1], alpha)]
    if projs.shape[1] > 1:
        groups.append((projs[:, 1:], alpha_pca))
    for p, frac in groups:
        k = sel_mod.alpha_count(n_global, frac)
        hi = _global_thresholds(torch.where(valid[:, None], p, _NEG), k, group)
        lo = -_global_thresholds(torch.where(valid[:, None], -p, _NEG), k, group)
        mask |= valid & ((p >= hi) | (p <= lo)).any(dim=1)
    return mask


def _gather_selected(points, mask, capacity: int, group):
    """This rank's selected rows packed to ``capacity``, gathered from every
    rank; a rank with no selected row contributes no valid row."""
    pts, valid = sel_mod.take_selected(points, mask, capacity)
    return _all_gather_cat(pts, group), _all_gather_mask(valid & mask.any(), group)


def _queries_vs_sharded_db(queries, q_valid, db, db_valid, group):
    """max over valid queries of the min distance to ALL ranks' db rows:
    kernel 1's row mins against the local rows, then all_reduce MIN."""
    mins = hd_ops.min_sqdists(queries, db, valid_a=q_valid, valid_b=db_valid)
    dist.all_reduce(mins, op=dist.ReduceOp.MIN, group=group)
    return finalize_mins(mins, q_valid)


def distributed_prohd(
    mesh,
    a: ShardedCloud,
    b: ShardedCloud,
    cfg: ProHDConfig = ProHDConfig(),
    *,
    batch_axes: Sequence[str] = ("data",),
):
    """Multi-device ProHD; every rank of the batch group calls it with its
    own rows.  Returns replicated ``(hd, n_sel_a, n_sel_b)`` tensors.

    Directions are always the global Gram's (``cfg.pca_method`` and
    ``cfg.subset_backend`` are not read: the scans are kernel 1's, or its
    plain version on CPU tensors).  ``cfg.inner="full"`` (default) scans
    the gathered subsets against the full sharded clouds; ``"subset"``
    scans the gathered subsets against each other, on every rank.
    """
    group = batch_group(mesh, batch_axes)
    size = dist.get_world_size(group)
    strict_fp32()
    n_local_a, d = a.points.shape
    n_a = n_local_a * size
    n_b = b.points.shape[0] * size
    m = cfg.resolve_m(d)
    alpha_pca = cfg.alpha_pca if cfg.alpha_pca is not None else cfg.alpha / max(1, m)
    cap_a = min(n_a // size, sel_mod.selection_capacity(n_a, m, cfg.alpha, alpha_pca))
    cap_b = min(n_b // size, sel_mod.selection_capacity(n_b, m, cfg.alpha, alpha_pca))
    ap, av, bp, bv = a.points, a.valid, b.points, b.valid

    dirs = _global_gram_directions(ap, av, bp, bv, m, group)
    mask_a = _select_local_mask(projections.project(ap, dirs), av, n_a, cfg.alpha, alpha_pca, group)
    mask_b = _select_local_mask(projections.project(bp, dirs), bv, n_b, cfg.alpha, alpha_pca, group)
    qa, qa_valid = _gather_selected(ap, mask_a, cap_a, group)
    qb, qb_valid = _gather_selected(bp, mask_b, cap_b, group)

    if cfg.inner == "full":
        h_ab = _queries_vs_sharded_db(qa, qa_valid, bp, bv, group)
        h_ba = _queries_vs_sharded_db(qb, qb_valid, ap, av, group)
    else:  # Alg. 3 as typeset: subset vs subset, both replicated
        h_ab = hd_ops.directed_hausdorff(qa, qb, valid_a=qa_valid, valid_b=qb_valid)
        h_ba = hd_ops.directed_hausdorff(qb, qa, valid_a=qb_valid, valid_b=qa_valid)

    n_sel = torch.stack([mask_a.sum(), mask_b.sum()]).to(torch.int64)
    dist.all_reduce(n_sel, op=dist.ReduceOp.SUM, group=group)
    n_sel = n_sel.to(torch.int32)
    return torch.maximum(h_ab, h_ba), n_sel[0], n_sel[1]


# ---------------------------------------------------------------------------
# exact HD: the ring
# ---------------------------------------------------------------------------


def distributed_exact_hd(
    mesh,
    a: ShardedCloud,
    b: ShardedCloud,
    *,
    batch_axes: Sequence[str] = ("data",),
):
    """Exact H(A, B) with both clouds row-sharded, by a ring; every rank of
    the batch group calls it with its own rows and gets the replicated value.

    Each of the P steps runs one bidirectional kernel-1 scan of this rank's
    a-rows against the visiting b-block: the row mins fold into the a-rows'
    running mins, the column mins into the block's, which travel with it.
    The next block's transfer is posted before the scan, so the two
    overlap; its column mins follow after the scan.  Peak memory stays
    O(n/P · D).
    """
    group = batch_group(mesh, batch_axes)
    size = dist.get_world_size(group)
    dev = a.points.device
    mins_a = torch.full((a.points.shape[0],), _POS, dtype=torch.float32, device=dev)
    blk, blk_valid = b.points, b.valid.to(torch.uint8)
    blk_mins = torch.full((b.points.shape[0],), _POS, dtype=torch.float32, device=dev)
    for step in range(size):
        last = step == size - 1
        if not last:
            (nxt_blk, nxt_valid), reqs = _ring_exchange([blk, blk_valid], group)
        row, col = hd_ops.fused_min_sqdists(a.points, blk, valid_a=a.valid, valid_b=blk_valid.bool())
        mins_a = torch.minimum(mins_a, row)
        blk_mins = torch.minimum(blk_mins, col)
        if not last:
            (nxt_mins,), reqs_m = _ring_exchange([blk_mins], group, tag0=2)
            _wait(reqs)
            _wait(reqs_m)
            blk, blk_valid, blk_mins = nxt_blk, nxt_valid, nxt_mins
    h2 = torch.stack([
        torch.where(a.valid, mins_a, _NEG).max(),
        torch.where(blk_valid.bool(), blk_mins, _NEG).max(),
    ])
    dist.all_reduce(h2, op=dist.ReduceOp.MAX, group=group)
    return torch.sqrt(torch.clamp(h2.max(), min=0.0))
