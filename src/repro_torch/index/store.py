"""SetStore — packed ragged storage for a corpus of variable-size point sets.

Counterpart of ``repro/index/store.py``, all of it:

- Sets are packed into **power-of-two padded buckets**: a set of n points
  lands in the bucket of capacity ``next_pow2(max(n, min_bucket))`` as one
  (capacity, D) slab row plus a row-validity mask, so per-bucket corpus
  work is one batched call.
- Row validity is also folded into **+inf-poisoned squared norms**.
- Every ``add()`` precomputes a :class:`SetSummary` — centroid, min/max
  centroid radius, and the set's projection intervals on a direction bank
  shared by the whole store — from which stage 0 of the cascade bounds
  every stored set without touching a point.

The store is **mutable** (``delete`` / ``update`` by per-bucket
tombstones, ``compact`` to drop dead slots, ids never reused) and its
caches are invalidated by one monotone mutation generation, exactly as in
the reference.  Snapshots are format v2 (numpy ``.npy`` / ``.npz`` payloads,
a JSON manifest with per-file sha256), readable by both packages in both
directions.

Device rule: raw sets and staged summary rows are host numpy; the packed
slabs, valid masks, squared norms and stacked summaries live on the
store's device, which is ``cuda`` unless the caller passes ``device="cpu"``
(or a CPU direction bank).  Where the reference rebuilds a tombstoned
slab row functionally, the port patches the cached device tensors in place
(no copy of a multi-GiB slab per delete).

``direction_bank`` draws its Gaussian from a ``torch.Generator``, which
cannot reproduce ``jax.random``'s numbers: to hold one corpus in both
packages, pass the reference store's bank through ``SetStore(directions=)``
(``repro_torch.interop.store_from_reference``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from pathlib import Path
from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import projections
from repro_torch.device import resolve_device
from repro_torch.obs import trace as _obs
from repro_torch.reliability import faults as _faults
from repro_torch.reliability.errors import StoreCorruption
from repro_torch.train.checkpoint import atomic_snapshot_dir, read_latest, write_latest

__all__ = [
    "SetSummary",
    "PackedBucket",
    "SetStore",
    "direction_bank",
    "summarize_set",
    "bucket_capacity",
    "pack_sets",
    "latest_snapshot",
    "atomic_snapshot_dir",
    "SNAPSHOT_FORMAT",
]

# v2 adds a "tombstones" id list and "n_live" to the manifest; bucket files
# carry only LIVE slots, so a v1 snapshot restores bit for bit.
SNAPSHOT_FORMAT = 2
_SUPPORTED_SNAPSHOT_FORMATS = (1, 2)

_POINT_RESTORE = _faults.declare_point(
    "store.restore",
    "start of SetStore.restore — a raise here models a storage outage",
)
_POINT_COMPACT = _faults.declare_point(
    "store.compact",
    "start of SetStore.compact, before any membership rewrite — a raise "
    "here models a failure mid-maintenance; the store must stay exactly "
    "as it was (tombstones intact, nothing rewritten)",
)


class SetSummary(NamedTuple):
    """Per-set facts the bound cascade prunes on (stackable: a leading
    corpus axis on every field describes N sets)."""

    centroid: torch.Tensor  # (D,) fp32 mean of valid rows
    r_min: torch.Tensor     # () fp32 min distance centroid → valid point
    r_max: torch.Tensor     # () fp32 max distance centroid → valid point
    proj_lo: torch.Tensor   # (m,) fp32 per-direction projection minimum
    proj_hi: torch.Tensor   # (m,) fp32 per-direction projection maximum
    count: torch.Tensor     # () int32 number of valid rows


class PackedBucket(NamedTuple):
    """One capacity class of the store, stacked for batched consumption.

    ``live`` marks tombstoned slots (False): their slab rows are packed as
    empty sets — all-invalid mask, zero points, +inf poisoned norms — so a
    scan of the slab returns the certified +inf sentinel for them.  A
    row-gathering consumer (the cascade's stage 1) must still AND ``live``
    into its row selection: an UPDATED set appears in both its old (dead)
    and new (live) slots under one id, and the dead row's masked-ProHD
    lower bound is +inf.
    """

    capacity: int
    set_ids: np.ndarray      # (B,) int32 store-wide set ids, slot order
    points: torch.Tensor     # (B, capacity, D) fp32, invalid rows zeroed
    valid: torch.Tensor      # (B, capacity) bool
    sqnorms: torch.Tensor    # (B, capacity) fp32, +inf on invalid rows
    live: np.ndarray         # (B,) bool host-side, False on tombstoned slots


def bucket_capacity(n: int, min_bucket: int = 8) -> int:
    """Power-of-two padded capacity for an n-point set."""
    n = max(int(n), min_bucket)
    return 1 << (n - 1).bit_length()


def pack_sets(sets: Sequence[np.ndarray], capacity: int, dim: int):
    """Pad (n_i, dim) sets into one (B, capacity, dim) slab: each set in its
    row's prefix, the tail zero with validity False.  Returns float32 /
    bool numpy ``(points, valid)``."""
    b = len(sets)
    pts = np.zeros((b, capacity, dim), np.float32)
    val = np.zeros((b, capacity), bool)
    for row, s in enumerate(sets):
        n = s.shape[0]
        pts[row, :n] = s
        val[row, :n] = True
    return pts, val


def direction_bank(
    d: int,
    m: int | None = None,
    *,
    generator: torch.Generator | None = None,
    data=None,
    device=None,
) -> torch.Tensor:
    """Orthonormal (D, m) direction bank shared by a whole store.

    ``data`` (a sample of corpus points) → top-m PCA directions; otherwise
    QR of a Gaussian draw from ``generator`` (seed 0 on the CPU by
    default).  Only unit directions matter to the certificates.  ``m``
    defaults to the paper's floor(sqrt(D)).
    """
    m = projections.default_num_directions(d) if m is None else m
    m = min(m, d)
    if data is not None:
        z = torch.as_tensor(np.asarray(data, np.float32) if not isinstance(data, torch.Tensor) else data)
        return projections.pca_directions(z.to(resolve_device(z, device)).float(), m)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    g = torch.randn((d, m), generator=generator, device=generator.device)
    q, _ = torch.linalg.qr(g)
    return q.to(resolve_device(q, device))


def summarize_set(points: torch.Tensor, valid: torch.Tensor, directions: torch.Tensor):
    """(SetSummary, poisoned sqnorms) of padded sets, batched over any
    leading axes: points (..., n, D), valid (..., n).

    Invalid rows are excluded from every statistic; their squared norms
    are +inf.  An all-invalid set yields r_min = +inf and hull-less
    intervals (lo > hi), both vacuous-but-sound for the cascade.
    """
    p = points.float()
    v = valid
    count = v.sum(dim=-1, dtype=torch.int32)
    centroid = torch.sum(p * v.float()[..., None], dim=-2) / torch.clamp(count.float(), min=1.0)[..., None]
    r = torch.sqrt(torch.clamp(torch.sum((p - centroid[..., None, :]) ** 2, dim=-1), min=0.0))
    r_min = torch.where(v, r, torch.inf).amin(dim=-1)
    r_max = torch.clamp(torch.where(v, r, -torch.inf).amax(dim=-1), min=0.0)
    proj = projections.project(p, directions)
    proj_lo = torch.where(v[..., None], proj, 1e30).amin(dim=-2)
    proj_hi = torch.where(v[..., None], proj, -1e30).amax(dim=-2)
    sqn = torch.where(v, torch.sum(p * p, dim=-1), torch.inf)
    return (
        SetSummary(centroid=centroid, r_min=r_min, r_max=r_max,
                   proj_lo=proj_lo, proj_hi=proj_hi, count=count),
        sqn,
    )


def _host_rows(summary: SetSummary) -> list[tuple]:
    """A stacked summary as per-set tuples of numpy rows."""
    fields = [f.cpu().numpy() for f in summary]
    return [tuple(f[row] for f in fields) for row in range(fields[0].shape[0])]


class SetStore:
    """A growing, mutable corpus of point sets with precomputed summaries.

    >>> store = SetStore(dim=16)             # on the card; device="cpu" here
    >>> sid = store.add(points)              # (n, 16) array, n >= 1
    >>> store.get(sid)                       # raw (n, 16) points back
    >>> store.update(sid, new_points)        # re-embed in place (same id)
    >>> store.delete(sid)                    # tombstone; id never reused
    >>> store.summaries()                    # stacked SetSummary, (N, ...)
    >>> store.live_mask()                    # (N,) bool — False once deleted
    >>> store.packed_buckets()               # {capacity: PackedBucket}
    >>> store.compact()                      # drop tombstoned slots

    ``add_many`` summarizes each capacity group in one batched call.
    ``compact_threshold`` is the tombstone fraction at which a bucket
    touched by delete/update is auto-compacted (1.0 disables it).
    """

    def __init__(
        self,
        dim: int,
        *,
        directions=None,
        num_directions: int | None = None,
        generator: torch.Generator | None = None,
        min_bucket: int = 8,
        compact_threshold: float = 0.5,
        device=None,
    ):
        if dim < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        if min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
        if not 0.0 < float(compact_threshold) <= 1.0:
            raise ValueError(f"compact_threshold must be in (0, 1], got {compact_threshold}")
        self.dim = int(dim)
        self.min_bucket = int(min_bucket)
        self.compact_threshold = float(compact_threshold)
        # numpy directions follow the device rule (cuda unless asked); a
        # tensor bank keeps its own device
        self.device = resolve_device(directions if isinstance(directions, torch.Tensor) else None, device)
        if directions is None:
            directions = direction_bank(dim, num_directions, generator=generator, device=self.device)
        elif not isinstance(directions, torch.Tensor):
            directions = torch.from_numpy(np.array(directions, np.float32))
        self._directions = directions.to(self.device, torch.float32)
        if self._directions.ndim != 2 or self._directions.shape[0] != dim:
            raise ValueError(f"directions must be (dim={dim}, m), got {tuple(self._directions.shape)}")
        self._raw: list[np.ndarray] = []
        self._live: list[bool] = []
        self._n_live = 0
        # bucket membership: cap -> set ids in slot order, with a parallel
        # per-SLOT liveness list (an updated set owns a dead old slot and a
        # live new one under the same id).  The padded slabs live only in
        # the per-capacity PackedBucket cache, rebuilt from _raw on demand.
        self._members: dict[int, list[int]] = {}
        self._slot_live: dict[int, list[bool]] = {}
        # staged per-set summary rows (host numpy), set-id order; stale
        # after delete (consumers mask with live_mask()).
        self._sums: dict[str, list[np.ndarray]] = {f: [] for f in SetSummary._fields}
        # generation-based cache invalidation: one monotone mutation
        # counter; each derived structure records the generation it was
        # built at and rebuilds iff its source mutated since.
        self._gen = 0
        self._members_gen: dict[int, int] = {}
        self._sums_gen = 0
        self._bucket_cache: dict[int, PackedBucket] = {}
        self._bucket_gen: dict[int, int] = {}
        self._summary_cache: SetSummary | None = None
        self._summary_gen = -1
        self._slot_cache: dict[int, tuple[int, int]] = {}
        self._slot_gen = -1
        # populated by SetStore.restore(); None for a live-built store
        self.restore_report: dict | None = None

    def _mutated(self, caps: Iterable[int], *, sums_changed: bool) -> None:
        """Advance the mutation generation and stamp the touched buckets."""
        self._gen += 1
        for cap in caps:
            self._members_gen[cap] = self._gen
        if sums_changed:
            self._sums_gen = self._gen

    # -- introspection ------------------------------------------------------

    @property
    def directions(self) -> torch.Tensor:
        """The shared (D, m) direction bank."""
        return self._directions

    @property
    def num_directions(self) -> int:
        return int(self._directions.shape[1])

    @property
    def n_sets(self) -> int:
        """Total ids ever assigned, tombstoned ones included."""
        return len(self._raw)

    @property
    def n_live(self) -> int:
        """Number of live (non-deleted) sets."""
        return self._n_live

    def __len__(self) -> int:
        return self.n_sets

    @property
    def total_points(self) -> int:
        return sum(p.shape[0] for p in self._raw)

    @property
    def bucket_capacities(self) -> tuple[int, ...]:
        return tuple(sorted(self._members))

    def live_mask(self) -> np.ndarray:
        """(N,) bool — True where the set id is live, False once deleted."""
        return np.asarray(self._live, bool)

    def is_live(self, sid: int) -> bool:
        return 0 <= sid < self.n_sets and self._live[sid]

    def tombstone_fraction(self, cap: int) -> float:
        """Dead-slot fraction of one bucket — the compaction trigger."""
        slots = self._slot_live.get(cap)
        if not slots:
            return 0.0
        return 1.0 - sum(slots) / len(slots)

    # -- ingestion ----------------------------------------------------------

    def add(self, points, *, validate: bool = True) -> int:
        """Store one (n, D) set; returns its corpus-wide id."""
        return self.add_many([points], validate=validate)[0]

    def _check_points(self, p, *, validate: bool, what: str) -> np.ndarray:
        p = p.cpu().numpy() if isinstance(p, torch.Tensor) else p
        p = np.asarray(p, np.float32)
        if p.ndim != 2 or p.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) points, got shape {p.shape}")
        if p.shape[0] < 1:
            raise ValueError("cannot store an empty set (HD is undefined)")
        if validate and not np.isfinite(p).all():
            raise ValueError(
                f"{what} contains non-finite coordinates (NaN/Inf); "
                "certified intervals are undefined over them — clean the "
                "data or pass validate=False"
            )
        return p

    def _summarize_group(self, sets: list[np.ndarray], cap: int) -> list[tuple]:
        pts, val = pack_sets(sets, cap, self.dim)
        sums, _ = summarize_set(
            torch.from_numpy(pts).to(self.device), torch.from_numpy(val).to(self.device),
            self._directions,
        )
        return _host_rows(sums)

    def add_many(self, sets: Iterable, *, validate: bool = True) -> list[int]:
        """Bulk-load many sets; summaries are computed per capacity group in
        one batched call.  Returns the new ids in input order.

        ``validate=True`` rejects non-finite coordinates before anything is
        stored; a failure mid-load leaves the store exactly as it was.
        """
        arrs = [
            self._check_points(p, validate=validate, what=f"set {j} of this add")
            for j, p in enumerate(sets)
        ]
        if not arrs:
            return []
        first_id = self.n_sets
        ids = list(range(first_id, first_id + len(arrs)))
        by_cap: dict[int, list[int]] = {}
        for j, p in enumerate(arrs):
            by_cap.setdefault(bucket_capacity(p.shape[0], self.min_bucket), []).append(j)

        # Stage every group's summaries before mutating anything.
        scratch: list[tuple | None] = [None] * len(arrs)
        membership: list[tuple[int, int]] = []
        for cap, members in by_cap.items():
            for j, row in zip(members, self._summarize_group([arrs[j] for j in members], cap)):
                scratch[j] = row
                membership.append((cap, ids[j]))

        for cap, sid in membership:
            self._members.setdefault(cap, []).append(sid)
            self._slot_live.setdefault(cap, []).append(True)
        for j, p in enumerate(arrs):
            self._raw.append(p)
            self._live.append(True)
            for field, value in zip(SetSummary._fields, scratch[j]):
                self._sums[field].append(value)
        self._n_live += len(arrs)
        self._mutated(by_cap, sums_changed=True)
        return ids

    # -- mutation -------------------------------------------------------------

    def _live_slot(self, sid: int, what: str) -> tuple[int, int]:
        if not (0 <= sid < self.n_sets):
            raise KeyError(f"cannot {what} unknown set id {sid}")
        if not self._live[sid]:
            raise KeyError(f"cannot {what} set {sid}: already deleted")
        return self.slot_index()[sid]

    def _tombstone_slot(self, cap: int, row: int) -> None:
        """Kill one slot; patch a fresh cached slab in place (valid→False,
        norms→+inf, points→0, live→False) instead of re-packing the bucket.
        Called before ``_mutated``; the caller re-stamps the cache fresh."""
        self._slot_live[cap][row] = False
        cached = self._bucket_cache.get(cap)
        if cached is None or self._bucket_gen.get(cap) != self._members_gen.get(cap):
            self._bucket_cache.pop(cap, None)   # stale anyway; repack lazily
            self._bucket_gen.pop(cap, None)
            return
        cached.points[row] = 0.0
        cached.valid[row] = False
        cached.sqnorms[row] = torch.inf
        live = cached.live.copy()
        live[row] = False
        self._bucket_cache[cap] = cached._replace(live=live)

    def delete(self, sid: int) -> None:
        """Tombstone set ``sid``: its id is never reused, its slab row stays
        (as an empty set), its summary row is masked out of stage 0 via
        :meth:`live_mask`, and its raw points are freed.  Raises KeyError
        for unknown or already-deleted ids.  Auto-compacts the bucket once
        its tombstone fraction reaches ``compact_threshold``."""
        if not _obs.enabled():
            return self._delete_impl(sid)
        with _obs.span("store.delete", sid=sid) as sp:
            cap = self._delete_impl(sid)
            sp.set(capacity=cap, n_live=self.n_live)
            return None

    def _delete_impl(self, sid: int) -> int:
        cap, row = self._live_slot(sid, "delete")
        self._tombstone_slot(cap, row)
        self._live[sid] = False
        self._n_live -= 1
        self._raw[sid] = np.zeros((0, self.dim), np.float32)
        self._mutated({cap}, sums_changed=False)
        if cap in self._bucket_cache:       # patched in place: still fresh
            self._bucket_gen[cap] = self._members_gen[cap]
        self._maybe_autocompact(cap)
        return cap

    def update(self, sid: int, points, *, validate: bool = True) -> None:
        """Replace set ``sid``'s points (same id): tombstone the old slot,
        append a fresh one, recompute the summary row at ``sid``."""
        if not _obs.enabled():
            return self._update_impl(sid, points, validate=validate)
        with _obs.span("store.update", sid=sid) as sp:
            old_cap, new_cap = self._update_impl(sid, points, validate=validate)
            sp.set(old_capacity=old_cap, new_capacity=new_cap)
            return None

    def _update_impl(self, sid: int, points, *, validate: bool) -> tuple[int, int]:
        p = self._check_points(points, validate=validate, what=f"update of set {sid}")
        old_cap, old_row = self._live_slot(sid, "update")
        new_cap = bucket_capacity(p.shape[0], self.min_bucket)
        # summarize BEFORE mutating: a device failure here leaves the store
        # exactly as it was
        (row,) = self._summarize_group([p], new_cap)

        self._tombstone_slot(old_cap, old_row)
        self._members.setdefault(new_cap, []).append(sid)
        self._slot_live.setdefault(new_cap, []).append(True)
        self._raw[sid] = p
        for field, value in zip(SetSummary._fields, row):
            self._sums[field][sid] = value
        self._mutated({old_cap, new_cap}, sums_changed=True)
        if old_cap != new_cap and old_cap in self._bucket_cache:
            self._bucket_gen[old_cap] = self._members_gen[old_cap]
        self._maybe_autocompact(old_cap)
        return old_cap, new_cap

    def _maybe_autocompact(self, cap: int) -> None:
        if self.tombstone_fraction(cap) >= self.compact_threshold:
            self.compact(cap)

    def compact(self, capacity: int | None = None, *, threshold: float | None = None) -> dict[int, int]:
        """Rewrite buckets to drop tombstoned slots; returns ``{capacity:
        slots removed}`` for every bucket rewritten.  ``threshold`` limits
        the rewrite to buckets at or above that tombstone fraction.  Set ids
        are untouched; an emptied bucket disappears.  The ``store.compact``
        injection point fires before any membership is touched."""
        if not _obs.enabled():
            return self._compact_impl(capacity, threshold)
        with _obs.span("store.compact", capacity=-1 if capacity is None else capacity) as sp:
            removed = self._compact_impl(capacity, threshold)
            sp.set(buckets_rewritten=len(removed), slots_removed=sum(removed.values()))
            return removed

    def _compact_impl(self, capacity: int | None, threshold: float | None) -> dict[int, int]:
        caps = sorted(self._members) if capacity is None else [int(capacity)]
        targets: list[int] = []
        for cap in caps:
            slots = self._slot_live.get(cap)
            if not slots:
                continue
            dead = len(slots) - sum(slots)
            if dead == 0:
                continue
            if threshold is not None and dead / len(slots) < float(threshold):
                continue
            targets.append(cap)
        if not targets:
            return {}
        _faults.fire(_POINT_COMPACT)
        removed: dict[int, int] = {}
        survivors: set[int] = set()
        for cap in targets:
            keep = [sid for sid, ok in zip(self._members[cap], self._slot_live[cap]) if ok]
            removed[cap] = len(self._members[cap]) - len(keep)
            if keep:
                self._members[cap] = keep
                self._slot_live[cap] = [True] * len(keep)
                survivors.add(cap)
            else:
                del self._members[cap]
                del self._slot_live[cap]
                self._members_gen.pop(cap, None)
                self._bucket_cache.pop(cap, None)
                self._bucket_gen.pop(cap, None)
        self._mutated(survivors, sums_changed=False)
        return removed

    # -- retrieval ----------------------------------------------------------

    def get(self, sid: int) -> torch.Tensor:
        """The raw, UNPADDED (n, D) points of set ``sid`` on the store's
        device — exactly what was added.  KeyError for a deleted id."""
        if 0 <= sid < self.n_sets and not self._live[sid]:
            raise KeyError(f"set {sid} is deleted")
        return torch.tensor(self._raw[sid], device=self.device)  # a copy, on any device

    def counts(self) -> np.ndarray:
        """(N,) int array of stored set sizes (0 at tombstoned ids)."""
        return np.array([p.shape[0] for p in self._raw], np.int32)

    def summaries(self) -> SetSummary:
        """Stacked per-set summaries on the store's device, (N, ...) per
        field; rows at tombstoned ids are stale (mask with live_mask)."""
        if self.n_sets == 0:
            raise ValueError("empty store has no summaries")
        if self._summary_cache is None or self._summary_gen != self._sums_gen:
            self._summary_cache = SetSummary(
                *(torch.from_numpy(np.stack(self._sums[f])).to(self.device) for f in SetSummary._fields)
            )
            self._summary_gen = self._sums_gen
        return self._summary_cache

    def packed_buckets(self) -> dict[int, PackedBucket]:
        """{capacity: PackedBucket} with stacked (B, capacity, ...) tensors
        on the store's device.  Only buckets whose membership changed since
        the last call are re-packed and re-uploaded.  Tombstoned slots pack
        as empty sets."""
        empty = np.zeros((0, self.dim), np.float32)
        for cap in sorted(self._members):
            if cap in self._bucket_cache and self._bucket_gen.get(cap) == self._members_gen.get(cap):
                continue
            slots = self._members[cap]
            live = np.asarray(self._slot_live[cap], bool)
            pts, val = pack_sets(
                [self._raw[sid] if ok else empty for sid, ok in zip(slots, live)], cap, self.dim,
            )
            points = torch.from_numpy(pts).to(self.device)
            valid = torch.from_numpy(val).to(self.device)
            sqn = torch.where(valid, torch.sum(points * points, dim=-1), torch.inf)
            self._bucket_cache[cap] = PackedBucket(
                capacity=cap, set_ids=np.asarray(slots, np.int32),
                points=points, valid=valid, sqnorms=sqn, live=live,
            )
            self._bucket_gen[cap] = self._members_gen.get(cap)
        return dict(self._bucket_cache)

    def slot_index(self) -> dict[int, tuple[int, int]]:
        """{set id: (bucket capacity, slab row)} for every LIVE stored set
        (an updated set maps to its new slot only)."""
        if self._slot_gen != self._gen:
            self._slot_cache = {
                sid: (cap, row)
                for cap, slots in self._members.items()
                for row, sid in enumerate(slots)
                if self._slot_live[cap][row]
            }
            self._slot_gen = self._gen
        return dict(self._slot_cache)

    def summarize(self, points, valid=None) -> SetSummary:
        """Summary of an EXTERNAL set (e.g. a query) on this store's bank."""
        p = points if isinstance(points, torch.Tensor) else torch.as_tensor(np.asarray(points, np.float32))
        p = p.to(self.device, torch.float32)
        v = (torch.ones((p.shape[0],), dtype=torch.bool, device=self.device) if valid is None
             else torch.as_tensor(valid, device=self.device).to(torch.bool))
        summary, _ = summarize_set(p, v, self._directions)
        return summary

    # -- durability ----------------------------------------------------------
    #
    # On-disk snapshot format v2 (the reference's):
    #
    #     <root>/store_<gen>/              ← atomic tmp+rename
    #         manifest.json                ← dims, membership, tombstones,
    #                                        n_live, per-file sha256
    #         directions.npy               ← the (D, m) direction bank
    #         summaries.npz                ← stacked SetSummary, set-id order
    #         bucket_<cap>.npz             ← concatenated raw points + sizes
    #                                        + set ids, LIVE slots only
    #     <root>/LATEST                    ← "gen", written last

    def save(self, root: str | os.PathLike) -> Path:
        """Write a durable snapshot under ``root``; returns its directory."""
        if not _obs.enabled():
            return self._save_impl(root)
        with _obs.span("store.save", n_sets=self.n_sets) as sp:
            snap = self._save_impl(root)
            sp.set(snapshot=str(snap), bytes=sum(p.stat().st_size for p in snap.iterdir()))
            return snap

    def _save_impl(self, root: str | os.PathLike) -> Path:
        if self.n_sets == 0:
            raise ValueError("refusing to snapshot an empty store")
        if self.n_live == 0:
            raise ValueError("refusing to snapshot a store with no live sets")
        root = Path(root)
        latest = latest_snapshot(root)
        gen = 0 if latest is None else latest + 1
        files: dict[str, str] = {}
        buckets: dict[str, dict] = {}
        with atomic_snapshot_dir(root, f"store_{gen}") as tmp:
            np.save(tmp / "directions.npy", self._directions.cpu().numpy())
            files["directions.npy"] = _sha256(tmp / "directions.npy")
            np.savez(tmp / "summaries.npz", **{f: np.stack(self._sums[f]) for f in SetSummary._fields})
            files["summaries.npz"] = _sha256(tmp / "summaries.npz")
            for cap in sorted(self._members):
                sids = [s for s, ok in zip(self._members[cap], self._slot_live[cap]) if ok]
                if not sids:
                    continue
                name = f"bucket_{cap}.npz"
                np.savez(
                    tmp / name,
                    points=np.concatenate([self._raw[s] for s in sids], axis=0),
                    sizes=np.asarray([self._raw[s].shape[0] for s in sids], np.int64),
                    set_ids=np.asarray(sids, np.int64),
                )
                files[name] = _sha256(tmp / name)
                buckets[str(cap)] = {"file": name, "n_sets": len(sids)}
            manifest = {
                "format": SNAPSHOT_FORMAT,
                "gen": gen,
                "dim": self.dim,
                "min_bucket": self.min_bucket,
                "n_sets": self.n_sets,
                "n_live": self.n_live,
                "tombstones": [i for i, ok in enumerate(self._live) if not ok],
                "num_directions": self.num_directions,
                "files": files,
                "buckets": buckets,
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        write_latest(root, gen)
        return root / f"store_{gen}"

    @classmethod
    def restore(
        cls,
        root: str | os.PathLike,
        *,
        gen: int | None = None,
        quarantine: bool = False,
        device=None,
    ) -> "SetStore":
        """Rebuild a store from its newest (or ``gen``-th) snapshot, onto
        ``device`` (default ``cuda``).

        Every payload is checksum-verified before use.  A corrupt bucket
        raises :class:`StoreCorruption` naming it — unless
        ``quarantine=True``, which drops the damaged bucket's sets,
        reindexes the survivors compactly and recomputes their summaries
        (recorded in ``store.restore_report``); when every bucket is
        corrupt, a typed ``StoreCorruption`` carries the report.  Reads
        formats 1 and 2; a newer format is refused.
        """
        if not _obs.enabled():
            return cls._restore_impl(root, gen=gen, quarantine=quarantine, device=device)
        with _obs.span("store.restore", quarantine=quarantine) as sp:
            store = cls._restore_impl(root, gen=gen, quarantine=quarantine, device=device)
            rep = store.restore_report
            snap = Path(rep["snapshot"])
            sp.set(
                gen=rep["gen"], snapshot=rep["snapshot"], n_sets=store.n_sets,
                dropped_buckets=len(rep["dropped_buckets"]), dropped_sets=rep["dropped_sets"],
                bytes=sum(p.stat().st_size for p in snap.iterdir()),
            )
            return store

    @classmethod
    def _restore_impl(cls, root, *, gen=None, quarantine=False, device=None) -> "SetStore":
        _faults.fire(_POINT_RESTORE)
        root = Path(root)
        if gen is None:
            gen = latest_snapshot(root)
            if gen is None:
                raise FileNotFoundError(f"no store snapshot under {root}")
        snap = root / f"store_{gen}"
        try:
            manifest = json.loads((snap / "manifest.json").read_text())
        except (OSError, ValueError) as e:
            raise StoreCorruption(
                f"unreadable snapshot manifest {snap / 'manifest.json'}: {e}",
                path=str(snap / "manifest.json"),
            ) from e
        if manifest.get("format") not in _SUPPORTED_SNAPSHOT_FORMATS:
            raise StoreCorruption(
                f"snapshot format {manifest.get('format')!r} not supported "
                f"by this reader (supported: {_SUPPORTED_SNAPSHOT_FORMATS})",
                path=str(snap),
            )
        files: dict[str, str] = manifest["files"]
        tombstones = sorted(int(t) for t in manifest.get("tombstones", []))
        tomb = set(tombstones)
        n_total = int(manifest["n_sets"])

        def _verify(name: str, *, bucket: int | None) -> Path:
            path = snap / name
            want = files.get(name)
            got = _sha256(path) if path.exists() else None
            if want is None or got != want:
                raise StoreCorruption(
                    f"snapshot payload {name!r} failed its content checksum "
                    f"(bucket={bucket}); refusing to serve corrupt data",
                    bucket=bucket, path=str(path),
                )
            return path

        directions = np.load(_verify("directions.npy", bucket=None))
        dropped: list[int] = []
        raw_by_id: dict[int, np.ndarray] = {}
        for cap_s, entry in sorted(manifest["buckets"].items(), key=lambda kv: int(kv[0])):
            cap = int(cap_s)
            try:
                path = _verify(entry["file"], bucket=cap)
            except StoreCorruption:
                if not quarantine:
                    raise
                dropped.append(cap)
                continue
            blob = np.load(path)
            offsets = np.concatenate([[0], np.cumsum(blob["sizes"])])
            pts = blob["points"]
            for row, sid in enumerate(blob["set_ids"]):
                raw_by_id[int(sid)] = np.asarray(pts[offsets[row]:offsets[row + 1]], np.float32)

        kept_ids = sorted(raw_by_id)
        if not dropped and sorted(kept_ids + tombstones) != list(range(n_total)):
            raise StoreCorruption(
                f"snapshot set ids ∪ tombstones are not dense 0..{n_total - 1}", path=str(snap),
            )
        if dropped and not kept_ids:
            exc = StoreCorruption(
                "no restorable buckets: every bucket payload failed its "
                f"content checksum (dropped capacities: {dropped})",
                path=str(snap),
            )
            exc.restore_report = {
                "snapshot": str(snap), "gen": gen, "dropped_buckets": dropped,
                "dropped_sets": n_total - len(tomb), "kept_original_ids": [],
            }
            raise exc

        store = cls(
            dim=int(manifest["dim"]), directions=torch.from_numpy(np.asarray(directions, np.float32)),
            min_bucket=int(manifest["min_bucket"]), device=resolve_device(None, device),
        )
        if dropped:
            # survivors reindexed compactly, summaries recomputed from raw
            # points; tombstoned ids were never saved, so all are live.
            store.add_many([raw_by_id[s] for s in kept_ids], validate=False)
        else:
            sums = np.load(_verify("summaries.npz", bucket=None))
            placeholder = np.zeros((0, store.dim), np.float32)
            store._raw = [raw_by_id.get(i, placeholder) for i in range(n_total)]
            store._live = [i not in tomb for i in range(n_total)]
            store._n_live = n_total - len(tomb)
            for cap_s, entry in manifest["buckets"].items():
                ids = [int(s) for s in np.load(snap / entry["file"])["set_ids"]]
                store._members[int(cap_s)] = ids
                store._slot_live[int(cap_s)] = [True] * len(ids)
            for f in SetSummary._fields:
                stack = sums[f]
                if stack.shape[0] != n_total:
                    raise StoreCorruption(
                        f"summary stack {f!r} covers {stack.shape[0]} sets, expected {n_total}",
                        path=str(snap / "summaries.npz"),
                    )
                store._sums[f] = [stack[i] for i in range(stack.shape[0])]
            store._mutated(set(store._members), sums_changed=True)
        store.restore_report = {
            "snapshot": str(snap),
            "gen": gen,
            "dropped_buckets": dropped,
            "dropped_sets": (n_total - len(tomb)) - len(kept_ids),
            "tombstones": len(tomb) if not dropped else 0,
            "kept_original_ids": kept_ids if dropped else None,
        }
        return store


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def latest_snapshot(root: str | os.PathLike) -> int | None:
    """Newest complete store snapshot generation under ``root``, or None.

    The ``LATEST`` pointer is a hint, verified against the named snapshot's
    manifest; a stale or garbage pointer falls back to scanning for the
    newest complete ``store_<gen>`` directory (tmp dirs never match).
    """
    root = Path(root)
    token = read_latest(root)
    if token is not None:
        try:
            gen = int(token)
            if (root / f"store_{gen}" / "manifest.json").exists():
                return gen
        except ValueError:
            pass
    gens = []
    for d in root.glob("store_*"):
        m = re.fullmatch(r"store_(\d+)", d.name)
        if m and (d / "manifest.json").exists():
            gens.append(int(m.group(1)))
    return max(gens) if gens else None
