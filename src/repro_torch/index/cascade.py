"""Certified bound-cascade top-k set-distance search over a SetStore.

Counterpart of ``repro/index/cascade.py``.  Three stages, each a strictly
tighter and more expensive certified interval around every candidate's
true distance:

  stage 0 — summary bounds over the whole corpus in one shot, on the
      store's device: projection-interval gaps (lower) and the triangle
      inequality through the centroids (upper).
  stage 1 — masked ProHD per storage bucket on the survivors
      (``core/masked.masked_prohd_certified``, lanes written out): the
      full-inner subset estimate and max_u H_u (lower), Eq. 5 (upper).
  stage 2 — exact refinement of the remaining frontier:
      2a. one masked EXACT pass per surviving bucket
          (``masked_exact_hd_batched``; on the card the batched bucket
          kernel, whose per-set gate drops the work of lanes with
          lb > τ and of the power-of-two padding lanes, which ride in with
          lb = +inf).  Its values enter as intervals ±``fp_value_margin``.
      2b. raw refinement of the candidates still straddling the top-k
          boundary through the ``repro_torch.hd`` front door
          (``set_distance``, kernel 1 on the card), so every returned
          value is the number brute force computes.

A candidate dies exactly when its certified lower bound exceeds τ, the
k-th smallest certified upper bound; stage 2 always drains, so the
returned top-k — ranked by (value, id) — is identical to brute force
(``method="exact"``).  ``stage2="sequential"`` skips 2a; ``mode="anytime"``
stops at the first ε-stable rung.  Deadlines and absorbed faults return
the best certified state as a degraded result.  ``shards=P`` splits stages
0 and 1 across P devices (``repro_torch.index.sharded``) and merges their
certificates before stage 2; the top-k is the same bits.

The interval state (lb, ub, values) is host-side float64 numpy, as in the
reference; stage 0's bounds and margins are computed in fp32 on the device
as the reference computes them under jit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import masked, projections
from repro_torch.core.fp_margin import fp_margin, fp_value_margin
from repro_torch.device import as_tensor
from repro_torch.hd import resolver
from repro_torch.hd.config import HDConfig
from repro_torch.hd.result import HDMeta
from repro_torch.index import sharded as _sharded
from repro_torch.index.store import SetStore, SetSummary, bucket_capacity
from repro_torch.obs import trace as _obs
from repro_torch.obs.metrics import record_stats as _record_stats
from repro_torch.reliability import faults as _faults
from repro_torch.reliability.errors import BackendUnavailable

__all__ = [
    "SearchResult",
    "SEARCH_VARIANTS",
    "SEARCH_METHODS",
    "SEARCH_MODES",
    "STAGE2_MODES",
    "ON_FAULT_MODES",
    "anytime_frontier",
    "certified_recall",
    "interval_bounds",
    "bound_scale",
    "certified_margins",
    "fp_margin",
    "fp_value_margin",
    "masked_backend_ladder",
    "search",
]

SEARCH_VARIANTS = ("hausdorff", "directed")
SEARCH_METHODS = ("cascade", "exact")
SEARCH_MODES = ("exact", "anytime")
STAGE2_MODES = ("batched", "sequential")
ON_FAULT_MODES = ("degrade", "raise")

# Injection points, one per cascade stage plus the per-call backend gate
# (the reference's names).
_POINT_STAGE0 = _faults.declare_point(
    "cascade.stage0", "summary-bound stage — failure here precedes ANY "
    "certified state, so it always surfaces as a typed error")
_POINT_STAGE1 = _faults.declare_point(
    "cascade.stage1", "masked-ProHD tightening — failure degrades to the "
    "stage-0 (or partially tightened) certified intervals")
_POINT_STAGE2A = _faults.declare_point(
    "cascade.stage2a", "batched exact tightening — failure degrades to the "
    "best certified intervals reached")
_POINT_STAGE2B = _faults.declare_point(
    "cascade.stage2b", "raw exact refinement — failure degrades; already-"
    "refined candidates keep their exact values")
_POINT_BACKEND = _faults.declare_point(
    "cascade.backend", "masked-backend availability gate before every "
    "bucket-granularity dispatch (match= the backend name)")
_POINT_ANYTIME = _faults.declare_point(
    "cascade.anytime", "anytime (ε/budget) escalation ladder — failure "
    "degrades to the best certified intervals reached, exactly like the "
    "exact cascade's mid-stage faults")

# Exceptions the cascade may degrade on under on_fault="degrade": the typed
# reliability family (all RuntimeError subclasses), device errors (CUDA
# launch failures and out-of-memory are RuntimeErrors), FP errors.
# Programming errors (ValueError/TypeError) always propagate.
_DEGRADABLE = (RuntimeError, FloatingPointError)

# The cascade wall clock: deadline, stats["elapsed_s"] and spans share it.
# Module-level so tests can monkeypatch a fake clock.
_now = time.monotonic


class _Budget:
    """Monotonic wall-clock deadline; None = unbounded."""

    def __init__(self, deadline_s: float | None):
        self.t0 = _now()
        self.deadline = None if deadline_s is None else self.t0 + float(deadline_s)

    def expired(self) -> bool:
        return self.deadline is not None and _now() >= self.deadline


class _DeadlineHit(Exception):
    """Internal unwind signal: deadline expired.  Not a RuntimeError, so the
    fault-degrade handler can never confuse it with a real failure."""


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Top-k result of a corpus search.

    ids/values ranked ascending by (value, id); when not degraded every
    value is exact (stage-2 refined) and ``lower == upper == values``.
    ``meta.backend`` is the requested refine backend (possibly "auto").
    Degraded results (deadline or absorbed fault) rank by certified upper
    bound and carry intervals that contain the truth; anytime results
    report ``certified_recall_at_k``.  See the reference's SearchResult.
    """

    ids: np.ndarray       # (k,) int32 set ids
    values: np.ndarray    # (k,) fp32 exact distances (degraded: best known)
    stats: dict[str, Any]
    meta: HDMeta
    lower: np.ndarray = None    # (k,) fp64 certified lower bounds
    upper: np.ndarray = None    # (k,) fp64 certified upper bounds
    degraded: bool = False
    stage_reached: str = "complete"
    certified_recall_at_k: float = 1.0

    def __post_init__(self):
        if self.lower is None:
            object.__setattr__(self, "lower", self.values.astype(np.float64))
        if self.upper is None:
            object.__setattr__(self, "upper", self.values.astype(np.float64))


def interval_bounds(sa: SetSummary, sb: SetSummary, *, directed: bool = False):
    """Certified RAW (lower, upper) distance bounds from summaries alone.

    Broadcasts: one summary against an (N,)-stacked one gives (N,) bounds.
    Apply :func:`certified_margins` before pruning on them.
    """
    dc = torch.sqrt(torch.clamp(torch.sum((sa.centroid - sb.centroid) ** 2, dim=-1), min=0.0))
    if directed:
        ub = dc + sa.r_max + sb.r_min
    else:
        ub = dc + torch.maximum(sa.r_max + sb.r_min, sb.r_max + sa.r_min)

    def gap(x, lo, hi):
        return torch.clamp(torch.maximum(lo - x, x - hi), min=0.0)

    g = torch.maximum(gap(sa.proj_lo, sb.proj_lo, sb.proj_hi), gap(sa.proj_hi, sb.proj_lo, sb.proj_hi))
    if not directed:
        g = torch.maximum(
            g, torch.maximum(gap(sb.proj_lo, sa.proj_lo, sa.proj_hi), gap(sb.proj_hi, sa.proj_lo, sa.proj_hi)),
        )
    return g.amax(dim=-1), ub


def bound_scale(sa: SetSummary, sb: SetSummary):
    """Per-pair magnitude ``Σ ||centroid|| + r_max`` that dominates every
    quantity entering the bounds (broadcasts like :func:`interval_bounds`)."""
    na = torch.sqrt(torch.clamp(torch.sum(sa.centroid**2, dim=-1), min=0.0)) + sa.r_max
    nb = torch.sqrt(torch.clamp(torch.sum(sb.centroid**2, dim=-1), min=0.0)) + sb.r_max
    return na + nb


def certified_margins(lb, ub, scale, dim: int):
    """Widen raw bounds by ``fp_margin(dim, scale)`` on both sides so fp32
    rounding cannot flip a prune.  Tensors stay tensors (fp32, on their
    device); anything else is host numpy."""
    pad = fp_margin(dim, scale)
    if isinstance(lb, torch.Tensor):
        return torch.clamp(lb - pad, min=0.0), ub + pad
    return np.maximum(lb - pad, 0.0), ub + pad


def _stage1_batch(q, pts, valid, *, alpha: float, m: int, directed: bool, backend: str):
    """Masked ProHD certificates of the query vs a (S, C, D) candidate slab."""
    va = torch.ones((q.shape[0],), dtype=torch.bool, device=q.device)
    return masked.masked_prohd_certified(
        q, va, pts, valid, alpha=alpha, m=m, directed=directed, backend=backend,
    )


def _stage2_batch(q, pts, valid, gate_lb, gate_cut, *, directed, backend, block_a, block_b):
    """EXACT masked HD of the query vs one bucket's gathered frontier; lanes
    with ``gate_lb > gate_cut`` return the +inf sentinel."""
    return masked.masked_exact_hd_batched(
        q, pts, valid_slab=valid, lb=gate_lb, cut=gate_cut,
        directed=directed, backend=backend, block_a=block_a, block_b=block_b,
    )


def _kth_smallest(ub: np.ndarray, k: int) -> float:
    return float(np.partition(ub, k - 1)[k - 1])


def _pow2_take(rows: np.ndarray, device) -> torch.Tensor:
    """Gather indices padded to a power of two by repeating row 0 — the
    batch-shape discipline of every slab gather (stage 1 and stage 2a);
    callers slice results back to ``rows.size``."""
    pad = bucket_capacity(rows.size, 1) - rows.size
    return torch.from_numpy(np.concatenate([rows, np.full((pad,), rows[0])]).astype(np.int64)).to(device)


def _rank(values: np.ndarray, candidates: np.ndarray, k: int) -> np.ndarray:
    """k candidate ids, ascending by (value, id) — the brute-force tie-break."""
    order = np.lexsort((candidates, values[candidates]))
    return candidates[order[:k]]


def anytime_frontier(lb, ub, resolved, k: int, epsilon: float):
    """The ε-convergence rule of ``mode="anytime"``: ``(frontier_mask, top,
    tau)``.  ``top`` is the current top-k by (certified upper bound, id),
    ``tau`` its k-th upper bound, and the frontier the unresolved members
    wider than ε plus the unresolved non-members with ``lb ≤ τ − ε``.  An
    empty frontier certifies the ε-approximate top-k; at ε = 0 it is the
    exact cascade's drain frontier."""
    n = int(lb.shape[0])
    order = np.lexsort((np.arange(n), ub))
    top = order[:k]
    tau = float(ub[top[-1]])
    in_top = np.zeros((n,), bool)
    in_top[top] = True
    unresolved = ~np.asarray(resolved, bool)
    # Tombstoned candidates carry lb = ub = +inf (width nan): never in the
    # top nor blocking it, so only the IEEE invalid-op warning is silenced.
    with np.errstate(invalid="ignore"):
        width_blockers = in_top & unresolved & ((ub - lb) > epsilon)
    member_blockers = ~in_top & unresolved & (lb <= tau - epsilon)
    return width_blockers | member_blockers, top, tau


def certified_recall(lb, ub, top, k: int) -> float:
    """Fraction of ``top`` provably in the exact top-k from intervals alone:
    hit i is certified iff at most k−1 others have ``lb_j < ub_i``."""
    if k <= 0:
        return 1.0
    top = np.asarray(top)
    ub_top = np.asarray(ub)[top]
    counts = (np.asarray(lb)[None, :] < ub_top[:, None]).sum(axis=1)
    counts -= (np.asarray(lb)[top] < ub_top).astype(counts.dtype)
    return float(int((counts <= k - 1).sum()) / k)


def _exact_value(query, pts, variant: str, backend: str, cfg: HDConfig) -> np.float32:
    from repro_torch import hd as _hd

    res = _hd.set_distance(query, pts, variant=variant, method="exact", backend=backend, config=cfg)
    return np.float32(res.value.item())


def masked_backend_ladder(first: str, device_kind: str) -> list[str]:
    """The masked-backend fallback ladder of one search.

    ``first`` (the requested or resolved backend) leads; on the CPU every
    other registered backend but the kernels' (``*_cuda``) follows, and a
    ``BackendUnavailable`` permanently advances the ladder (every backend
    returns the same top-k).  On the card the ladder is ``first`` alone:
    the others are plain versions, which never carry the path there, so
    an unavailable kernel backend exhausts the ladder and raises.
    """
    if device_kind == "cuda":
        return [first]
    return [first] + [b for b in sorted(masked.EXACT_MASKED_BACKENDS) if b != first and not b.endswith("_cuda")]


def search(
    query,
    store: SetStore,
    k: int,
    *,
    variant: str = "hausdorff",
    method: str = "cascade",
    backend: str = "auto",
    stage2: str = "batched",
    masked_backend: str | None = None,
    config: HDConfig | None = None,
    measure: bool = False,
    deadline_s: float | None = None,
    on_fault: str = "degrade",
    validate: bool = True,
    mode: str = "exact",
    epsilon: float = 0.0,
    budget: int | None = None,
    shards: int | None = None,
) -> SearchResult:
    kwargs = dict(
        variant=variant, method=method, backend=backend, stage2=stage2,
        masked_backend=masked_backend, config=config, measure=measure,
        deadline_s=deadline_s, on_fault=on_fault, validate=validate,
        mode=mode, epsilon=epsilon, budget=budget, shards=shards,
    )
    if not _obs.enabled():
        return _search_impl(query, store, k, **kwargs)
    with _obs.span(
        "index.search", k=k, variant=variant, method=method, stage2=stage2, mode=mode, shards=shards,
    ) as sp:
        res = _search_impl(query, store, k, **kwargs)
        sp.set(
            degraded=res.degraded,
            stage_reached=res.stage_reached,
            exact_refines=res.stats.get("exact_refines", 0),
            prune_fraction=res.stats.get("prune_fraction"),
            certified_recall=res.certified_recall_at_k,
        )
        _record_stats("index.search", res.stats)
        return res


def _search_impl(
    query,
    store: SetStore,
    k: int,
    *,
    variant: str = "hausdorff",
    method: str = "cascade",
    backend: str = "auto",
    stage2: str = "batched",
    masked_backend: str | None = None,
    config: HDConfig | None = None,
    measure: bool = False,
    deadline_s: float | None = None,
    on_fault: str = "degrade",
    validate: bool = True,
    mode: str = "exact",
    epsilon: float = 0.0,
    budget: int | None = None,
    shards: int | None = None,
) -> SearchResult:
    """Top-k nearest stored sets to ``query`` under a set distance.

    query    — (n_q, D) points (numpy or tensor; moved to the store's
               device), n_q ≥ 1
    store    — the SetStore to search
    k        — how many neighbours (k == 0 returns an empty result)
    variant  — hausdorff | directed (h(query → set))
    method   — cascade (certified bound cascade) | exact (brute force —
               every live set refined; the reference the cascade matches)
    backend  — backend for the exact refines (``repro_torch.hd`` names or
               "auto", resolved once per search: ``fused_cuda`` on the card)
    stage2   — batched (one masked exact pass per surviving bucket, then
               raw refines of the ≈ k boundary candidates) | sequential
               (raw refines of the whole frontier); identical bits
    masked_backend — the ``core.masked.EXACT_MASKED_BACKENDS`` name of the
               bucket passes (stages 1 and 2a); None resolves from the
               store's device: ``batched_cuda`` on the card,
               ``batched_mirror`` on the CPU.  On the CPU a
               ``BackendUnavailable`` moves the ladder to the next
               registered backend; on the card the ladder holds only the
               requested or resolved backend, so it raises.
    config   — HDConfig; ``alpha`` drives the stage-1 masked ProHD
    measure  — record wall seconds in ``meta.elapsed_s``
    deadline_s — wall-clock budget; on expiry the best certified state is
               returned with ``degraded=True`` (stage 0 always runs)
    on_fault — "degrade" (default) absorbs a runtime fault in stages 1+
               (recorded in ``stats['fault']``); "raise" propagates it.
               Stage-0 faults and programming errors always propagate.
    validate — reject non-finite query coordinates with a ValueError
    mode     — "exact" (drains to the brute-force top-k) | "anytime"
               (stops at the first ε-stable rung; ε = 0 with no budget runs
               the exact path)
    epsilon  — anytime: absolute distance tolerance, ε ≥ 0
    budget   — anytime: cap on raw refines (None = unbounded)
    shards   — corpus-parallel stages 0/1 over the first ``shards``
               visible devices of the store's kind
               (``repro_torch.index.sharded``): summaries split row-wise,
               stage-1 lanes dealt in contiguous blocks, then a cross-shard
               certified top-k merge (span ``cascade.shard_merge``) before
               the unchanged stage 2.  The top-k is bit for bit the
               unsharded one.  None (default) runs unsharded; 1 runs the
               sharded code on one device.  Not with mode="anytime" or
               method="exact" (ValueError).

    Tombstoned sets are certified out (their intervals pinned to +inf) and
    ``k_eff = min(k, store.n_live)``.
    """
    if variant not in SEARCH_VARIANTS:
        raise ValueError(f"unknown search variant {variant!r}; expected one of {SEARCH_VARIANTS}")
    if method not in SEARCH_METHODS:
        raise ValueError(f"unknown search method {method!r}; expected one of {SEARCH_METHODS}")
    if stage2 not in STAGE2_MODES:
        raise ValueError(f"unknown stage2 mode {stage2!r}; expected one of {STAGE2_MODES}")
    if on_fault not in ON_FAULT_MODES:
        raise ValueError(f"unknown on_fault mode {on_fault!r}; expected one of {ON_FAULT_MODES}")
    if mode not in SEARCH_MODES:
        raise ValueError(f"unknown search mode {mode!r}; expected one of {SEARCH_MODES}")
    epsilon = float(epsilon)
    if not np.isfinite(epsilon) or epsilon < 0.0:
        raise ValueError(f"epsilon must be a finite float >= 0, got {epsilon}")
    if budget is not None and int(budget) < 0:
        raise ValueError(f"budget must be None or an int >= 0, got {budget}")
    if mode == "exact" and (epsilon != 0.0 or budget is not None):
        raise ValueError("epsilon/budget are anytime knobs; pass mode='anytime' to use them")
    if mode == "anytime" and method == "exact":
        raise ValueError(
            "mode='anytime' rides the certified cascade; method='exact' "
            "(brute force) has no bounds to refine — drop one of the two"
        )
    # ε = 0 with no budget IS the exact cascade: run the exact code path.
    anytime = mode == "anytime" and (epsilon > 0.0 or budget is not None)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if masked_backend is not None and masked_backend not in masked.EXACT_MASKED_BACKENDS:
        raise ValueError(
            f"unknown masked backend {masked_backend!r}; expected one of "
            f"{tuple(sorted(masked.EXACT_MASKED_BACKENDS))}"
        )
    if store.n_sets == 0:
        raise ValueError("cannot search an empty SetStore")
    live = store.live_mask()
    n_live = int(live.sum())
    if n_live == 0:
        raise ValueError(
            "cannot search a SetStore with no live sets (every set was "
            "deleted); add sets or restore a snapshot first"
        )
    if shards is not None:
        if mode == "anytime":
            raise ValueError(
                "shards= is not supported with mode='anytime' (the anytime "
                "ladder does not run through the sharded path) — drop one of "
                "the two"
            )
        if method == "exact":
            raise ValueError(
                "shards= parallelises the cascade's stage 0/1; method='exact' "
                "(brute force) has no such stages — drop one of the two"
            )
    cfg = config if config is not None else HDConfig()
    q = as_tensor(query, store.device).float()
    if q.ndim != 2 or q.shape[1] != store.dim:
        raise ValueError(f"expected (n_q, {store.dim}) query, got shape {tuple(q.shape)}")
    if q.shape[0] < 1:
        raise ValueError("query must contain at least one point (HD is undefined on empty sets)")
    if validate and not bool(torch.isfinite(q).all()):
        raise ValueError(
            "query contains non-finite coordinates (NaN/Inf); certified "
            "bounds are undefined over them — clean the query or pass "
            "validate=False"
        )
    if k == 0:
        meta = HDMeta(
            variant=variant, method=method, backend=backend,
            block_a=0, block_b=0, elapsed_s=0.0 if measure else None, mode=mode,
        )
        stats0: dict[str, Any] = {
            "candidates_scanned": store.n_sets, "k": 0,
            "stage0_pruned": 0, "stage1_pruned": 0,
            "stage2_mode": stage2, "stage2_calls": 0,
            "stage2_distinct_shapes": 0, "stage2_batched_candidates": 0,
            "exact_refines": 0, "prune_fraction": 1.0, "mode": mode,
        }
        if mode == "anytime":
            stats0.update(epsilon=epsilon, budget=budget, anytime_refines=0, converged=True)
        return SearchResult(
            ids=np.zeros((0,), np.int32), values=np.zeros((0,), np.float32), stats=stats0, meta=meta,
        )

    t0 = _now() if measure else 0.0
    budget = None if budget is None else int(budget)
    deadline = _Budget(deadline_s)
    n = store.n_sets
    k_eff = min(k, n_live)
    has_dead = n_live < n
    dead = ~live if has_dead else None
    directed = variant == "directed"
    device_kind = q.device.type
    # Stages 0 and 1 and the stage-1 merge always run through the sharded
    # path; unsharded is its one-device case.
    if shards is None:
        shard_ctx = _sharded.ShardContext([q.device])
    else:
        shard_ctx = _sharded.make_shard_context(shards, device_kind)
    mb = masked_backend or resolver.resolve_masked_backend(int(q.shape[0]), 0, store.dim, device_kind=device_kind)
    available = masked_backend_ladder(mb, device_kind)
    backend_fallbacks: list[str] = []
    # One refine-backend decision per search, against the corpus's largest
    # set: set_distance then skips its own resolution on every refine.
    refine_backend = backend
    if backend == "auto":
        refine_backend = resolver.resolve_backend(
            variant, "exact", int(q.shape[0]), int(store.counts().max()),
            store.dim, device_kind=device_kind,
        )
    _obs.event(
        "cascade.backend_resolved", masked_backend=mb,
        refine_backend=refine_backend, device_kind=device_kind,
    )

    def _with_backend(call):
        """call(backend) under the fallback ladder; returns its result."""
        while True:
            be = available[0]
            try:
                _faults.fire(_POINT_BACKEND, backend=be)
                return call(be)
            except BackendUnavailable:
                backend_fallbacks.append(be)
                available.pop(0)
                _obs.event(
                    "cascade.backend_fallback", failed=be,
                    next=available[0] if available else None,
                )
                if not available:
                    raise

    values = np.full((n,), np.inf, np.float32)
    resolved = np.zeros((n,), bool)
    # Certified per-candidate interval state, vacuous-but-sound [0, +inf)
    # until a stage tightens it, so a degraded return is certified at
    # every point of the cascade.
    lb = np.zeros((n,), np.float64)
    ub = np.full((n,), np.inf, np.float64)
    # Anytime point estimates (NaN until a stage produces one).
    est = np.full((n,), np.nan, np.float64)
    anytime_refines = 0
    anytime_converged = False
    exact_refines = 0
    degraded = False
    stage_reached = "stage0"
    fault: BaseException | None = None
    stats: dict[str, Any] = {"candidates_scanned": n, "n_live": n_live, "k": k_eff}
    if shards is not None:
        stats["shards"] = shard_ctx.n_shards

    def checkpoint() -> None:
        if deadline.expired():
            raise _DeadlineHit()

    def refine(sid: int) -> None:
        nonlocal exact_refines
        values[sid] = _exact_value(q, store.get(sid), variant, refine_backend, cfg)
        resolved[sid] = True
        exact_refines += 1

    def gather(bucket, rows):
        take = _pow2_take(rows, q.device)
        return bucket.points.index_select(0, take), bucket.valid.index_select(0, take), int(take.shape[0])

    def tighten_stage1(bucket, rows) -> None:
        """Stage-1 certificates of one bucket's frontier rows, folded in."""
        hd1, lo1, up1, batch = _with_backend(lambda be: _sharded.stage1_certs(
            shard_ctx, q, bucket, rows, alpha=cfg.alpha, m=m, directed=directed, backend=be,
        ))
        _obs.event("cascade.stage1_pass", capacity=bucket.capacity, batch=batch, lanes=int(rows.size))
        lo1 = np.maximum(hd1, lo1)
        sids = bucket.set_ids[rows]
        lb1, ub1 = certified_margins(lo1, up1, scale[sids], store.dim)
        lb[sids] = np.maximum(lb[sids], lb1)
        ub[sids] = np.minimum(ub[sids], ub1)
        if anytime:
            est[sids] = np.clip(hd1, lb[sids], ub[sids])

    def tighten_stage2a(cap, sids, tau) -> None:
        """One bucket's batched exact pass over ``sids``, folded in."""
        nonlocal stage2_calls
        stats["stage2_batched_candidates"] += len(sids)
        bucket = buckets[cap]
        rows = np.asarray([slot[s][1] for s in sids])
        pts, val, batch = gather(bucket, rows)
        # Per-set gate: real lanes carry their certified lower bound against
        # a cutoff safely above τ (1e-6 relative headroom dwarfs the fp32
        # cast error, so a lane with lb ≤ τ is never skipped); the pow2
        # padding lanes ride in with lb = +inf and are always gated, which
        # drops their work in the kernel.
        gate_lb = torch.from_numpy(np.concatenate(
            [lb[sids], np.full((batch - rows.size,), np.inf)]).astype(np.float32)).to(q.device)
        gate_cut = torch.full(
            (batch,), tau * (1.0 + 1e-6) if np.isfinite(tau) else np.inf, device=q.device,
        )
        block_a, block_b = resolver.resolve_block_sizes(n_q, cap, store.dim, device_kind=device_kind)
        used_be, raw_vals = _with_backend(lambda be: (be, _stage2_batch(
            q, pts, val, gate_lb, gate_cut, directed=directed, backend=be,
            block_a=block_a, block_b=block_b,
        )))
        vals = raw_vals.double().cpu().numpy()[: rows.size]
        pad = fp_value_margin(store.dim, scale[sids], vals)
        lb[sids] = np.maximum(lb[sids], np.maximum(vals - pad, 0.0))
        ub[sids] = np.minimum(ub[sids], vals + pad)
        if anytime:
            est[sids] = np.clip(vals, lb[sids], ub[sids])
        stage2_shapes.add((cap, batch, used_be))
        stage2_calls += 1
        _obs.event("cascade.stage2a_pass", capacity=cap, batch=batch, lanes=len(sids), backend=used_be)

    if method == "exact":
        stats.update(stage0_pruned=0, stage1_pruned=0)
        try:
            _faults.fire(_POINT_STAGE2B)
            for sid in range(n):
                if has_dead and not live[sid]:
                    continue  # brute force over the SURVIVORS only
                checkpoint()
                refine(sid)
                lb[sid] = ub[sid] = float(values[sid])
            stage_reached = "stage2b"
        except _DeadlineHit:
            degraded = True
            stage_reached = "stage2b" if exact_refines else "stage0"
        except _DEGRADABLE as e:
            if on_fault == "raise":
                raise
            degraded = True
            fault = e
            stage_reached = "stage2b" if exact_refines else "stage0"
    else:
        m = projections.default_num_directions(store.dim)
        n_q = int(q.shape[0])
        counts = store.counts()
        # -- stage 0: summary bounds over the whole corpus, one shot ------
        # Always runs: it is the cheapest certified state and the floor of
        # the degradation ladder; a failure here propagates (typed).
        with _obs.span("cascade.stage0", n=n) as _sp0:
            _faults.fire(_POINT_STAGE0)
            qsum = store.summarize(q)
            sums = store.summaries()
            # Corpus rows split across the devices; the bound math is
            # row-local, so the concatenated bits are the unsharded ones.
            lb_t, ub_t, scale_t = _sharded.stage0_bounds(shard_ctx, qsum, sums, directed=directed)
            if shards is not None:
                _sp0.set(shards=shard_ctx.n_shards)
            lb_t, ub_t = certified_margins(lb_t, ub_t, scale_t, store.dim)
            scale = scale_t.double().cpu().numpy()
            lb = lb_t.double().cpu().numpy()
            ub = ub_t.double().cpu().numpy()
            if has_dead:
                # stale summary rows of tombstoned sets: pin to +inf
                lb[dead] = np.inf
                ub[dead] = np.inf
            tau = _kth_smallest(ub, k_eff)
            alive = lb <= tau
            stats["stage0_pruned"] = int(n - alive.sum())
            stats["stage1_pruned"] = 0
            _sp0.set(pruned=stats["stage0_pruned"])

        stage2_shapes: set[tuple] = set()
        stage2_calls = 0
        stats["stage2_batched_candidates"] = 0
        slot: dict[int, tuple[int, int]] = {}
        buckets: dict = {}

        def drain_raw() -> None:
            """Raw front-door resolution, ascending lower bound, until the
            frontier is empty — all of sequential mode, and stage 2b."""
            nonlocal alive, stage2_calls, stage_reached
            with _obs.span("cascade.stage2b") as _sp2b:
                _faults.fire(_POINT_STAGE2B)
                refines = 0
                while True:
                    tau = _kth_smallest(ub, k_eff)
                    alive &= lb <= tau
                    frontier = np.nonzero(alive & ~resolved)[0]
                    if frontier.size == 0:
                        _sp2b.set(refines=refines)
                        return
                    checkpoint()
                    sid = int(frontier[np.lexsort((frontier, lb[frontier]))[0]])
                    refine(sid)
                    stage2_shapes.add((int(counts[sid]),))
                    stage2_calls += 1
                    refines += 1
                    lb[sid] = ub[sid] = float(values[sid])
                    stage_reached = "stage2b"

        def run_anytime() -> None:
            """The anytime escalation ladder: the same certified stages, over
            the candidates the ε-stability of the top-k still requires,
            stopping when that frontier empties or the refine budget runs
            out (``converged=False``, never degraded)."""
            nonlocal stage_reached, anytime_refines, anytime_converged, slot, buckets
            with _obs.span(
                "cascade.anytime", epsilon=epsilon, budget=-1 if budget is None else budget, k=k_eff,
            ) as _spany:
                _faults.fire(_POINT_ANYTIME)
                cap_refines = resolver.resolve_anytime_refine_cap(n, k_eff, budget)
                front, _, _ = anytime_frontier(lb, ub, resolved, k_eff, epsilon)
                stage0_front = int(front.sum())

                if front.any():
                    checkpoint()
                    _faults.fire(_POINT_STAGE1)
                    for bucket in store.packed_buckets().values():
                        rows = np.nonzero(front[bucket.set_ids] & bucket.live)[0]
                        if rows.size == 0:
                            continue
                        checkpoint()
                        tighten_stage1(bucket, rows)
                        stage_reached = "stage1"
                    front, _, _ = anytime_frontier(lb, ub, resolved, k_eff, epsilon)

                if front.any():
                    checkpoint()
                    _faults.fire(_POINT_STAGE2A)
                    slot = store.slot_index()
                    buckets = store.packed_buckets()
                    groups: dict[int, list[int]] = {}
                    for sid in np.nonzero(front)[0]:
                        groups.setdefault(slot[int(sid)][0], []).append(int(sid))
                    for cap in sorted(groups, key=lambda c: min(lb[s] for s in groups[c])):
                        # Every frontier member provably has lb ≤ τ, so the
                        # gate can never skip a lane the ε-rule needs.
                        front2, _, tau = anytime_frontier(lb, ub, resolved, k_eff, epsilon)
                        sids = [s for s in groups[cap] if front2[s]]
                        if not sids:
                            continue
                        checkpoint()
                        tighten_stage2a(cap, sids, tau)
                        stage_reached = "stage2a"
                    front, _, _ = anytime_frontier(lb, ub, resolved, k_eff, epsilon)

                # greedy raw refinement, tightest-first (ascending lb, id)
                if front.any() and cap_refines > 0:
                    _faults.fire(_POINT_STAGE2B)
                while front.any() and anytime_refines < cap_refines:
                    checkpoint()
                    cand = np.nonzero(front)[0]
                    sid = int(cand[np.lexsort((cand, lb[cand]))[0]])
                    refine(sid)
                    lb[sid] = ub[sid] = est[sid] = float(values[sid])
                    anytime_refines += 1
                    stage_reached = "stage2b"
                    front, _, _ = anytime_frontier(lb, ub, resolved, k_eff, epsilon)
                anytime_converged = not bool(front.any())
                _spany.set(
                    refines=anytime_refines, converged=anytime_converged,
                    stage0_frontier=stage0_front, frontier_left=int(front.sum()),
                )

        try:
            # -- stage 1: bucketed masked ProHD on the survivors ----------
            if not anytime and int(alive.sum()) > k_eff:
                with _obs.span("cascade.stage1", frontier=int(alive.sum())) as _sp1:
                    checkpoint()
                    _faults.fire(_POINT_STAGE1)
                    for bucket in store.packed_buckets().values():
                        # ``& bucket.live``: an updated set's old slot is a
                        # tombstone whose certificate is +inf.
                        rows = np.nonzero(alive[bucket.set_ids] & bucket.live)[0]
                        if rows.size == 0:
                            continue
                        checkpoint()
                        tighten_stage1(bucket, rows)
                        stage_reached = "stage1"
                    # The certified top-k merge over the whole corpus; a
                    # sharded call traces it as the cross-shard merge.
                    with (_obs.span("cascade.shard_merge", shards=shard_ctx.n_shards)
                          if shards is not None else contextlib.nullcontext()) as _spm:
                        tau, still = _sharded.merge_topk(lb, ub, alive, k_eff)
                        stats["stage1_pruned"] = int(alive.sum() - still.sum())
                        if _spm is not None:
                            _spm.set(pruned=stats["stage1_pruned"])
                    alive = still
                    _sp1.set(pruned=stats["stage1_pruned"])

            # -- stage 2: exact refinement of the frontier ----------------
            if anytime:
                run_anytime()
            elif stage2 == "sequential":
                drain_raw()
            else:
                with _obs.span("cascade.stage2a") as _sp2a:
                    checkpoint()
                    _faults.fire(_POINT_STAGE2A)
                    slot = store.slot_index()
                    buckets = store.packed_buckets()
                    tau = _kth_smallest(ub, k_eff)
                    alive &= lb <= tau
                    frontier = np.nonzero(alive & ~resolved)[0]
                    groups = {}
                    for sid in frontier:
                        groups.setdefault(slot[int(sid)][0], []).append(int(sid))
                    # Ascending best-lower-bound bucket order, re-deriving τ
                    # between buckets: one bucket's tight intervals prune
                    # the next bucket's stragglers.
                    for cap in sorted(groups, key=lambda c: min(lb[s] for s in groups[c])):
                        tau = _kth_smallest(ub, k_eff)
                        sids = [s for s in groups[cap] if lb[s] <= tau]
                        if not sids:
                            continue
                        checkpoint()
                        tighten_stage2a(cap, sids, tau)
                        stage_reached = "stage2a"
                    _sp2a.set(batched_candidates=stats["stage2_batched_candidates"], calls=stage2_calls)
                # -- 2b: raw resolution of whatever still straddles the
                # boundary (≈ k candidates + exact ties)
                drain_raw()
        except _DeadlineHit:
            degraded = True
        except _DEGRADABLE as e:
            # an exhausted fallback ladder is not degradable: no backend is
            # left to serve any request
            if isinstance(e, BackendUnavailable) and not available:
                raise
            if on_fault == "raise":
                raise
            degraded = True
            fault = e
        stats.update(
            stage2_mode=stage2,
            stage2_calls=stage2_calls,
            stage2_distinct_shapes=len(stage2_shapes),
            masked_backend=available[0] if available else None,
        )

    if backend_fallbacks:
        stats["backend_fallbacks"] = list(backend_fallbacks)
    stats.update(
        exact_refines=exact_refines,
        prune_fraction=1.0 - exact_refines / n,
        refine_backend=refine_backend,
        mode=mode,
    )
    if mode == "anytime":
        stats.update(
            epsilon=epsilon, budget=budget, anytime_refines=anytime_refines,
            converged=anytime_converged if anytime else not degraded,
        )

    if not degraded and anytime:
        # Membership: the k smallest certified upper bounds (tie: id);
        # values exact where resolved, else the certified point estimate
        # clipped into [lb, ub]; presented ascending by (value, id).
        order = np.lexsort((np.arange(n), ub))
        top = order[:k_eff]
        pt = np.where(np.isnan(est), 0.5 * (lb + ub), np.clip(est, lb, ub))
        vals64 = np.where(resolved, values.astype(np.float64), pt)
        top = top[np.lexsort((top, vals64[top]))]
        out_values = vals64[top].astype(np.float32)
        out_lower = lb[top].copy()
        out_upper = ub[top].copy()
        stage_final = stage_reached
        recall = certified_recall(lb, ub, top, k_eff)
    elif not degraded:
        top = _rank(values, np.nonzero(resolved)[0], k_eff)
        out_values = values[top]
        out_lower = out_upper = out_values.astype(np.float64)
        stage_final = "complete"
        recall = 1.0
    else:
        # Best certified state reached: all candidates ascending by
        # certified upper bound (tie: dead-last, then id).
        order = np.lexsort((np.arange(n), dead if has_dead else np.zeros((n,), bool), ub))
        top = order[:k_eff]
        out_values = np.where(resolved[top], values[top], ub[top].astype(np.float32)).astype(np.float32)
        out_lower = lb[top].copy()
        out_upper = ub[top].copy()
        stage_final = stage_reached
        stats["n_resolved"] = int(resolved.sum())
        stats["deadline_s"] = deadline_s
        recall = certified_recall(lb, ub, top, k_eff)
        if fault is not None:
            stats["fault"] = _obs.exception_chain(fault)
            _obs.event("cascade.fault", error=True, stage=stage_reached, chain=stats["fault"])

    elapsed = _now() - t0 if measure else None
    meta = HDMeta(
        variant=variant, method=method, backend=backend,
        block_a=0, block_b=0, elapsed_s=elapsed,
        degraded=degraded, stage_reached=stage_final, mode=mode,
    )
    return SearchResult(
        ids=top.astype(np.int32), values=out_values, stats=stats, meta=meta,
        lower=out_lower, upper=out_upper,
        degraded=degraded, stage_reached=stage_final,
        certified_recall_at_k=recall,
    )


search.__doc__ = _search_impl.__doc__
