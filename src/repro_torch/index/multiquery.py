"""Batched multi-query certified cascade: ``search_batch``.

Counterpart of ``repro/index/multiquery.py``.  One call answers a whole
BATCH of queries against one :class:`SetStore` with every per-query
guarantee of ``repro_torch.index.cascade.search`` intact — each query's
top-k is bit for bit its own brute-force search — while sharing the work
the single-query loop repeats per query:

  stage 0 — one (Q × corpus) summary-bound pass: the per-query summaries
      are stacked with a broadcast axis through the same
      :func:`interval_bounds` / :func:`bound_scale` as the single query.
  stage 2a — batched exact tightening of every query's frontier.  When the
      backend gates in the kernel (``multiquery_cuda``, the card's
      default) or a backend is pinned, the union of every query's frontier
      in a bucket is gathered ONCE into a slab and measured in one
      multi-query pass (``masked.masked_exact_hd_multiquery``; on the card
      kernel 3): the batch shares the slab, and the per-(query, set) gate
      carries each query's own certified lower bound against its own
      cutoff τ_q, so pairs outside a query's frontier do no work.  Where
      the gate would only select lanes (the plain versions, CPU auto),
      stage 2a runs one gated pass per (unique query, bucket) over that
      query's own frontier, the single-query cascade's ``_stage2_batch``.
      Either way values enter as ``value ± fp_value_margin``.
  stage 2b — deduplicated raw refinement through the ``repro_torch.hd``
      front door, one drain per UNIQUE query, so every returned value is
      the number brute force computes.

The batch path skips the single-query cascade's stage 1 (masked ProHD per
lane): the multi-query stage 2a tightens every frontier pair of a bucket in
one gated pass, and pruning soundness only ever relied on the bounds being
certified.  Per-query stats record ``stage1_pruned = 0``.  ``shards=P``
splits stage 0's corpus axis across P devices
(``repro_torch.index.sharded``); stage 2a (kernel 3) is unchanged.

``deadline_s`` budgets the whole call (stage 0 always runs); on expiry or
an absorbed fault every query not yet completed returns its best certified
state as a DEGRADED result, and completed queries keep their exact ones.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import masked
from repro_torch.device import as_tensor
from repro_torch.hd import resolver
from repro_torch.hd.config import HDConfig
from repro_torch.hd.result import HDMeta
from repro_torch.index import cascade as _cascade
from repro_torch.index.cascade import (
    ON_FAULT_MODES,
    SEARCH_MODES,
    SEARCH_VARIANTS,
    SearchResult,
    _Budget,
    _DeadlineHit,
    _DEGRADABLE,
    _exact_value,
    _kth_smallest,
    _pow2_take,
    _rank,
    anytime_frontier,
    certified_margins,
    certified_recall,
    fp_value_margin,
    masked_backend_ladder,
)
from repro_torch.index import sharded as _sharded
from repro_torch.index.store import SetStore, SetSummary
from repro_torch.obs import trace as _obs
from repro_torch.obs.metrics import record_stats as _record_stats
from repro_torch.reliability import faults as _faults
from repro_torch.reliability.errors import BackendUnavailable

__all__ = ["search_batch"]


def _stack_query_summaries(summaries: list[SetSummary]) -> SetSummary:
    """Stack per-query summaries with a broadcast axis: each field (shape
    s...) becomes (Q, 1, *s...), ready to broadcast against the store's
    (N, ...) stacked summaries."""
    return SetSummary(*(torch.stack([getattr(s, f) for s in summaries])[:, None] for f in SetSummary._fields))


def search_batch(
    queries: Sequence,
    store: SetStore,
    k,
    *,
    variant: str = "hausdorff",
    backend: str = "auto",
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
) -> list[SearchResult]:
    kwargs = dict(
        variant=variant, backend=backend, masked_backend=masked_backend,
        config=config, measure=measure, deadline_s=deadline_s,
        on_fault=on_fault, validate=validate,
        mode=mode, epsilon=epsilon, budget=budget, shards=shards,
    )
    if not _obs.enabled():
        return _search_batch_impl(queries, store, k, **kwargs)
    queries = list(queries)  # materialize once: the span consumes len()
    with _obs.span("index.search_batch", batch=len(queries), variant=variant, mode=mode, shards=shards) as sp:
        results = _search_batch_impl(queries, store, k, **kwargs)
        if results:
            s = results[0].stats
            sp.set(
                unique_queries=s.get("unique_queries"),
                dedup_hits=s.get("dedup_hits"),
                launches=s.get("multiquery_launches"),
                degraded=any(r.degraded for r in results),
            )
            _record_stats("index.search_batch", s)
        return results


def _search_batch_impl(
    queries: Sequence,
    store: SetStore,
    k,
    *,
    variant: str = "hausdorff",
    backend: str = "auto",
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
) -> list[SearchResult]:
    """Top-k nearest stored sets for EVERY query in a batch.

    queries  — sequence of (n_i, D) point clouds (numpy or tensors; moved
               to the store's device; sizes may differ)
    store    — the SetStore to search
    k        — one int for all queries, or one per query (k_i == 0 gives
               that query's well-formed empty result)
    variant / backend / config / validate / on_fault — as in ``search()``
    masked_backend — the ``core.masked.EXACT_MASKED_BACKENDS`` name of the
               stage-2a passes.  None resolves from the store's device:
               ``multiquery_cuda`` (kernel 3, one shared-slab pass per
               bucket) on the card, ``multiquery_mirror`` on the CPU (one
               pass per unique query and bucket).  A pinned name takes the
               shared-slab pass; every name gives the same top-k.  On the
               card the ladder is this backend alone.
    deadline_s — wall-clock budget for the WHOLE call; on expiry, queries
               whose drain finished keep their exact results and the rest
               return their best certified state with ``degraded=True``
    mode / epsilon / budget — the anytime knob, shared by the whole batch;
               per query exactly ``search(mode=, epsilon=, budget=)``.
               With mixed k on duplicate queries the drain drives the
               UNION of every owner's ε-frontier and each owner's top-k is
               re-derived at its own k.  ε = 0 with no budget IS the exact
               batch path.
    shards   — stage 0's (Q × corpus) pass split across the first
               ``shards`` visible devices of the store's kind (the only
               corpus-granularity pass of the batch path; stage 2a is
               unchanged); bit for bit the unsharded results.  Not with
               mode="anytime" (ValueError).

    Tombstoned sets follow the single-query contract (intervals pinned to
    +inf, rank depth ``min(k_i, n_live)``).  Returns one
    :class:`SearchResult` per query, in input order.  Unless degraded,
    result i's ids/values are bit for bit ``search(queries[i], store,
    k_i)``'s and so query i's brute force.  Duplicate queries collapse to
    ONE cascade (``stats['dedup_hits']``); mixed k prefix-slices the shared
    (value, id) ranking.  ``measure=True`` stamps every result's
    ``meta.elapsed_s`` with the whole batch's wall time.
    """
    if variant not in SEARCH_VARIANTS:
        raise ValueError(f"unknown search variant {variant!r}; expected one of {SEARCH_VARIANTS}")
    if on_fault not in ON_FAULT_MODES:
        raise ValueError(f"unknown on_fault mode {on_fault!r}; expected one of {ON_FAULT_MODES}")
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
    if shards is not None and mode == "anytime":
        raise ValueError(
            "shards= is not supported with mode='anytime' (the anytime "
            "ladder does not run through the sharded path) — drop one of "
            "the two"
        )
    if mode not in SEARCH_MODES:
        raise ValueError(f"unknown search mode {mode!r}; expected one of {SEARCH_MODES}")
    epsilon = float(epsilon)
    if not np.isfinite(epsilon) or epsilon < 0.0:
        raise ValueError(f"epsilon must be a finite float >= 0, got {epsilon}")
    if budget is not None and int(budget) < 0:
        raise ValueError(f"budget must be None or an int >= 0, got {budget}")
    if mode == "exact" and (epsilon != 0.0 or budget is not None):
        raise ValueError("epsilon/budget are anytime knobs; pass mode='anytime' to use them")
    # ε = 0 with no budget IS the exact batch path, structurally.
    anytime = mode == "anytime" and (epsilon > 0.0 or budget is not None)
    budget = None if budget is None else int(budget)
    queries = list(queries)
    n_queries = len(queries)
    if n_queries == 0:
        return []
    if isinstance(k, (int, np.integer)):
        k_list = [int(k)] * n_queries
    else:
        k_list = [int(x) for x in k]
        if len(k_list) != n_queries:
            raise ValueError(f"per-query k sequence has length {len(k_list)}, expected {n_queries}")
    for ki in k_list:
        if ki < 0:
            raise ValueError(f"k must be >= 0, got {ki}")

    cfg = config if config is not None else HDConfig()
    dev = store.device
    qs_t: list[torch.Tensor] = []
    for qi, query in enumerate(queries):
        q = as_tensor(query, dev).float()
        if q.ndim != 2 or q.shape[1] != store.dim:
            raise ValueError(f"query {qi}: expected (n_q, {store.dim}) points, got shape {tuple(q.shape)}")
        if q.shape[0] < 1:
            raise ValueError(f"query {qi} must contain at least one point (HD is undefined on empty sets)")
        if validate and not bool(torch.isfinite(q).all()):
            raise ValueError(
                f"query {qi} contains non-finite coordinates (NaN/Inf); "
                "certified bounds are undefined over them — clean the "
                "query or pass validate=False"
            )
        qs_t.append(q)

    t0 = _cascade._now() if measure else 0.0
    deadline = _Budget(deadline_s)
    n = store.n_sets
    k_eff = [min(ki, n_live) for ki in k_list]
    has_dead = n_live < n
    dead = ~live if has_dead else None
    directed = variant == "directed"
    device_kind = dev.type
    # Stage 0 always runs through the sharded path; unsharded is its
    # one-device case.
    if shards is None:
        shard_ctx = _sharded.ShardContext([dev])
    else:
        shard_ctx = _sharded.make_shard_context(shards, device_kind)

    # -- dedup: duplicate queries collapse to one cascade -------------------
    uniq_of: dict[tuple[int, bytes], int] = {}
    owner: list[int] = []            # original index -> unique index
    uniq: list[torch.Tensor] = []
    for q in qs_t:
        key = (int(q.shape[0]), q.cpu().numpy().tobytes())
        if key not in uniq_of:
            uniq_of[key] = len(uniq)
            uniq.append(q)
        owner.append(uniq_of[key])
    n_unique = len(uniq)
    dedup_hits = n_queries - n_unique
    # Shared ranking depth per unique query: the max any owner asks for.
    k_u_all = [0] * n_unique
    for qi, ui in enumerate(owner):
        k_u_all[ui] = max(k_u_all[ui], k_eff[qi])
    act = [ui for ui in range(n_unique) if k_u_all[ui] > 0]
    a_of: dict[int, int] = {ui: ai for ai, ui in enumerate(act)}
    n_act = len(act)
    k_u = [k_u_all[ui] for ui in act]
    # Anytime only: the distinct owner depths per unique query.
    ks_of: list[list[int]] = [[] for _ in act]
    if anytime:
        for qi, ui in enumerate(owner):
            if ui in a_of and k_eff[qi] > 0 and k_eff[qi] not in ks_of[a_of[ui]]:
                ks_of[a_of[ui]].append(k_eff[qi])

    # One refine-backend decision per call, threaded through every refine.
    refine_backend = backend
    if backend == "auto" and n_act:
        refine_backend = resolver.resolve_backend(
            variant, "exact", max(int(uniq[ui].shape[0]) for ui in act),
            int(store.counts().max()), store.dim, device_kind=device_kind,
        )

    mqb = masked_backend or resolver.resolve_multiquery_backend(device_kind)
    available = masked_backend_ladder(mqb, device_kind)
    backend_fallbacks: list[str] = []
    _obs.event(
        "cascade.backend_resolved", masked_backend=mqb,
        refine_backend=refine_backend, device_kind=device_kind,
    )

    def _with_backend(call):
        while True:
            be = available[0]
            try:
                _faults.fire(_cascade._POINT_BACKEND, backend=be)
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

    def checkpoint() -> None:
        if deadline.expired():
            raise _DeadlineHit()

    # Per-active-unique certified interval state, (A, N), vacuous but sound
    # until a stage tightens it.
    values = np.full((n_act, n), np.inf, np.float32)
    resolved = np.zeros((n_act, n), bool)
    lb = np.zeros((n_act, n), np.float64)
    ub = np.full((n_act, n), np.inf, np.float64)
    est = np.full((n_act, n), np.nan, np.float64)
    converged = np.zeros((n_act,), bool)
    alive = np.ones((n_act, n), bool)
    scale = np.ones((n_act, n), np.float64)
    stage0_pruned = np.zeros((n_act,), np.int64)
    refines = np.zeros((n_act,), np.int64)
    s2a_pairs = np.zeros((n_act,), np.int64)
    completed = np.zeros((n_act,), bool)
    stage_reached = ["stage0"] * n_act
    launches = 0
    s2a_shapes: set[tuple] = set()
    fault: BaseException | None = None

    def _front_union(ai: int) -> np.ndarray:
        """Union of unique query ``ai``'s ε-frontiers over every distinct
        owner depth; empty ⇒ every owner's own-k top-k is converged."""
        front = np.zeros((n,), bool)
        for kk in ks_of[ai]:
            f, _, _ = anytime_frontier(lb[ai], ub[ai], resolved[ai], kk, epsilon)
            front |= f
        return front

    def fold(ai_rows, sids, vals, mask) -> None:
        """Fold stage-2a values (rows ``ai_rows`` × ``sids``) into the
        interval state as ``value ± fp_value_margin`` where ``mask``."""
        cur_lb, cur_ub = lb[np.ix_(ai_rows, sids)], ub[np.ix_(ai_rows, sids)]
        pad = fp_value_margin(store.dim, scale[np.ix_(ai_rows, sids)], vals)
        new_lb = np.where(mask, np.maximum(cur_lb, np.maximum(vals - pad, 0.0)), cur_lb)
        new_ub = np.where(mask, np.minimum(cur_ub, vals + pad), cur_ub)
        lb[np.ix_(ai_rows, sids)] = new_lb
        ub[np.ix_(ai_rows, sids)] = new_ub
        cur_est = est[np.ix_(ai_rows, sids)]
        est[np.ix_(ai_rows, sids)] = np.where(mask, np.clip(vals, new_lb, new_ub), cur_est)

    if n_act:
        # -- stage 0: ONE (Q × corpus) summary-bound pass -------------------
        # Always runs (the certified floor); failure here propagates.
        with _obs.span("cascade.stage0", n=n, queries=n_act) as _sp0:
            _faults.fire(_cascade._POINT_STAGE0)
            qsums = _stack_query_summaries([store.summarize(uniq[ui]) for ui in act])
            sums = store.summaries()
            # Corpus axis split across the devices; per-(query, set) bound
            # math is row-local, so the bits are the unsharded ones.
            lb_t, ub_t, scale_t = _sharded.stage0_bounds(shard_ctx, qsums, sums, directed=directed)
            if shards is not None:
                _sp0.set(shards=shard_ctx.n_shards)
            scale = scale_t.double().cpu().numpy()
            lb, ub = certified_margins(lb_t.double().cpu().numpy(), ub_t.double().cpu().numpy(), scale, store.dim)
            if has_dead:
                # Stale summary rows at tombstoned ids: pin to +inf.
                lb[:, dead] = np.inf
                ub[:, dead] = np.inf
            taus = np.asarray([_kth_smallest(ub[ai], k_u[ai]) for ai in range(n_act)])
            alive = lb <= taus[:, None]
            stage0_pruned = (n - alive.sum(axis=1)).astype(np.int64)
            _sp0.set(pruned=int(stage0_pruned.sum()))

        # The shared query slab of stage 2a: every active unique query in
        # its row prefix, with validity (padding cannot move a certified
        # bound; returned values come from raw refines on the raw points).
        nq_max = max(int(uniq[ui].shape[0]) for ui in act)
        q_slab = torch.zeros((n_act, nq_max, store.dim), device=dev)
        q_valid = torch.zeros((n_act, nq_max), dtype=torch.bool, device=dev)
        for row, ui in enumerate(act):
            q_slab[row, : uniq[ui].shape[0]] = uniq[ui]
            q_valid[row, : uniq[ui].shape[0]] = True

        # The port's one routing decision: the shared-slab pass pays only
        # where the gate drops work in the kernel (multiquery_cuda) — a
        # plain version would compute every query against the UNION of the
        # frontiers — or where a backend is pinned (how the CPU tests hold
        # it).  Otherwise one gated pass per (unique query, bucket).
        shared_slab = mqb == "multiquery_cuda" or masked_backend is not None
        try:
            if anytime:
                _faults.fire(_cascade._POINT_ANYTIME)
            # -- stage 2a: per surviving bucket, tighten the batch ----------
            with _obs.span("cascade.stage2a", shared_slab=shared_slab) as _sp2a:
                _faults.fire(_cascade._POINT_STAGE2A)
                slot = store.slot_index()
                buckets = store.packed_buckets()
                if anytime:
                    frontier = np.stack([_front_union(ai) for ai in range(n_act)])
                else:
                    frontier = alive & ~resolved
                groups: dict[int, list[int]] = {}
                for sid in np.nonzero(frontier.any(axis=0))[0]:
                    groups.setdefault(slot[int(sid)][0], []).append(int(sid))
                # Ascending best-lower-bound bucket order (min over the
                # batch), re-deriving every τ_q between buckets.
                for cap in sorted(groups, key=lambda c: lb[:, groups[c]].min()):
                    taus = np.asarray([_kth_smallest(ub[ai], k_u[ai]) for ai in range(n_act)])
                    cols = np.asarray(groups[cap], np.int64)
                    if anytime:
                        # Every union member has lb ≤ τ at some owner depth
                        # kk ≤ k_u, and τ is monotone in k, so the τ_{k_u}
                        # cut below never gates a lane the union needs.
                        mask = np.stack([_front_union(ai) for ai in range(n_act)])[:, cols]
                    else:
                        alive &= lb <= taus[:, None]
                        mask = alive[:, cols] & ~resolved[:, cols] & (lb[:, cols] <= taus[:, None])
                    keep = mask.any(axis=0)
                    if not keep.any():
                        continue
                    checkpoint()
                    sids = cols[keep]
                    mask = mask[:, keep]
                    bucket = buckets[cap]
                    rows = np.asarray([slot[int(s)][1] for s in sids])
                    cuts = np.where(np.isfinite(taus), taus * (1.0 + 1e-6), np.inf)

                    if shared_slab:
                        take = torch.from_numpy(rows).to(dev)
                        batch = int(sids.size)
                        # Per-(query, set) gate: each frontier pair carries
                        # its query's certified lower bound against a cutoff
                        # safely above that query's τ (the 1e-6 headroom of
                        # the single-query cascade); pairs outside a query's
                        # frontier ride in with lb = +inf and do no work.
                        gate_lb = np.where(mask, lb[:, sids], np.inf).astype(np.float32)
                        gate_cut = np.repeat(cuts.astype(np.float32)[:, None], batch, axis=1)
                        pts = bucket.points.index_select(0, take)
                        val = bucket.valid.index_select(0, take)

                        def _call_2a(be):
                            return be, masked.masked_exact_hd_multiquery(
                                q_slab, pts, valid_qs=q_valid, valid_slab=val,
                                lb=torch.from_numpy(gate_lb).to(dev), cut=torch.from_numpy(gate_cut).to(dev),
                                directed=directed, backend=be,
                            )

                        used_be, raw_vals = _with_backend(_call_2a)
                        vals = raw_vals.double().cpu().numpy()
                        fold(np.arange(n_act), sids, vals, mask)
                        launches += 1
                        s2a_shapes.add((cap, batch, used_be))
                        s2a_pairs += mask.sum(axis=1)
                        for ai in np.nonzero(mask.any(axis=1))[0]:
                            stage_reached[ai] = "stage2a"
                        _obs.event(
                            "cascade.stage2a_pass", capacity=cap, batch=batch, queries=n_act,
                            lanes=int(sids.size), pairs=int(mask.sum()), backend=used_be,
                        )
                    else:
                        # One gated pass per query over its OWN frontier
                        # columns: compute ∝ Σ_q |frontier_q|.
                        for ai in np.nonzero(mask.any(axis=1))[0]:
                            checkpoint()
                            q_sids = sids[mask[ai]]
                            q_rows = rows[mask[ai]]
                            take_q = _pow2_take(q_rows, dev)
                            batch_q = int(take_q.shape[0])
                            gate_lb_q = torch.from_numpy(np.concatenate(
                                [lb[ai, q_sids], np.full((batch_q - q_rows.size,), np.inf)]
                            ).astype(np.float32)).to(dev)
                            gate_cut_q = torch.full((batch_q,), float(cuts[ai]), device=dev)
                            pts_q = bucket.points.index_select(0, take_q)
                            val_q = bucket.valid.index_select(0, take_q)
                            q_raw = uniq[act[ai]]

                            def _call_2a_one(be, q_raw=q_raw, pts_q=pts_q, val_q=val_q,
                                             gate_lb_q=gate_lb_q, gate_cut_q=gate_cut_q):
                                block_a, block_b = resolver.resolve_block_sizes(
                                    int(q_raw.shape[0]), cap, store.dim, device_kind=device_kind,
                                )
                                return be, _cascade._stage2_batch(
                                    q_raw, pts_q, val_q, gate_lb_q, gate_cut_q,
                                    directed=directed, backend=be, block_a=block_a, block_b=block_b,
                                )

                            used_be, raw_vals = _with_backend(_call_2a_one)
                            vals = raw_vals.double().cpu().numpy()[None, : q_rows.size]
                            fold(np.asarray([ai]), q_sids, vals, np.ones_like(vals, bool))
                            launches += 1
                            s2a_shapes.add((cap, batch_q, used_be))
                            s2a_pairs[ai] += q_rows.size
                            stage_reached[ai] = "stage2a"
                            _obs.event(
                                "cascade.stage2a_pass", capacity=cap, batch=batch_q, queries=1,
                                lanes=int(q_rows.size), pairs=int(q_rows.size), backend=used_be,
                            )
                _sp2a.set(launches=launches, pairs=int(s2a_pairs.sum()))

            # -- stage 2b: deduplicated raw refinement, per unique query ----
            # Each (query, candidate) refines at most once, on RAW points,
            # so returned values are bit for bit brute force's.
            with _obs.span("cascade.stage2b") as _sp2b:
                _faults.fire(_cascade._POINT_STAGE2B)

                def refine(ai: int, sid: int) -> None:
                    values[ai, sid] = _exact_value(uniq[act[ai]], store.get(sid), variant, refine_backend, cfg)
                    resolved[ai, sid] = True
                    refines[ai] += 1
                    lb[ai, sid] = ub[ai, sid] = float(values[ai, sid])
                    stage_reached[ai] = "stage2b"

                for ai in range(n_act):
                    if anytime:
                        # Greedy budget-capped drain of the frontier union,
                        # ascending certified lower bound (tie: id).
                        with _obs.span(
                            "cascade.anytime", epsilon=epsilon,
                            budget=-1 if budget is None else budget, k=k_u[ai],
                        ) as _spany:
                            cap_r = resolver.resolve_anytime_refine_cap(n, budget)
                            front = _front_union(ai)
                            while front.any() and int(refines[ai]) < cap_r:
                                checkpoint()
                                cand = np.nonzero(front)[0]
                                sid = int(cand[np.lexsort((cand, lb[ai][cand]))[0]])
                                refine(ai, sid)
                                est[ai, sid] = float(values[ai, sid])
                                front = _front_union(ai)
                            converged[ai] = not bool(front.any())
                            # A budget stop is an honest partial answer, not
                            # degraded.
                            completed[ai] = True
                            _spany.set(refines=int(refines[ai]), converged=bool(converged[ai]))
                        continue
                    while True:
                        tau = _kth_smallest(ub[ai], k_u[ai])
                        alive[ai] &= lb[ai] <= tau
                        front = np.nonzero(alive[ai] & ~resolved[ai])[0]
                        if front.size == 0:
                            completed[ai] = True
                            break
                        checkpoint()
                        refine(ai, int(front[np.lexsort((front, lb[ai][front]))[0]]))
                _sp2b.set(refines=int(refines.sum()))
        except _DeadlineHit:
            pass  # per-query ``completed`` flags carry the degraded state
        except _DEGRADABLE as e:
            # an exhausted ladder is not degradable: no backend is left
            if isinstance(e, BackendUnavailable) and not available:
                raise
            if on_fault == "raise":
                raise
            fault = e
            _obs.event("cascade.fault", error=True, chain=_obs.exception_chain(e))

    # -- assembly: one result per unique, fanned out per original ----------
    elapsed = _cascade._now() - t0 if measure else None
    base_stats: dict[str, Any] = {
        "candidates_scanned": n,
        "n_live": n_live,
        "stage2_mode": "batched",
        "batch_queries": n_queries,
        "unique_queries": n_unique,
        "dedup_hits": dedup_hits,
        "dedup_hit_rate": dedup_hits / n_queries,
        "multiquery_launches": launches,
        "stage2_distinct_shapes": len(s2a_shapes),
        "masked_backend": available[0] if available else None,
        "refine_backend": refine_backend,
        "mode": mode,
    }
    if shards is not None:
        base_stats["shards"] = shard_ctx.n_shards
    if backend_fallbacks:
        base_stats["backend_fallbacks"] = list(backend_fallbacks)

    def _anytime_slice(ai: int, ki: int) -> tuple:
        """Anytime assembly for one unique query at one owner's own k:
        (ids, values, lower, upper, certified_recall) — membership by
        (ub, id), values exact where resolved else the clipped point
        estimate, presented ascending by (value, id)."""
        order = np.lexsort((np.arange(n), ub[ai]))
        top = order[:ki]
        pt = np.where(np.isnan(est[ai]), 0.5 * (lb[ai] + ub[ai]), np.clip(est[ai], lb[ai], ub[ai]))
        vals64 = np.where(resolved[ai], values[ai].astype(np.float64), pt)
        top = top[np.lexsort((top, vals64[top]))]
        recall = certified_recall(lb[ai], ub[ai], top, ki)
        return (top.astype(np.int32), vals64[top].astype(np.float32),
                lb[ai][top].copy(), ub[ai][top].copy(), recall)

    def _unique_result(ui: int) -> tuple:
        """(ids, values, lower, upper, degraded, stage, stats) for unique
        query ``ui`` at its shared ranking depth."""
        stats = dict(base_stats)
        if ui not in a_of:
            stats.update(k=0, stage0_pruned=0, stage1_pruned=0, stage2_calls=0,
                         stage2_batched_candidates=0, exact_refines=0, prune_fraction=1.0)
            if mode == "anytime":
                stats.update(epsilon=epsilon, budget=budget, anytime_refines=0, converged=True)
            empty = np.zeros((0,), np.float32)
            return (np.zeros((0,), np.int32), empty, empty.astype(np.float64),
                    empty.astype(np.float64), False, "complete", stats)
        ai = a_of[ui]
        stats.update(
            k=k_u[ai],
            stage0_pruned=int(stage0_pruned[ai]),
            stage1_pruned=0,
            stage2_calls=launches + int(refines[ai]),
            stage2_batched_candidates=int(s2a_pairs[ai]),
            exact_refines=int(refines[ai]),
            prune_fraction=1.0 - int(refines[ai]) / n,
        )
        if mode == "anytime":
            stats.update(
                epsilon=epsilon, budget=budget, anytime_refines=int(refines[ai]),
                # ε = 0 / no budget runs the exact path: converged iff its
                # drain completed.
                converged=bool(converged[ai]) if anytime else bool(completed[ai]),
            )
        if completed[ai] and anytime:
            top, out_values, out_lower, out_upper, _ = _anytime_slice(ai, k_u[ai])
            return top, out_values, out_lower, out_upper, False, stage_reached[ai], stats
        if completed[ai]:
            top = _rank(values[ai], np.nonzero(resolved[ai])[0], k_u[ai])
            out_values = values[ai][top]
            out_lower = out_upper = out_values.astype(np.float64)
            return top.astype(np.int32), out_values, out_lower, out_upper, False, "complete", stats
        order = np.lexsort((np.arange(n), ub[ai]))
        top = order[: k_u[ai]]
        out_values = np.where(resolved[ai][top], values[ai][top], ub[ai][top].astype(np.float32)).astype(np.float32)
        stats["n_resolved"] = int(resolved[ai].sum())
        stats["deadline_s"] = deadline_s
        if fault is not None:
            stats["fault"] = _obs.exception_chain(fault)
        return (top.astype(np.int32), out_values, lb[ai][top].copy(), ub[ai][top].copy(),
                True, stage_reached[ai], stats)

    per_unique = {ui: _unique_result(ui) for ui in set(owner)}
    results: list[SearchResult] = []
    for qi in range(n_queries):
        ui = owner[qi]
        ids, vals, low, up, deg, stage, stats = per_unique[ui]
        ki = k_eff[qi]
        stats = dict(stats, k=ki)
        recall = 1.0
        if ki > 0 and ui in a_of:
            ai = a_of[ui]
            if anytime and not deg:
                # Mixed-k owners re-derive their top-k at their own depth
                # (prefix slicing an est-ranking is not ε-sound).
                ids, vals, low, up, recall = _anytime_slice(ai, ki)
            elif deg:
                # The (ub, id) order is prefix-stable; only the
                # certificate is per-depth.
                recall = certified_recall(lb[ai], ub[ai], ids[:ki], ki)
        meta = HDMeta(
            variant=variant, method="cascade", backend=backend,
            block_a=0, block_b=0, elapsed_s=elapsed,
            degraded=deg, stage_reached=stage, mode=mode,
        )
        results.append(SearchResult(
            ids=ids[:ki].copy(), values=vals[:ki].copy(), stats=stats, meta=meta,
            lower=low[:ki].copy(), upper=up[:ki].copy(),
            degraded=deg, stage_reached=stage, certified_recall_at_k=recall,
        ))
    return results


search_batch.__doc__ = _search_batch_impl.__doc__
