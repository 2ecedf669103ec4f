"""Batched ProHD set-distance service — the paper's vector-DB use case as a
serving component.

Counterpart of ``repro/serve/server.py``.  Two request types:

- **pairwise** (``submit``): (A, B) cloud pairs.  The batcher buckets each
  SIDE independently by padded size (a small-vs-large pair does not pad
  both sides to the large bucket); each (bucket_a, bucket_b, D) class runs
  in chunks of ``max_batch`` as ONE lane-wise masked-ProHD call
  (``core.masked.masked_prohd_certified``, the code the corpus cascade's
  stage 1 runs), whose exact subset passes go through the masked backend
  the resolver picks for the device: the batched bucket kernel
  (``batched_cuda``) on the card, its plain version on the CPU.
- **corpus search** (``submit_search``): certified top-k retrieval against
  the service's :class:`repro_torch.index.SetStore` (``add_set`` to
  populate) through ``repro_torch.hd.search`` — bit for bit brute force.

What the reference's service has and this one drops: the LRU of compiled
shape classes and the power-of-two batch padding, which bound
``jax.jit``'s compile cache; PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import masked, projections
from repro_torch.device import resolve_device
from repro_torch.hd import resolver
from repro_torch.index.store import bucket_capacity, pack_sets
from repro_torch.obs import trace as _obs
from repro_torch.obs.metrics import registry as _registry
from repro_torch.reliability import faults as _faults
from repro_torch.reliability.errors import Overloaded, ReliabilityError, TransientFault
from repro_torch.train.fault_tolerance import Heartbeat, run_with_recovery

__all__ = ["ServeConfig", "ProHDService"]

_POINT_FLUSH = _faults.declare_point(
    "serve.flush",
    "per-search execution inside flush() — a transient raise here is "
    "retried with backoff (run_with_recovery), then surfaced typed",
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    alpha: float = 0.02
    bucket_sizes: tuple[int, ...] = (1024, 4096, 16384, 65536)
    max_batch: int = 8
    # store bucketing for corpus-search requests (SetStore min_bucket)
    min_store_bucket: int = 8
    # bounded admission: submit()/submit_search() raise the typed
    # Overloaded once this many requests are pending — backpressure, never
    # a silent drop
    max_queue: int = 1024
    # wall-clock budget per search request (None = unbounded); individual
    # submit_search(deadline_s=...) overrides this default
    default_deadline_s: float | None = None
    # transient-fault retry: up to max_retries re-attempts per search with
    # exponential backoff starting at retry_backoff_s
    max_retries: int = 2
    retry_backoff_s: float = 0.02


def _bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket holding n; beyond the largest configured
    bucket, the next power of two (never a capacity smaller than the
    request).  The round-up rule is the SetStore's."""
    for b in buckets:
        if n <= b:
            return b
    return bucket_capacity(n, min_bucket=1)


def _host(x) -> np.ndarray:
    """A cloud as host float32 numpy (what ``pack_sets`` packs)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def _finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.isfinite(np.asarray(x)).all())


class ProHDService:
    """Collects requests, flushes them in shape buckets.

    ``device`` is where pairwise lanes run and where a lazily created store
    lives (the card unless the caller asks for the CPU); a given ``store``
    brings its own.  Request ids are unique within one flush window (the
    counter resets at ``flush()``).
    """

    def __init__(self, cfg: ServeConfig = ServeConfig(), store=None, *, device=None):
        self.cfg = cfg
        self.store = store  # repro_torch.index.SetStore; lazily created by add_set
        self.device = store.device if store is not None else resolve_device(None, device)
        self._pending: list[tuple[int, object, object]] = []
        self._pending_searches: list[tuple] = []
        self._next_rid = 0
        # liveness marker: bumped once per completed request in flush()
        self.heartbeat = Heartbeat()

    def _admit(self) -> None:
        """Bounded admission: past max_queue pending requests, refuse with
        the typed Overloaded."""
        pending = len(self._pending) + len(self._pending_searches)
        if pending >= self.cfg.max_queue:
            raise Overloaded(pending, self.cfg.max_queue)

    # -- pairwise requests ---------------------------------------------------

    def submit(self, a, b, *, validate: bool = True) -> int:
        self._admit()
        a, b = (x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32) for x in (a, b))
        for name, cloud in (("a", a), ("b", b)):
            if cloud.ndim != 2:
                raise ValueError(f"cloud {name!r}: expected (n, D) points, got shape {tuple(cloud.shape)}")
            if validate and not _finite(cloud):
                raise ValueError(
                    f"cloud {name!r} has non-finite coordinates (NaN/Inf); "
                    "certified intervals are undefined over them — clean "
                    "the input or pass validate=False"
                )
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append((rid, a, b))
        return rid

    # -- corpus requests -----------------------------------------------------

    def add_set(self, points) -> int:
        """Add one set to the service's corpus; returns its store id."""
        if np.ndim(points) != 2:
            raise ValueError(f"expected (n, D) points, got shape {tuple(np.shape(points))}")
        if self.store is None:
            from repro_torch.index import SetStore

            self.store = SetStore(dim=int(points.shape[1]), min_bucket=self.cfg.min_store_bucket,
                                  device=self.device)
        return self.store.add(_host(points))

    def delete_set(self, sid: int) -> None:
        """Delete one corpus set (tombstone; see SetStore.delete).
        Synchronous like ``add_set``: every search queued after the call
        sees the new membership."""
        if self.store is None:
            raise ValueError("no corpus; add_set() first")
        self.store.delete(int(sid))

    def update_set(self, sid: int, points, *, validate: bool = True) -> None:
        """Replace one corpus set's points in place (same id; see
        SetStore.update)."""
        if self.store is None:
            raise ValueError("no corpus; add_set() first")
        self.store.update(int(sid), _host(points), validate=validate)

    def compact_store(self, capacity: int | None = None) -> dict[int, int]:
        """Force bucket compaction now (``SetStore.compact``)."""
        if self.store is None:
            raise ValueError("no corpus; add_set() first")
        return self.store.compact(capacity)

    def submit_search(
        self,
        query,
        k: int = 1,
        *,
        variant: str = "hausdorff",
        deadline_s: float | None = None,
        validate: bool = True,
        mode: str = "exact",
        epsilon: float = 0.0,
        budget: int | None = None,
    ) -> int:
        """Queue a top-k corpus retrieval against the shared SetStore.

        Validates HERE, not at flush(): a malformed queued search bounces
        to its submitter and never aborts a flush that carries everyone
        else's requests.  ``deadline_s`` budgets this request (overriding
        ``cfg.default_deadline_s``); ``mode`` / ``epsilon`` / ``budget``
        are the anytime knob.
        """
        from repro_torch.index import SEARCH_MODES, SEARCH_VARIANTS

        self._admit()
        if self.store is None or self.store.n_sets == 0:
            raise ValueError("no corpus to search; add_set() first")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if variant not in SEARCH_VARIANTS:
            raise ValueError(f"unknown search variant {variant!r}; expected one of {SEARCH_VARIANTS}")
        if mode not in SEARCH_MODES:
            raise ValueError(f"unknown search mode {mode!r}; expected one of {SEARCH_MODES}")
        epsilon = float(epsilon)
        if not np.isfinite(epsilon) or epsilon < 0.0:
            raise ValueError(f"epsilon must be a finite float >= 0, got {epsilon}")
        if budget is not None:
            budget = int(budget)
            if budget < 0:
                raise ValueError(f"budget must be None or an int >= 0, got {budget}")
        if mode == "exact" and (epsilon != 0.0 or budget is not None):
            raise ValueError("epsilon/budget are anytime knobs; pass mode='anytime' to use them")
        shape = np.shape(query)
        if len(shape) != 2 or shape[1] != self.store.dim:
            raise ValueError(f"expected (n_q, {self.store.dim}) query, got shape {tuple(shape)}")
        if validate and not _finite(query):
            raise ValueError(
                "query has non-finite coordinates (NaN/Inf); certified "
                "intervals are undefined over them — clean the input or "
                "pass validate=False"
            )
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        rid = self._next_rid
        self._next_rid += 1
        self._pending_searches.append((rid, query, k, variant, deadline_s, mode, epsilon, budget))
        return rid

    # -- execution -----------------------------------------------------------

    def flush(self) -> dict[int, dict]:
        """Run all pending requests.

        Pairwise results: {rid: {hd, lower, upper}}.
        Search results:   {rid: {ids, values, lower, upper, degraded,
        stage_reached, certified_recall, stats}} — exact top-k unless the
        request was anytime, its deadline expired or a runtime fault was
        absorbed (then ``degraded=True`` and [lower, upper] is certified).
        A search that keeps failing with a typed transient fault past
        ``cfg.max_retries`` retries yields ``{error, message}`` for THAT
        rid only.
        """
        with _obs.span("serve.flush", pairwise=len(self._pending), searches=len(self._pending_searches)):
            return self._flush_impl()

    def _flush_impl(self) -> dict[int, dict]:
        out: dict[int, dict] = {}
        by_bucket: dict[tuple[int, int, int], list] = {}
        for rid, a, b in self._pending:
            n_a = _bucket(a.shape[0], self.cfg.bucket_sizes)
            n_b = _bucket(b.shape[0], self.cfg.bucket_sizes)
            by_bucket.setdefault((n_a, n_b, int(a.shape[1])), []).append((rid, a, b))
        self._pending.clear()
        searches = list(self._pending_searches)
        self._pending_searches.clear()
        self._next_rid = 0
        if _obs.enabled():
            reg = _registry()
            reg.counter("serve.pairwise_requests.total").inc(sum(len(v) for v in by_bucket.values()))
            reg.counter("serve.search_requests.total").inc(len(searches))

        for (n_a, n_b, d), reqs in by_bucket.items():
            backend = resolver.resolve_masked_backend(n_a, n_b, d, device_kind=self.device.type)
            m = projections.default_num_directions(d)
            for i in range(0, len(reqs), self.cfg.max_batch):
                chunk = reqs[i : i + self.cfg.max_batch]
                t0 = time.perf_counter()
                pa, va = pack_sets([_host(a) for _, a, _ in chunk], n_a, d)
                pb, vb = pack_sets([_host(b) for _, _, b in chunk], n_b, d)
                cert = masked.masked_prohd_certified(
                    torch.from_numpy(pa).to(self.device), torch.from_numpy(va).to(self.device),
                    torch.from_numpy(pb).to(self.device), torch.from_numpy(vb).to(self.device),
                    alpha=self.cfg.alpha, m=m, backend=backend,
                )
                hd, lo, up = (t.double().cpu().numpy() for t in cert)
                # one pass serves the whole chunk: attribute an equal share
                # of its wall time to each request's heartbeat
                wall_each = (time.perf_counter() - t0) / len(chunk)
                for j, (rid, _, _) in enumerate(chunk):
                    out[rid] = {"hd": float(hd[j]), "lower": float(lo[j]), "upper": float(up[j])}
                    self.heartbeat.beat(wall_s=wall_each)

        from repro_torch.hd import search as hd_search

        for rid, query, k, variant, deadline_s, mode, epsilon, budget in searches:

            def attempt(_start, query=query, k=k, variant=variant, deadline_s=deadline_s,
                        mode=mode, epsilon=epsilon, budget=budget):
                _faults.fire(_POINT_FLUSH)
                return hd_search(query, self.store, k, variant=variant, deadline_s=deadline_s,
                                 mode=mode, epsilon=epsilon, budget=budget)

            t0 = time.perf_counter()
            with _obs.span("serve.search", request=rid, k=k, mode=mode) as _sspan:
                try:
                    res = run_with_recovery(
                        attempt, lambda: 0,
                        max_failures=self.cfg.max_retries,
                        retryable=(TransientFault,),
                        backoff_s=self.cfg.retry_backoff_s,
                    )
                except ReliabilityError as e:
                    # typed, per request: everyone else's results still land
                    out[rid] = {"error": type(e).__name__, "message": str(e)}
                    self.heartbeat.beat(wall_s=time.perf_counter() - t0)
                    _sspan.event("serve.search_failed", error=True, error_type=type(e).__name__)
                    continue
                _sspan.set(degraded=res.degraded, stage_reached=res.stage_reached)
            out[rid] = {
                "ids": res.ids.tolist(),
                "values": res.values.tolist(),
                "lower": res.lower.tolist(),
                "upper": res.upper.tolist(),
                "degraded": res.degraded,
                "stage_reached": res.stage_reached,
                "certified_recall": res.certified_recall_at_k,
                "stats": res.stats,
            }
            self.heartbeat.beat(wall_s=time.perf_counter() - t0)
        return out
