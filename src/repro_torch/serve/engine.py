"""Async admission-batching query engine — ``repro_torch.serve.engine``.

Counterpart of ``repro/serve/engine.py``.  :class:`ProHDService` is a synchronous collect-then-flush batcher: callers
queue requests and somebody calls ``flush()``.  :class:`QueryEngine` is the
serving loop that closes over it for concurrent callers::

    engine = QueryEngine(service)
    res = await engine.search(query, k=5)     # a SearchResult, same
                                              # certificate as hd.search()

Admission → batching → execution:

- **Admission** is bounded: past ``cfg.max_queue`` in-flight queries,
  ``search()`` raises the typed :class:`Overloaded` immediately —
  backpressure the caller sees, never a silent drop (the same contract as
  ``ProHDService.submit_search``).
- **Batching** groups admitted queries by *shape class* — the pair
  ``(bucket_capacity(n_q), variant)`` — so one class runs as ONE
  :func:`repro_torch.index.multiquery.search_batch` call: shared stage-0
  bound pass, shared query-axis bucket passes (kernel 3 on the card),
  deduplicated refines.  A class
  flushes as soon as it holds ``cfg.max_batch`` queries, or once its oldest
  member has waited ``cfg.max_wait_s`` — latency is bounded by the policy,
  not by traffic.
- **Execution** runs in a thread-pool executor (the cascade is synchronous
  NumPy/PyTorch) under :func:`run_with_recovery`: transient faults retry with
  exponential backoff, and past the retry budget the typed error is set on
  every waiter in the batch.  The batch inherits the MINIMUM remaining
  deadline among its members (stage sharing means one budget governs the
  launch); a member whose own deadline still has budget after a degraded
  batch pass gets an individual top-up ``search()`` — so per-query deadline
  semantics match the single-query path, and a query with no deadline is
  never degraded by a neighbour's.  In the executor thread the kernels
  launch on the store's device, on PyTorch's current stream for that
  thread, and the thread synchronises that device before a result crosses
  back to the event loop.

Every result is the unmodified per-query :class:`SearchResult` — the
certificate (bit-for-bit brute-force top-k, or a certified degraded
interval) is exactly what ``repro_torch.hd.search()`` would have returned.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.obs import trace as _obs
from repro_torch.obs.metrics import registry as _registry
from repro_torch.reliability import faults as _faults
from repro_torch.reliability.errors import Overloaded, ReliabilityError, TransientFault
from repro_torch.train.fault_tolerance import run_with_recovery

__all__ = ["EngineConfig", "QueryEngine"]

_POINT_ENGINE_FLUSH = _faults.declare_point(
    "engine.flush",
    "batched search_batch execution inside the engine's flush path — a "
    "transient raise here is retried with backoff (run_with_recovery); "
    "past the retry budget the typed error reaches every waiter",
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Admission / batching / retry policy for :class:`QueryEngine`."""

    # bounded admission: search() raises Overloaded past this many pending
    max_queue: int = 256
    # a shape class flushes at this many queries ...
    max_batch: int = 16
    # ... or once its oldest member has waited this long
    max_wait_s: float = 0.002
    # default per-query wall-clock budget (None = unbounded); an explicit
    # search(deadline_s=...) overrides it
    default_deadline_s: float | None = None
    # transient-fault retry budget per flush (run_with_recovery)
    max_retries: int = 2
    retry_backoff_s: float = 0.02
    # pin the masked bucket backend for every batch (None = auto-resolve)
    masked_backend: str | None = None


@dataclasses.dataclass
class _Pending:
    query: np.ndarray
    k: int
    variant: str
    deadline_abs: float | None  # monotonic-clock expiry, None = unbounded
    future: asyncio.Future
    enqueue_t: float
    # anytime knob (part of the shape class — one flush shares one ε, so a
    # batch never mixes exact and anytime members)
    mode: str = "exact"
    epsilon: float = 0.0
    budget: int | None = None
    # observability: the request id + the admission→completion root span
    # (a shared no-op object when tracing is off).  The span is finished
    # exactly once, wherever the future is resolved.
    rid: str | None = None
    root: object = None


class QueryEngine:
    """Async front end over a :class:`ProHDService`'s corpus.

    One engine serves one event loop at a time; the flusher task and wake
    event are (re)bound lazily to the running loop, so an engine object
    survives ``asyncio.run()`` boundaries in tests.
    """

    def __init__(self, service, cfg: EngineConfig = EngineConfig()):
        if service.store is None or service.store.n_sets == 0:
            raise ValueError("service has no corpus; add_set() first")
        self.service = service
        self.cfg = cfg
        # share the service's liveness marker: every delivered result beats
        # it with the query's admission-to-delivery wall time
        self.heartbeat = service.heartbeat
        self._pending: dict[tuple, list[_Pending]] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._event: asyncio.Event | None = None
        self._flusher: asyncio.Task | None = None
        self._closed = False
        self.stats = {"flushes": 0, "batched_queries": 0, "topups": 0}

    # -- lifecycle ---------------------------------------------------------

    def _ensure_loop(self) -> None:
        loop = asyncio.get_running_loop()
        if self._loop is not loop or self._flusher is None or self._flusher.done():
            self._loop = loop
            self._event = asyncio.Event()
            self._flusher = loop.create_task(self._run_flusher())

    async def close(self) -> None:
        """Stop the flusher; fail any still-pending queries typed."""
        self._closed = True
        if self._flusher is not None:
            self._flusher.cancel()
            try:
                await self._flusher
            except asyncio.CancelledError:
                pass
            self._flusher = None
        for lst in self._pending.values():
            for p in lst:
                if not p.future.done():
                    exc = RuntimeError("engine closed")
                    p.future.set_exception(exc)
                    if p.root is not None:
                        p.root.finish(exc)
        self._pending.clear()

    @property
    def pending(self) -> int:
        return sum(len(lst) for lst in self._pending.values())

    # -- admission ---------------------------------------------------------

    async def search(
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
    ):
        """Admit one query; resolves to its :class:`SearchResult`.

        Raises the typed :class:`Overloaded` when ``cfg.max_queue`` queries
        are already in flight.  Malformed input raises ``ValueError`` here,
        at admission — a bad query must bounce to its submitter, never
        poison a batch carrying everyone else's.

        ``mode`` / ``epsilon`` / ``budget`` are the per-request anytime
        knob (docs/api.md, "Anytime search contract").  The knob is part of
        the batching shape class, so one flush shares one ε — requests
        with different knobs never ride the same ``search_batch`` call.
        """
        from repro_torch.index import SEARCH_MODES, SEARCH_VARIANTS

        if self._closed:
            raise RuntimeError("engine closed")
        self._ensure_loop()
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if variant not in SEARCH_VARIANTS:
            raise ValueError(
                f"unknown search variant {variant!r}; expected one of {SEARCH_VARIANTS}"
            )
        if mode not in SEARCH_MODES:
            raise ValueError(
                f"unknown search mode {mode!r}; expected one of {SEARCH_MODES}"
            )
        epsilon = float(epsilon)
        if not np.isfinite(epsilon) or epsilon < 0.0:
            raise ValueError(f"epsilon must be a finite float >= 0, got {epsilon}")
        if budget is not None:
            budget = int(budget)
            if budget < 0:
                raise ValueError(f"budget must be None or an int >= 0, got {budget}")
        if mode == "exact" and (epsilon != 0.0 or budget is not None):
            raise ValueError(
                "epsilon/budget are anytime knobs; pass mode='anytime' to use them"
            )
        q = np.asarray(query, dtype=np.float32)
        dim = self.service.store.dim
        if q.ndim != 2 or q.shape[1] != dim:
            raise ValueError(f"expected (n_q, {dim}) query, got shape {q.shape}")
        if validate and not bool(np.isfinite(q).all()):
            raise ValueError(
                "query has non-finite coordinates (NaN/Inf); certified "
                "intervals are undefined over them — clean the input or "
                "pass validate=False"
            )
        if self.pending >= self.cfg.max_queue:
            raise Overloaded(self.pending, self.cfg.max_queue)
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        now = time.monotonic()
        from repro_torch.index.store import bucket_capacity

        cls = (bucket_capacity(q.shape[0], min_bucket=1), variant,
               mode, epsilon, budget)
        # Root span: admission → completion (finished where the future is
        # resolved, so its duration IS the request latency the batching
        # policy bounds).  A fresh rid correlates everything this request
        # touches, across the flusher task and the executor thread.
        rid = _obs.new_rid() if _obs.enabled() else None
        root = _obs.start_span(
            "engine.search", rid=rid, k=int(k), variant=variant,
            shape_class=cls[0], mode=mode,
        )
        root.event("engine.admit", queue_depth=self.pending)
        if _obs.enabled():
            _registry().gauge("engine.queue_depth").set(self.pending + 1)
        p = _Pending(
            query=q,
            k=int(k),
            variant=variant,
            deadline_abs=None if deadline_s is None else now + float(deadline_s),
            future=self._loop.create_future(),
            enqueue_t=now,
            mode=mode,
            epsilon=epsilon,
            budget=budget,
            rid=rid,
            root=root,
        )
        self._pending.setdefault(cls, []).append(p)
        self._event.set()
        return await p.future

    # -- batching ----------------------------------------------------------

    async def _run_flusher(self) -> None:
        while True:
            await self._event.wait()
            self._event.clear()
            while any(self._pending.values()):
                now = time.monotonic()
                full = [
                    c
                    for c, lst in self._pending.items()
                    if len(lst) >= self.cfg.max_batch
                ]
                if full:
                    cls = full[0]
                else:
                    # no class is full: flush the class holding the OLDEST
                    # query once it has aged max_wait_s, else sleep until
                    # then (woken early if new admissions change the picture)
                    cls, oldest = min(
                        ((c, lst[0].enqueue_t) for c, lst in self._pending.items() if lst),
                        key=lambda t: t[1],
                    )
                    wait = oldest + self.cfg.max_wait_s - now
                    if wait > 0:
                        try:
                            await asyncio.wait_for(self._event.wait(), timeout=wait)
                        except asyncio.TimeoutError:
                            pass
                        self._event.clear()
                        continue
                lst = self._pending.get(cls, [])
                batch = lst[: self.cfg.max_batch]
                del lst[: len(batch)]
                if not lst:
                    self._pending.pop(cls, None)
                for p in batch:
                    if p.future.cancelled() and p.root is not None:
                        p.root.finish()  # abandoned by the caller
                batch = [p for p in batch if not p.future.cancelled()]
                if batch:
                    await self._flush_batch(cls, batch)

    def _recover(self, attempt):
        return run_with_recovery(
            attempt,
            lambda: 0,
            max_failures=self.cfg.max_retries,
            retryable=(TransientFault,),
            backoff_s=self.cfg.retry_backoff_s,
        )

    def _in_executor(self, attempt, rid, parent_id):
        """Run ``attempt`` under retry in the executor thread: (rid, parent
        span) re-bound there (``run_in_executor`` does not carry context
        variables), the store's device current for the kernels' launches,
        and that device synchronised before the result leaves the thread."""
        dev = self.service.store.device

        def run():
            with contextlib.ExitStack() as stack:
                if rid is not None:
                    stack.enter_context(_obs.bind(rid, parent_id))
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                res = self._recover(attempt)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                return res

        return self._loop.run_in_executor(None, run)

    async def _flush_batch(self, cls: tuple, batch: list[_Pending]) -> None:
        from repro_torch.index.multiquery import search_batch

        _, variant, mode, epsilon, budget = cls
        queries = [p.query for p in batch]
        ks = [p.k for p in batch]
        now = time.monotonic()
        remaining = [
            max(p.deadline_abs - now, 0.0)
            for p in batch
            if p.deadline_abs is not None
        ]
        # shared stages mean one budget governs the launch: the batch runs
        # under the tightest member deadline; members with more budget get
        # an individual top-up below if this pass degraded them
        batch_deadline = min(remaining) if remaining else None

        def attempt(_start):
            _faults.fire(_POINT_ENGINE_FLUSH)
            return search_batch(
                queries,
                self.service.store,
                ks,
                variant=variant,
                masked_backend=self.cfg.masked_backend,
                deadline_s=batch_deadline,
                on_fault="degrade",
                validate=False,  # validated at admission
                mode=mode, epsilon=epsilon, budget=budget,
            )

        self.stats["flushes"] += 1
        self.stats["batched_queries"] += len(batch)
        # Flush span: adopts the FIRST member's rid (a single-request flush
        # — the common low-traffic case — therefore yields one connected
        # single-rid tree: engine.search → engine.flush → index.search_batch
        # → cascade stages); every member rid is recorded as an attribute.
        # The executor thread has no ambient context, so the flush frame is
        # re-established inside it with bind() — run_in_executor does not
        # propagate contextvars.
        p0 = batch[0]
        fspan = _obs.start_span(
            "engine.flush", rid=p0.rid,
            parent_id=getattr(p0.root, "span_id", None),
            shape_class=cls[0], variant=variant, batch=len(batch),
            member_rids=[p.rid for p in batch],
            deadline_s=batch_deadline, mode=mode,
        )
        if _obs.enabled():
            reg = _registry()
            reg.counter("engine.flushes.total").inc()
            reg.counter("engine.batched_queries.total").inc(len(batch))
            reg.histogram("engine.flush_batch_size").observe(len(batch))
            reg.gauge("engine.queue_depth").set(self.pending)
        try:
            results = await self._in_executor(attempt, fspan.rid, fspan.span_id)
        except ReliabilityError as e:
            fspan.finish(e)
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(e)
                p.root.finish(e)
            return
        fspan.finish()

        for p, res in zip(batch, results):
            if res.degraded:
                now2 = time.monotonic()
                if p.deadline_abs is None or now2 < p.deadline_abs:
                    res = await self._topup(p, res, now2)
                    if res is None:  # typed error already set on the future
                        continue
            if not p.future.done():
                p.future.set_result(res)
                wall = time.monotonic() - p.enqueue_t
                self.heartbeat.beat(wall_s=wall)
                if _obs.enabled():
                    margin = (
                        None if p.deadline_abs is None
                        else p.deadline_abs - time.monotonic()
                    )
                    p.root.set(
                        degraded=res.degraded,
                        stage_reached=res.stage_reached,
                        deadline_margin_s=margin,
                    )
                    _registry().histogram(
                        "engine.request_latency_s", unit="s"
                    ).observe(wall)
                    if margin is not None:
                        _registry().histogram(
                            "engine.deadline_margin_s", unit="s"
                        ).observe(margin)
            p.root.finish()

    async def _topup(self, p: _Pending, degraded_res, now: float):
        """Individual retry for a member degraded by the batch's shared
        (minimum) deadline while its OWN budget still has wall clock left."""
        from repro_torch.hd import search as hd_search

        topup_deadline = None if p.deadline_abs is None else p.deadline_abs - now

        def attempt(_start):
            _faults.fire(_POINT_ENGINE_FLUSH)
            return hd_search(
                p.query,
                self.service.store,
                p.k,
                variant=p.variant,
                masked_backend=self.cfg.masked_backend,
                deadline_s=topup_deadline,
                on_fault="degrade",
                validate=False,
                mode=p.mode, epsilon=p.epsilon, budget=p.budget,
            )

        self.stats["topups"] += 1
        tspan = _obs.start_span(
            "engine.topup", rid=p.rid,
            parent_id=getattr(p.root, "span_id", None),
            deadline_s=topup_deadline,
        )
        if _obs.enabled():
            _registry().counter("engine.topups.total").inc()
        try:
            res = await self._in_executor(attempt, tspan.rid, tspan.span_id)
            tspan.finish()
            return res
        except ReliabilityError as e:
            tspan.finish(e)
            if not p.future.done():
                p.future.set_exception(e)
            p.root.finish(e)
            return None
