"""Spans, request ids, and the event collector — the tracing half of
``repro_torch.obs``.

The port's own copy of ``repro/obs/trace.py``: the same span and event
names, record schema and API, ``start_span`` / ``bind`` for regions that
cross a thread hop (the query engine's) included.  The profiler bridge is
``enable(record_function=True)`` / ``capture(record_function=True)``, the
counterpart of the reference's ``xla=True``: each span then also opens a
``torch.profiler.record_function`` range of its name, so a
``torch.profiler`` trace shows the spans around the kernels they launch.

Design constraints (docs/api.md "Observability contract"):

- **Disabled by default, no-op fast path.**  Every instrumented site costs
  one module-global flag check when tracing is off: :func:`span` /
  :func:`event` return immediately (``span`` hands back a shared inert
  singleton, so even the ``with`` protocol touches no state).  The
  ``benchmarks --only obs`` lane measures this and ``scripts/check.sh``
  gates it (< 5% on the 5k-set cascade bench).
- **Monotonic-clock timing.**  Span durations come from
  ``time.monotonic()``; the wall-clock ``t_start`` stamp
  (``time.time()``) is for correlation only and never enters a duration.
- **Correlation.**  Every span carries a request id ``rid``.  The ambient
  (rid, parent span id) pair lives in a :mod:`contextvars` context
  variable, so nesting is automatic within a thread/task.  A span opened
  with no ambient context mints a fresh rid — a bare ``search()`` call
  still yields a correlated tree.  :func:`bind` re-establishes the pair
  across an executor hop, and :func:`start_span` opens a span that
  outlives a lexical scope (the engine's admission → completion).
- **Device time.**  On a CUDA path the host only queues work, so a
  span's ``dur_s`` times the enqueue.  A span opened with ``device=`` a
  CUDA ``torch.device`` (tracing on) also records a timing
  ``torch.cuda.Event`` on that device's current stream when it opens and
  another on the same stream when it finishes; its record then gains
  ``device_s``, the seconds between the stream reaching the two.  ``finish()`` never
  synchronises: ``device_s`` is resolved when the records are read, by
  :func:`events`, :func:`drain` and, for the JSONL export, by the time
  :func:`disable` returns (a line waits until its span's ``device_s`` is
  known; lines stay in emit order).  Each waits only on the events of the
  spans it resolves.  On the CPU, with ``device=None``, or while the
  stream is being captured into a CUDA graph, no events are recorded and
  the record has no ``device_s``.
- **One clock with the profiler.**  ``t_start`` is ``time.time()`` taken
  just before the bridge's ``record_function`` range opens, and
  ``torch.profiler``'s host stamps are Unix-epoch nanoseconds, so a span
  and its range start together on the device trace's clock.
- **One source of truth.**  On exit every span also feeds the default
  :class:`~repro_torch.obs.metrics.MetricsRegistry`: histogram
  ``span.<name>.s`` observes the duration and counter
  ``span.<name>.total`` the completion — the per-stage latency
  distributions exist without a single extra instrumentation site.

Span taxonomy of the pairwise path (``hd.*``; each passes the clouds'
``device``, and its attributes are values the host already has, so no
span reads a device tensor or adds a host sync):

    hd.set_distance        the front door's whole call (variant, method,
                           backend as resolved, n_a, n_b, d)
      hd.validate          the non-finite check of both clouds
      hd.prohd.directions  centroid + PCA directions (m, pca_method)
      hd.prohd.extremes    alpha-extremes, their packing to static
                           capacities and the prune reorder (cap_a, cap_b)
      hd.scan              one kernel-1 scan with its launcher's work
                           (rows, cols, d: the work handed to the kernel;
                           directed, pruned)
      hd.prohd.certificate additive bound + projected estimator (m)

Event records (the JSONL export schema of the reference's
``obs/export.validate_events``):

    {"type": "span",  "name": str, "rid": str, "span_id": int,
     "parent_id": int|null, "t_start": float, "dur_s": float,
     "status": "ok"|"error", "attrs": {...}, ["error": {chain}],
     ["device_s": float]}
    {"type": "event", "name": str, "rid": str|null, "span_id": int|null,
     "t": float, "error": bool, "attrs": {...}}
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from typing import Any, NamedTuple

__all__ = [
    "enable",
    "disable",
    "enabled",
    "capture",
    "new_rid",
    "current_rid",
    "current_span_id",
    "bind",
    "span",
    "start_span",
    "event",
    "events",
    "drain",
    "exception_chain",
]


class _Frame(NamedTuple):
    rid: str
    span_id: int | None


_CTX: contextvars.ContextVar[_Frame | None] = contextvars.ContextVar(
    "repro_obs_frame", default=None
)

_RIDS = itertools.count(1)
_SPAN_IDS = itertools.count(1)


class _State:
    """Process-global tracer state.  ``enabled`` is read unlocked on the
    hot path (a bool flip is atomic under the GIL and tests/benches flip
    it outside the measured region); everything else is lock-guarded."""

    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.events: list[dict] = []
        self.jsonl = None  # open file handle, or None
        self.record_function = False  # the profiler bridge
        # (record, start event, end event) of spans whose device_s is due
        self.pending: list[tuple[dict, Any, Any]] = []
        # JSONL lines held back, in emit order, behind a pending device_s
        self.unwritten: list[dict] = []


_STATE = _State()


def enabled() -> bool:
    """Is tracing on?  THE guard instrumented sites check before doing any
    attribute assembly beyond the bare :func:`span` call."""
    return _STATE.enabled


def enable(*, jsonl=None, record_function: bool = False) -> None:
    """Turn tracing on.

    jsonl           — optional path; every event is additionally appended to
                      it as one JSON line at emit time (the durable export).
                      The in-memory collector fills either way;
                      :func:`drain` empties it.
    record_function — the profiler bridge (the reference's ``xla=``): each
                      span also opens a ``torch.profiler.record_function``
                      range of its name, so it appears in a
                      ``torch.profiler`` trace around what it launches.
    """
    with _STATE.lock:
        if _STATE.jsonl is not None:
            _resolve_device_times(wait=True)
            _STATE.jsonl.close()
        _STATE.jsonl = open(jsonl, "a") if jsonl is not None else None
        _STATE.record_function = bool(record_function)
        _STATE.enabled = True


def disable() -> None:
    """Turn tracing off (the default state).  In-memory events are kept
    until :func:`drain`; the JSONL handle is closed, every line written."""
    with _STATE.lock:
        _STATE.enabled = False
        _STATE.record_function = False
        _resolve_device_times(wait=True)
        if _STATE.jsonl is not None:
            _STATE.jsonl.close()
            _STATE.jsonl = None


def events() -> list[dict]:
    """Copy of the in-memory event buffer (emit order), every span's
    ``device_s`` resolved."""
    with _STATE.lock:
        _resolve_device_times(wait=True)
        return list(_STATE.events)


def drain() -> list[dict]:
    """Return AND clear the in-memory event buffer (``device_s`` resolved)."""
    with _STATE.lock:
        _resolve_device_times(wait=True)
        out = _STATE.events
        _STATE.events = []
        return out


def _device_stream(device):
    """``device``'s current stream, whose work a span times, or None off
    CUDA and during a CUDA-graph capture."""
    if getattr(device, "type", None) != "cuda":
        return None
    import torch

    if torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream(device)


def _timing_event(stream):
    """A timing event recorded on ``stream``: the stream reaches it once the
    work queued before it has run."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _resolve_device_times(*, wait: bool) -> None:
    """Fill ``device_s`` of the pending spans (caller holds the lock):
    every one, waiting on its events, if ``wait``; else those whose
    events the stream has reached.  Then write the JSONL lines no longer
    held back."""
    due = []
    for rec, ev0, ev1 in _STATE.pending:
        if wait:
            ev0.synchronize()
            ev1.synchronize()
        elif not (ev0.query() and ev1.query()):
            due.append((rec, ev0, ev1))
            continue
        rec["device_s"] = ev0.elapsed_time(ev1) * 1e-3
    _STATE.pending = due
    if _STATE.jsonl is None:
        _STATE.unwritten = []
        return
    waiting = {id(rec) for rec, _, _ in due}
    n = 0
    for rec in _STATE.unwritten:
        if id(rec) in waiting:
            break
        _STATE.jsonl.write(json.dumps(rec) + "\n")
        n += 1
    if n:
        _STATE.jsonl.flush()
    del _STATE.unwritten[:n]


@contextlib.contextmanager
def capture(*, jsonl=None, record_function: bool = False):
    """Test/bench-scoped tracing: enable, yield the live event list getter,
    disable and restore on exit.  Drains pre-existing events so the block
    sees only its own.  ``record_function`` is :func:`enable`'s bridge."""
    prior_enabled = _STATE.enabled
    drain()
    enable(jsonl=jsonl, record_function=record_function)
    try:
        yield events
    finally:
        disable()
        if prior_enabled:
            enable()


def new_rid() -> str:
    """Mint a fresh request id (process-unique, monotone)."""
    return f"r{next(_RIDS):08d}"


def current_rid() -> str | None:
    f = _CTX.get()
    return f.rid if f is not None else None


def current_span_id() -> int | None:
    f = _CTX.get()
    return f.span_id if f is not None else None


@contextlib.contextmanager
def bind(rid: str, parent_id: int | None = None):
    """Re-establish (rid, parent span) across an explicit boundary — the
    engine hops its flush onto a thread-pool executor, where no ambient
    context exists; ``bind`` makes the cascade's spans land under the
    flush span with the request's rid."""
    token = _CTX.set(_Frame(rid, parent_id))
    try:
        yield
    finally:
        _CTX.reset(token)


def exception_chain(e: BaseException) -> list[dict]:
    """Structured exception chain, outermost first.

    Follows ``__cause__`` (explicit ``raise ... from ...``), falling back
    to a non-suppressed ``__context__`` — the same walk ``traceback``
    renders.  Each link is ``{"type", "message"}``; the list replaces the
    historical one-string flattening in ``stats['fault']`` so a wrapped
    root cause (e.g. a device error re-raised as a typed TransientFault)
    survives into logs and span events.  Cycle-guarded."""
    chain: list[dict] = []
    seen: set[int] = set()
    cur: BaseException | None = e
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        chain.append({"type": type(cur).__name__, "message": str(cur)})
        cur = cur.__cause__ or (
            cur.__context__ if not cur.__suppress_context__ else None
        )
    return chain


def _jsonable(v: Any) -> Any:
    """Best-effort conversion of attr values to JSON-clean types (numpy
    scalars/arrays show up naturally at call sites)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    for cast in (int, float):
        try:
            # numpy integer/floating scalars; jax scalars
            if hasattr(v, "item"):
                return _jsonable(v.item())
            return cast(v)
        except (TypeError, ValueError):
            continue
    return str(v)


def _emit(record: dict, marks: tuple | None = None) -> None:
    """Collect ``record``; ``marks`` (start, end events) make its
    ``device_s`` due."""
    with _STATE.lock:
        if not _STATE.enabled:
            return
        _STATE.events.append(record)
        if marks is not None:
            _STATE.pending.append((record, *marks))
        if _STATE.jsonl is not None:
            _STATE.unwritten.append(record)
            _resolve_device_times(wait=False)


class Span:
    """One timed, attributed, correlated region.  Use via :func:`span`
    (context manager) or :func:`start_span` (+ ``finish()``) when the
    region outlives a lexical scope (the engine's admission→completion)."""

    __slots__ = (
        "name", "attrs", "rid", "span_id", "parent_id",
        "_t0", "_t_start", "_token", "_rf", "_done", "status", "error",
        "_stream", "_ev0",
    )

    def __init__(self, name: str, rid: str | None, attrs: dict, parent_id: int | None = None,
                 device=None):
        frame = _CTX.get()
        self.name = name
        self.attrs = attrs
        self.rid = rid or (frame.rid if frame is not None else new_rid())
        self.span_id = next(_SPAN_IDS)
        self.parent_id = (
            parent_id if parent_id is not None
            else (frame.span_id if frame is not None else None)
        )
        self._token = None
        self._rf = None
        self._done = False
        self.status = "ok"
        self.error = None
        if _STATE.record_function:
            from torch.profiler import record_function

            self._rf = record_function(name)
        self._t_start = time.time()
        if self._rf is not None:
            self._rf.__enter__()
        self._stream = _device_stream(device)
        self._ev0 = None if self._stream is None else _timing_event(self._stream)
        self._t0 = time.monotonic()

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def event(self, name: str, *, error: bool = False, **attrs) -> None:
        """Point event correlated to THIS span (rid + span id)."""
        _emit({
            "type": "event", "name": name, "rid": self.rid,
            "span_id": self.span_id, "t": time.time(),
            "error": bool(error), "attrs": _jsonable(attrs),
        })

    def __enter__(self) -> "Span":
        self._token = _CTX.set(_Frame(self.rid, self.span_id))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        self.finish(exc)
        return False

    def finish(self, exc: BaseException | None = None) -> None:
        dur = time.monotonic() - self._t0
        if self._done:
            return
        self._done = True
        marks = None if self._ev0 is None else (self._ev0, _timing_event(self._stream))
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if exc is not None:
            self.status = "error"
            self.error = exception_chain(exc)
        record = {
            "type": "span", "name": self.name, "rid": self.rid,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "t_start": self._t_start, "dur_s": dur,
            "status": self.status, "attrs": _jsonable(self.attrs),
        }
        if self.error is not None:
            record["error"] = self.error
        _emit(record, marks)
        # fold into the metrics registry: per-span-name latency histogram
        # + completion counter — one source of truth, zero extra sites
        from repro_torch.obs import metrics as _metrics

        reg = _metrics.registry()
        reg.histogram(f"span.{self.name}.s", unit="s").observe(dur)
        reg.counter(f"span.{self.name}.total").inc()


class _NoopSpan:
    """Shared inert stand-in when tracing is off: every method is a no-op
    and carries no state, so one singleton serves every site re-entrantly."""

    __slots__ = ()
    name = rid = None
    span_id = parent_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs):
        return self

    def event(self, name, *, error=False, **attrs) -> None:
        return None

    def finish(self, exc=None) -> None:
        return None


_NOOP = _NoopSpan()


def span(name: str, *, rid: str | None = None, device=None, **attrs):
    """Open a span (context manager).  THE instrumentation entry point:
    when tracing is off this is one flag check and a shared inert object.
    ``device`` (a ``torch.device``): on CUDA the record gains ``device_s``,
    the device time of the work queued inside the span."""
    if not _STATE.enabled:
        return _NOOP
    return Span(name, rid, attrs, device=device)


def start_span(name: str, *, rid: str | None = None, parent_id: int | None = None, device=None,
               **attrs):
    """Start a span WITHOUT binding the ambient context — for regions that
    outlive a lexical scope (close with ``.finish()``), e.g. the engine's
    admission→completion.  Children must be parented explicitly via
    :func:`bind` (or ``parent_id``).  ``device`` as in :func:`span`."""
    if not _STATE.enabled:
        return _NOOP
    return Span(name, rid, attrs, parent_id=parent_id, device=device)


def event(name: str, *, error: bool = False, rid: str | None = None, **attrs) -> None:
    """Free-standing point event; correlates to the ambient span if any."""
    if not _STATE.enabled:
        return
    frame = _CTX.get()
    _emit({
        "type": "event", "name": name,
        "rid": rid or (frame.rid if frame is not None else None),
        "span_id": frame.span_id if frame is not None else None,
        "t": time.time(), "error": bool(error), "attrs": _jsonable(attrs),
    })
