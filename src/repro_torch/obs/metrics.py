"""Typed metrics — counters, gauges, log-spaced-bucket histograms.

The port's own copy of ``repro/obs/metrics.py`` (same names and buckets).

The registry is the single source of truth the ad-hoc ``stats`` dicts
(cascade / multiquery / engine) and the training ``Heartbeat`` fold into:
instrumented sites update named instruments here when tracing is enabled,
and every finished span auto-observes into ``span.<name>.s``.

Zero dependencies, thread-safe (one lock per instrument — contention is
nil at the rates the repro emits), and two export surfaces:

- :meth:`MetricsRegistry.snapshot` — plain nested dict for tests/JSON.
- :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  (``# TYPE`` lines, cumulative ``_bucket{le=...}`` + ``_sum``/``_count``
  for histograms) so a scrape endpoint is a ``return to_prometheus()``.

Histogram buckets are **fixed log-spaced** boundaries, 3 per decade from
1e-6 to 1e3 (1·10ᵏ, 2.15·10ᵏ, 4.64·10ᵏ) — 28 buckets spanning
microseconds to ~17 minutes, so second-denominated latencies from a
no-op span to a full snapshot restore land with ~2× relative resolution
and every histogram in the process is mergeable with every other.
"""
from __future__ import annotations

import threading
from bisect import bisect_left

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry", "DEFAULT_BUCKETS"]

# 3 buckets/decade, 1e-6 .. 1e3: [1e-6, 2.154e-6, 4.642e-6, 1e-5, ...]
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    round(10.0 ** (e / 3.0), 12) for e in range(-18, 10)
)


class Counter:
    """Monotone accumulator (float — byte totals ride the same type)."""

    __slots__ = ("name", "unit", "_value", "_lock")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "unit": self.unit, "value": self._value}


class Gauge:
    """Last-write-wins level (queue depth, corpus size, deadline margin)."""

    __slots__ = ("name", "unit", "_value", "_lock")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "unit": self.unit, "value": self._value}


class Histogram:
    """Fixed-boundary histogram (log-spaced, see DEFAULT_BUCKETS).

    Counts are per-interval (not cumulative) internally; the Prometheus
    exposition cumulates on render.  ``observe`` is O(log n_buckets).
    """

    __slots__ = ("name", "unit", "bounds", "_counts", "_sum", "_count", "_min", "_max", "_lock")

    def __init__(self, name: str, unit: str = "", bounds: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.unit = unit
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # last = +inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bisect_left(self.bounds, v)  # bucket upper bounds are inclusive
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation) — good to the ~2× bucket width, which
        is what log-spaced buckets buy."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank and c:
                    if i >= len(self.bounds):
                        return self._max
                    return min(self.bounds[i], self._max)
        return self._max

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "type": "histogram", "unit": self.unit,
                "count": self._count, "sum": self._sum,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
                "buckets": {
                    **{f"{b:g}": c for b, c in zip(self.bounds, self._counts) if c},
                    **({"+Inf": self._counts[-1]} if self._counts[-1] else {}),
                },
            }


def _prom_name(name: str) -> str:
    """metric names like ``span.index.search.s`` → ``span_index_search_s``."""
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


class MetricsRegistry:
    """Get-or-create home for named instruments.

    Re-requesting a name returns the same instrument; requesting an
    existing name as a different type raises — silent type drift is how
    dashboards rot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}"
                )
            return inst

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get(name, Counter, unit=unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get(name, Gauge, unit=unit)

    def histogram(self, name: str, unit: str = "", bounds: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, unit=unit, bounds=bounds)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict:
        """``{name: instrument.snapshot()}`` — stable (sorted) order."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def reset(self) -> None:
        """Drop every instrument (tests/benches isolate through this)."""
        with self._lock:
            self._instruments.clear()

    def to_prometheus(self) -> str:
        """Prometheus text exposition format, one block per instrument."""
        lines: list[str] = []
        with self._lock:
            items = sorted(self._instruments.items())
        for name, inst in items:
            pname = _prom_name(name)
            if isinstance(inst, (Counter, Gauge)):
                kind = "counter" if isinstance(inst, Counter) else "gauge"
                lines.append(f"# TYPE {pname} {kind}")
                lines.append(f"{pname} {inst.value:g}")
            elif isinstance(inst, Histogram):
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                snap_counts = list(inst._counts)
                for b, c in zip(inst.bounds, snap_counts):
                    cum += c
                    if c:  # sparse exposition: skip untouched interior buckets
                        lines.append(f'{pname}_bucket{{le="{b:g}"}} {cum}')
                cum += snap_counts[-1]
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {inst.sum:g}")
                lines.append(f"{pname}_count {inst.count}")
        return "\n".join(lines) + ("\n" if lines else "")


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-default registry (what spans and instrumented sites use)."""
    return _REGISTRY


def record_stats(prefix: str, stats: dict) -> None:
    """Fold one request's ``stats`` dict into the default registry.

    Every numeric value becomes an observation in histogram
    ``<prefix>.<key>`` — per-request distributions (prune_fraction,
    exact_refines, flush batch sizes) with zero per-site wiring; this is
    how the historical ad-hoc stats dicts surface as metrics.  No-op when
    tracing is disabled (the sites' single-flag-check discipline)."""
    from repro_torch.obs import trace as _trace

    if not _trace.enabled():
        return
    for key, v in stats.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        _REGISTRY.histogram(f"{prefix}.{key}").observe(float(v))
