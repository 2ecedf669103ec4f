"""Fault tolerance: heartbeats and retry-with-restore.

The port's own copy of the part of ``repro/train/fault_tolerance.py`` that
the serving layer uses: :class:`Heartbeat`, :func:`run_with_recovery` and
``RETRYABLE_DEFAULT``.  The hang monitor and straggler detector come with
the training loop.

  * every completed request (or step) bumps a Heartbeat, with its wall
    time; an external watchdog reads the payload,
  * ``run_with_recovery`` catches failures, restores, and resumes — up to
    ``max_failures`` times, with exponential backoff.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

__all__ = ["Heartbeat", "StepFailure", "RETRYABLE_DEFAULT", "run_with_recovery"]


class Heartbeat:
    """Thread-safe liveness marker, bumped once per step.

    ``beat(wall_s=...)`` additionally records the step's wall time:
    ``last_wall_s`` is the most recent reported duration and
    ``total_wall_s`` their monotone running sum — a watchdog reading the
    payload sees not just *that* the worker is alive but how long its
    requests are taking (``repro_torch.serve`` beats once per completed
    request with that request's wall time).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._count = 0
        self._last_wall_s = 0.0
        self._total_wall_s = 0.0

    def beat(self, wall_s: float | None = None) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._count += 1
            if wall_s is not None:
                self._last_wall_s = float(wall_s)
                self._total_wall_s += float(wall_s)
        # Fold into the obs registry when tracing is on: the liveness
        # counter and per-beat wall-time distribution become scrapeable
        # metrics alongside the span-derived ones (one source of truth).
        from repro_torch.obs import metrics as _metrics, trace as _trace

        if _trace.enabled():
            reg = _metrics.registry()
            reg.counter("heartbeat.beats.total").inc()
            if wall_s is not None:
                reg.histogram("heartbeat.wall_s", unit="s").observe(float(wall_s))

    @property
    def age(self) -> float:
        with self._lock:
            return time.monotonic() - self._last

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def last_wall_s(self) -> float:
        with self._lock:
            return self._last_wall_s

    @property
    def total_wall_s(self) -> float:
        with self._lock:
            return self._total_wall_s


class StepFailure(RuntimeError):
    pass


RETRYABLE_DEFAULT: tuple[type[BaseException], ...] = (
    StepFailure,
    FloatingPointError,
    RuntimeError,
)


def run_with_recovery(
    run_fn: Callable[[int], int],
    restore_fn: Callable[[], int],
    *,
    max_failures: int = 3,
    on_failure: Callable[[BaseException, int], None] | None = None,
    retryable: tuple[type[BaseException], ...] = RETRYABLE_DEFAULT,
    backoff_s: float = 0.0,
    sleep: Callable[[float], None] = time.sleep,
):
    """Drive ``run_fn(start_step)`` with restore-on-failure.

    ``restore_fn() -> step`` reloads the latest state and returns the step
    to resume from.  ``repro_torch.serve`` uses it for per-request retry:
    ``retryable=(TransientFault,)`` retries ONLY the typed transient
    faults, with exponential backoff ``backoff_s · 2^(failures−1)``
    between attempts (``sleep`` is injectable so tests never wall-clock
    wait).  Non-retryable exceptions propagate immediately, untouched;
    past ``max_failures`` the last failure propagates.
    """
    failures = 0
    start = restore_fn()
    while True:
        try:
            return run_fn(start)
        except retryable as e:
            failures += 1
            if on_failure is not None:
                on_failure(e, failures)
            if failures > max_failures:
                raise
            if backoff_s > 0.0:
                sleep(backoff_s * (2.0 ** (failures - 1)))
            start = restore_fn()
