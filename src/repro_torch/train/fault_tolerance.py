"""Fault tolerance: retry-with-restore, heartbeats, straggler detection.

Counterpart of ``repro/train/fault_tolerance.py``.  The training loop
(``repro_torch.train.loop.fit``) wires these together, and the serving
layer uses the heartbeat and the retry:

  * every step (or completed request) bumps a :class:`Heartbeat`, with its
    wall time; :class:`HeartbeatMonitor`, a watchdog thread, flags a hang,
  * :func:`run_with_recovery` catches failures, restores, and resumes — up
    to ``max_failures`` times, with exponential backoff,
  * :class:`StragglerDetector` tracks per-step wall time and flags outliers
    (z-score over a rolling window).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

__all__ = ["Heartbeat", "HeartbeatMonitor", "StragglerDetector", "StepFailure", "RETRYABLE_DEFAULT",
           "run_with_recovery"]


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


class HeartbeatMonitor:
    """Background thread that calls ``on_hang`` if no beat for ``timeout``s."""

    def __init__(self, hb: Heartbeat, timeout: float, on_hang: Callable[[], None]):
        self.hb = hb
        self.timeout = timeout
        self.on_hang = on_hang
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self):
        while not self._stop.wait(min(1.0, self.timeout / 4)):
            if self.hb.age > self.timeout:
                self.on_hang()
                return


@dataclasses.dataclass
class StragglerDetector:
    """Rolling z-score on step durations.  ``observe`` returns True when the
    step is a straggler (z > threshold after warmup)."""

    window: int = 64
    threshold: float = 3.0
    warmup: int = 8

    def __post_init__(self):
        self._times: collections.deque[float] = collections.deque(maxlen=self.window)
        self.events: list[tuple[int, float]] = []
        self._step = 0

    def observe(self, duration: float) -> bool:
        self._step += 1
        is_straggler = False
        if len(self._times) >= self.warmup:
            mean = sum(self._times) / len(self._times)
            var = sum((t - mean) ** 2 for t in self._times) / len(self._times)
            std = max(var ** 0.5, 1e-9)
            if (duration - mean) / std > self.threshold:
                is_straggler = True
                self.events.append((self._step, duration))
        # stragglers don't poison the baseline window
        if not is_straggler:
            self._times.append(duration)
        return is_straggler


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
    to resume from.  ``repro_torch.train.loop.fit`` drives its steps with
    it; ``repro_torch.serve`` uses it for per-request retry:
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
