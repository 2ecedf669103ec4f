"""Deterministic, seedable fault injection.

The port's own copy of ``repro/reliability/faults.py``: the same injection
points, actions and API (``Fault``, ``declare_point``, ``inject``, ``fire``).

Instrumented code declares **injection points** at import time
(:func:`declare_point`) and calls :func:`fire` at the matching place in its
hot path.  With no faults armed, ``fire`` is a dict lookup — nothing to
measure.  Tests arm faults with the :func:`inject` context manager::

    with inject(Fault("cascade.stage2a", action="raise")):
        res = search(q, store, k, on_fault="degrade")
    assert res.degraded and res.stage_reached in ("stage0", "stage1")

Faults are deterministic by construction: a fault fires on its
``after``-th hit of the point (a plain counter, reset each ``inject``
block), never on a clock or a random draw — the same test run always
explores the same failure.  The only randomness, snapshot byte corruption,
is seeded (:func:`corrupt_snapshot`).

Actions:

    raise        — raise :class:`InjectedFault` (a TransientFault: retry
                   machinery is expected to handle it)
    slow         — sleep ``delay_s`` (straggler simulation; with a search
                   deadline armed this forces the degraded path)
    backend_down — raise :class:`BackendUnavailable` for the backend named
                   in ``match`` (the cascade must fall back to the next
                   registered masked backend)

A sweep over :func:`injection_points` picks up every ``declare_point``
automatically; each point must prove the core invariant (a certified
interval containing the truth, or a typed error).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from repro_torch.obs import trace as _obs
from repro_torch.reliability.errors import BackendUnavailable, InjectedFault

__all__ = [
    "Fault",
    "declare_point",
    "injection_points",
    "inject",
    "fire",
    "active_faults",
    "corrupt_snapshot",
]


_POINTS: dict[str, str] = {}
_LOCK = threading.Lock()
# armed faults + per-fault hit counters; a plain list so nested inject()
# blocks compose (inner block sees outer faults too)
_ACTIVE: list["_Armed"] = []


@dataclasses.dataclass(frozen=True)
class Fault:
    """One armed fault: fires at ``point`` on its ``after``-th hit onwards.

    ``match`` filters on the context the instrumented site passes to
    ``fire`` (today: the backend name at ``cascade.backend``); None matches
    every hit.  ``once=True`` disarms the fault after its first firing —
    the shape of a transient blip that a retry survives.
    """

    point: str
    action: str = "raise"      # raise | slow | backend_down
    after: int = 0             # fire from the (after+1)-th hit
    delay_s: float = 0.05      # for action="slow"
    match: str | None = None   # for action="backend_down": backend name
    once: bool = False

    def __post_init__(self):
        if self.action not in ("raise", "slow", "backend_down"):
            raise ValueError(f"unknown fault action {self.action!r}")


class _Armed:
    def __init__(self, fault: Fault):
        self.fault = fault
        self.hits = 0
        self.spent = False


def declare_point(name: str, doc: str) -> str:
    """Register an injection point (module import time).  Idempotent."""
    with _LOCK:
        _POINTS[name] = doc
    return name


def injection_points() -> dict[str, str]:
    """{point name: description} over every instrumented module.

    Imports the instrumented modules first so their ``declare_point``
    calls have run — the sweep enumerates THIS, so a point cannot exist
    without being swept.
    """
    import repro_torch.index.cascade  # noqa: F401
    import repro_torch.index.store  # noqa: F401

    with _LOCK:
        return dict(_POINTS)


def active_faults() -> tuple[Fault, ...]:
    with _LOCK:
        return tuple(a.fault for a in _ACTIVE)


@contextlib.contextmanager
def inject(*faults: Fault):
    """Arm ``faults`` for the dynamic extent of the block (re-entrant)."""
    for f in faults:
        if f.point not in injection_points():
            raise ValueError(
                f"unknown injection point {f.point!r}; registered: "
                f"{sorted(injection_points())}"
            )
    armed = [_Armed(f) for f in faults]
    with _LOCK:
        _ACTIVE.extend(armed)
    try:
        yield
    finally:
        with _LOCK:
            for a in armed:
                _ACTIVE.remove(a)


def fire(point: str, **ctx) -> None:
    """Hit an injection point; acts iff a matching fault is armed.

    Instrumented code calls this with keyword context (e.g.
    ``backend="dense"``); match-filtered faults compare against it.
    """
    if not _ACTIVE:  # fast path: nothing armed (unlocked read is fine —
        return       # tests arm faults before entering the code under test)
    with _LOCK:
        due: list[Fault] = []
        for a in _ACTIVE:
            f = a.fault
            if f.point != point or a.spent:
                continue
            if f.match is not None and ctx.get("backend") != f.match:
                continue
            a.hits += 1
            if a.hits > f.after:
                if f.once:
                    a.spent = True
                due.append(f)
    for f in due:
        # One error-tagged event per firing, BEFORE acting, so the event
        # lands even when the action raises.  Carries the ambient rid —
        # inside a cascade/engine span the firing correlates to the request
        # it poisoned (asserted by the obs fault sweep).
        _obs.event(
            "fault.fired", error=True, point=point, action=f.action,
            **({"backend": str(ctx["backend"])} if "backend" in ctx else {}),
        )
        if f.action == "slow":
            time.sleep(f.delay_s)
        elif f.action == "backend_down":
            raise BackendUnavailable(str(ctx.get("backend")))
        else:
            raise InjectedFault(point)


def corrupt_snapshot(snapshot_dir, *, seed: int = 0) -> str:
    """Flip one byte of one bucket payload in a SetStore snapshot dir.

    Deterministic in ``seed`` (which bucket file, which byte).  Returns
    the corrupted file's path — restore() must detect the damage via its
    content checksum and raise :class:`StoreCorruption` naming it.
    """
    import numpy as np
    from pathlib import Path

    snapshot_dir = Path(snapshot_dir)
    targets = sorted(snapshot_dir.glob("bucket_*.npz"))
    if not targets:
        raise FileNotFoundError(f"no bucket payloads under {snapshot_dir}")
    rng = np.random.RandomState(seed)
    path = targets[int(rng.randint(len(targets)))]
    blob = bytearray(path.read_bytes())
    # flip a byte in the back half — past the zip header, inside array data
    pos = len(blob) // 2 + int(rng.randint(max(len(blob) // 4, 1)))
    pos = min(pos, len(blob) - 1)
    blob[pos] ^= 0xFF
    path.write_bytes(bytes(blob))
    return str(path)
