"""Typed reliability errors — the vocabulary of the fault-tolerance contract.

The port's own copy of ``repro/reliability/errors.py``: the same classes,
messages and hierarchy, so one test can drive either package.

Every failure the serving stack is allowed to surface is one of these (or a
plain ``ValueError`` for malformed input).  The core invariant the
fault-injection harness sweeps (``tests/test_fault_injection.py``): under
every injected fault the service returns either a certified — possibly
degraded — interval that still contains the true value, or one of THESE
typed errors.  A raw traceback of any other type escaping the service is a
bug; a silently wrong top-k is the one unforgivable outcome.

The hierarchy encodes retryability:

    ReliabilityError                 — base; never retried blindly
    ├── TransientFault               — safe to retry (backoff applies)
    │   ├── InjectedFault            — raised by the injection harness
    │   └── BackendUnavailable       — one masked backend down; the cascade
    │                                  falls back to the next registered one
    ├── StoreCorruption              — a snapshot bucket failed its checksum;
    │                                  names the bucket, never served
    └── Overloaded                   — admission queue full; backpressure,
                                       never a silent drop

This module is a dependency leaf (stdlib only), so every module of the
port can raise from it without cycles.
"""
from __future__ import annotations

__all__ = [
    "ReliabilityError",
    "TransientFault",
    "InjectedFault",
    "BackendUnavailable",
    "StoreCorruption",
    "Overloaded",
]


class ReliabilityError(RuntimeError):
    """Base of every typed fault the serving stack may surface."""


class TransientFault(ReliabilityError):
    """A fault that may succeed on retry (device hiccup, injected raise).

    A retry loop may retry these with backoff; anything NOT transient
    propagates immediately.
    """


class InjectedFault(TransientFault):
    """Deterministically injected by :mod:`repro_torch.reliability.faults`."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point!r}")
        self.point = point


class BackendUnavailable(TransientFault):
    """A masked-reduction backend cannot serve this call.

    The cascade catches this per bucket pass and falls back to the next
    registered ``EXACT_MASKED_BACKENDS`` entry (recorded in
    ``stats['backend_fallbacks']``); only when EVERY candidate backend is
    unavailable does the error propagate.
    """

    def __init__(self, backend: str):
        super().__init__(f"masked backend {backend!r} unavailable")
        self.backend = backend


class StoreCorruption(ReliabilityError):
    """A SetStore snapshot failed content verification on restore.

    Names exactly what failed so an operator can quarantine it:
    ``bucket`` is the capacity of the corrupt bucket payload (or None for
    a non-bucket artifact, e.g. the direction bank), ``path`` the file.
    A corrupt snapshot is NEVER served silently: restore either raises
    this or (``quarantine=True``) drops the named bucket and rebuilds
    summaries from the surviving sets.
    """

    def __init__(self, reason: str, *, bucket: int | None = None, path: str | None = None):
        super().__init__(reason)
        self.bucket = bucket
        self.path = path


class Overloaded(ReliabilityError):
    """Admission queue full — backpressure, the caller should shed or wait.

    Carries the queue depth so clients can adapt; raised at submit time,
    never by silently dropping an accepted request.
    """

    def __init__(self, pending: int, limit: int):
        super().__init__(
            f"admission queue full ({pending} pending >= max_queue={limit}); "
            "flush() or retry later"
        )
        self.pending = pending
        self.limit = limit
