"""``repro_torch.reliability`` — typed faults and deterministic injection.

The port's own copies of ``repro.reliability``'s errors and fault
injection, with the same class names, injection-point names and API, so
one test can drive either package:

- **Typed errors** (:mod:`repro_torch.reliability.errors`):
  ``TransientFault`` (retryable), ``BackendUnavailable`` (masked-backend
  fallback), ``StoreCorruption`` (snapshot checksum), ``Overloaded``.
- **Fault injection** (:mod:`repro_torch.reliability.faults`): points
  declared by the cascade and the store, armed with :func:`inject`.
"""
from repro_torch.reliability.errors import (
    BackendUnavailable,
    InjectedFault,
    Overloaded,
    ReliabilityError,
    StoreCorruption,
    TransientFault,
)
from repro_torch.reliability.faults import (
    Fault,
    active_faults,
    corrupt_snapshot,
    declare_point,
    fire,
    inject,
    injection_points,
)

__all__ = [
    "ReliabilityError",
    "TransientFault",
    "InjectedFault",
    "BackendUnavailable",
    "StoreCorruption",
    "Overloaded",
    "Fault",
    "declare_point",
    "injection_points",
    "inject",
    "fire",
    "active_faults",
    "corrupt_snapshot",
]
