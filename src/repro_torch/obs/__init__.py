"""``repro_torch.obs`` — spans, events and metrics.

The port's own copies of ``repro.obs.trace`` and ``repro.obs.metrics``
(the cascade's and the store's span and event names are the reference's).
Tracing is off by default; a disabled site costs one flag check.  The
reference's export/report helpers and its XLA profiler bridge are not
ported yet.
"""
from repro_torch.obs.metrics import MetricsRegistry, record_stats, registry
from repro_torch.obs.trace import (
    capture,
    disable,
    drain,
    enable,
    enabled,
    event,
    events,
    exception_chain,
    span,
)

__all__ = [
    "MetricsRegistry",
    "registry",
    "record_stats",
    "enable",
    "disable",
    "enabled",
    "capture",
    "span",
    "event",
    "events",
    "drain",
    "exception_chain",
]
