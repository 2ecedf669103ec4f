"""``repro_torch.obs`` — spans, events and metrics.

The port's own copies of ``repro.obs.trace`` and ``repro.obs.metrics``
(the span, event and metric names are the reference's).  Tracing is off by
default; a disabled site costs one flag check.  The reference's
export/report helpers and its XLA profiler bridge are not ported yet.
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, record_stats, registry
from repro_torch.obs.trace import (
    Span,
    bind,
    capture,
    current_rid,
    current_span_id,
    disable,
    drain,
    enable,
    enabled,
    event,
    events,
    exception_chain,
    new_rid,
    span,
    start_span,
)

__all__ = [
    "Span",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "record_stats",
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
