"""``repro_torch.obs`` — spans, events, metrics, the JSONL export and its
report.

The port's own copies of ``repro.obs`` (``trace``, ``metrics``,
``export``, ``report``; the span, event and metric names and the export
schema are the reference's).  Tracing is off by default; a disabled site
costs one flag check.  ``enable(record_function=True)`` is the profiler
bridge (the reference's ``xla=True``): spans become
``torch.profiler.record_function`` ranges.

Quick start::

    from repro_torch import obs

    with obs.capture(jsonl="trace.jsonl") as get_events:
        search(q, store, k=5)
    print(obs.report.stage_table(get_events()))
"""
from repro_torch.obs import export, metrics, report, trace
from repro_torch.obs.export import OBS_SCHEMA_VERSION, SchemaError, read_jsonl, validate_events, write_jsonl
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
    "OBS_SCHEMA_VERSION",
    "SchemaError",
    "Span",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "bind",
    "capture",
    "current_rid",
    "current_span_id",
    "disable",
    "drain",
    "enable",
    "enabled",
    "event",
    "events",
    "exception_chain",
    "export",
    "metrics",
    "new_rid",
    "read_jsonl",
    "record_stats",
    "registry",
    "report",
    "span",
    "start_span",
    "trace",
    "validate_events",
    "write_jsonl",
]
