"""JSONL event export: schema constants, validation, reading.

The port's own copy of ``repro/obs/export.py``, with the same schema
(version ``OBS_SCHEMA_VERSION``), so an export of the port passes the
reference's ``validate_events`` and the reference's passes this one.  Two
record shapes share one stream:

span record
    ``type="span"``, ``name`` (str), ``rid`` (str), ``span_id`` (int),
    ``parent_id`` (int or null), ``t_start`` (float, unix seconds),
    ``dur_s`` (float, monotonic-clock duration), ``status`` ("ok"|"error"),
    ``attrs`` (JSON object), optional ``error`` (exception-chain list of
    ``{"type", "message"}``, outermost first — present iff status="error"),
    optional ``device_s`` (non-negative float, the device time of the
    work queued inside the span on CUDA; the reference's validator ignores
    it).

event record
    ``type="event"``, ``name`` (str), ``rid`` (str or null),
    ``span_id`` (int or null, the enclosing span), ``t`` (float, unix
    seconds), ``error`` (bool), ``attrs`` (JSON object).

Validation is structural and total: :func:`validate_events` raises
``SchemaError`` naming the first offending record and field, so a gate
failure points at the emitting site, not at a diff of two JSON blobs.
"""
from __future__ import annotations

import json

__all__ = ["OBS_SCHEMA_VERSION", "SchemaError", "validate_events", "read_jsonl", "write_jsonl"]

OBS_SCHEMA_VERSION = 1


class SchemaError(ValueError):
    """An event record violates the documented JSONL schema."""


def _require(rec: dict, i: int, field: str, types, nullable: bool = False):
    if field not in rec:
        raise SchemaError(f"record {i}: missing field {field!r}: {rec!r}")
    v = rec[field]
    if v is None:
        if not nullable:
            raise SchemaError(f"record {i}: field {field!r} is null: {rec!r}")
        return v
    if not isinstance(v, types):
        raise SchemaError(
            f"record {i}: field {field!r} has type {type(v).__name__}, "
            f"expected {types}: {rec!r}"
        )
    return v


def validate_events(events: list[dict]) -> dict:
    """Validate a list of event records against the schema.

    Returns summary stats ``{"spans", "events", "errors", "rids"}`` on
    success (gates assert on these); raises :class:`SchemaError` on the
    first violation.  Also checks referential integrity: every non-null
    span ``parent_id`` must name a span record present in the stream —
    a connected tree, not dangling pointers.
    """
    n_spans = n_events = n_errors = 0
    rids: set[str] = set()
    span_ids: set[int] = set()
    parents: list[tuple[int, int]] = []  # (record index, parent_id)
    for i, rec in enumerate(events):
        if not isinstance(rec, dict):
            raise SchemaError(f"record {i}: not an object: {rec!r}")
        rtype = _require(rec, i, "type", str)
        _require(rec, i, "name", str)
        _require(rec, i, "attrs", dict)
        if rtype == "span":
            n_spans += 1
            rids.add(_require(rec, i, "rid", str))
            sid = _require(rec, i, "span_id", int)
            if isinstance(sid, bool):
                raise SchemaError(f"record {i}: span_id is bool: {rec!r}")
            span_ids.add(sid)
            pid = _require(rec, i, "parent_id", int, nullable=True)
            if pid is not None:
                parents.append((i, pid))
            _require(rec, i, "t_start", (int, float))
            dur = _require(rec, i, "dur_s", (int, float))
            if dur < 0:
                raise SchemaError(f"record {i}: negative dur_s {dur}: {rec!r}")
            if "device_s" in rec:
                dev = _require(rec, i, "device_s", (int, float))
                if isinstance(dev, bool) or dev < 0:
                    raise SchemaError(f"record {i}: device_s {dev!r} is not a non-negative number: {rec!r}")
            status = _require(rec, i, "status", str)
            if status not in ("ok", "error"):
                raise SchemaError(f"record {i}: status {status!r} not ok|error")
            if status == "error":
                n_errors += 1
                chain = _require(rec, i, "error", list)
                if not chain:
                    raise SchemaError(f"record {i}: error status with empty chain")
                for link in chain:
                    if not (isinstance(link, dict) and isinstance(link.get("type"), str)
                            and isinstance(link.get("message"), str)):
                        raise SchemaError(f"record {i}: malformed error link {link!r}")
            elif "error" in rec:
                raise SchemaError(f"record {i}: ok status carries error field")
        elif rtype == "event":
            n_events += 1
            rid = _require(rec, i, "rid", str, nullable=True)
            if rid is not None:
                rids.add(rid)
            _require(rec, i, "span_id", int, nullable=True)
            _require(rec, i, "t", (int, float))
            if _require(rec, i, "error", bool):
                n_errors += 1
        else:
            raise SchemaError(f"record {i}: unknown type {rtype!r}")
    for i, pid in parents:
        if pid not in span_ids:
            raise SchemaError(
                f"record {i}: parent_id {pid} names no span in the stream"
            )
    return {
        "spans": n_spans, "events": n_events,
        "errors": n_errors, "rids": sorted(rids),
    }


def read_jsonl(path) -> list[dict]:
    """Load an exported JSONL event file (skips blank lines)."""
    out: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_jsonl(path, events: list[dict]) -> None:
    """Write an in-memory event list as a JSONL export."""
    with open(path, "w") as f:
        for rec in events:
            f.write(json.dumps(rec) + "\n")
