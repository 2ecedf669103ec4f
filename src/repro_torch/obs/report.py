"""Render captured spans: per-stage latency breakdown + span trees.

The port's own copy of ``repro/obs/report.py``: the same strings from the
same event list.  ``stage_table(events)`` aggregates span records by name
into a markdown table; ``tree(events)`` renders each rid's span forest
with durations, the quickest way to see a request's lifecycle (admission →
flush → cascade stages → refinement).

CLI: ``python -m repro_torch.obs.report trace.jsonl`` prints both from a
JSONL export.
"""
from __future__ import annotations

__all__ = ["stage_table", "tree", "main"]


def _fmt_s(s: float) -> str:
    if s >= 1.0:
        return f"{s:.3f} s"
    if s >= 1e-3:
        return f"{s * 1e3:.3f} ms"
    return f"{s * 1e6:.1f} µs"


def stage_table(events: list[dict]) -> str:
    """Markdown per-span-name latency breakdown (count, total, mean,
    min/max, errors), sorted by total time descending — the stage that
    dominates the request is the first row."""
    agg: dict[str, dict] = {}
    for rec in events:
        if rec.get("type") != "span":
            continue
        a = agg.setdefault(rec["name"], {
            "count": 0, "total": 0.0, "min": float("inf"),
            "max": 0.0, "errors": 0,
        })
        d = float(rec["dur_s"])
        a["count"] += 1
        a["total"] += d
        a["min"] = min(a["min"], d)
        a["max"] = max(a["max"], d)
        if rec.get("status") == "error":
            a["errors"] += 1
    if not agg:
        return "(no spans captured)"
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["total"])
    lines = [
        "| span | count | total | mean | min | max | errors |",
        "| --- | ---: | ---: | ---: | ---: | ---: | ---: |",
    ]
    for name, a in rows:
        lines.append(
            f"| {name} | {a['count']} | {_fmt_s(a['total'])} "
            f"| {_fmt_s(a['total'] / a['count'])} | {_fmt_s(a['min'])} "
            f"| {_fmt_s(a['max'])} | {a['errors']} |"
        )
    return "\n".join(lines)


def tree(events: list[dict], rid: str | None = None) -> str:
    """Indented span forest per rid (point events inlined under their
    span).  Pass ``rid`` to render a single request."""
    spans = [r for r in events if r.get("type") == "span"]
    points = [r for r in events if r.get("type") == "event"]
    if rid is not None:
        spans = [r for r in spans if r["rid"] == rid]
        points = [r for r in points if r.get("rid") == rid]
    by_parent: dict[int | None, list[dict]] = {}
    for rec in spans:
        by_parent.setdefault(rec["parent_id"], []).append(rec)
    present = {r["span_id"] for r in spans}
    points_by_span: dict[int | None, list[dict]] = {}
    for rec in points:
        points_by_span.setdefault(rec.get("span_id"), []).append(rec)

    lines: list[str] = []

    def walk(rec: dict, depth: int) -> None:
        pad = "  " * depth
        mark = " !" if rec["status"] == "error" else ""
        lines.append(
            f"{pad}{rec['name']}  [{_fmt_s(rec['dur_s'])}]"
            f"  rid={rec['rid']} id={rec['span_id']}{mark}"
        )
        for p in points_by_span.get(rec["span_id"], ()):
            emark = " !" if p.get("error") else ""
            lines.append(f"{pad}  · {p['name']}{emark} {p.get('attrs') or ''}")
        for child in sorted(by_parent.get(rec["span_id"], ()), key=lambda r: r["t_start"]):
            walk(child, depth + 1)

    # roots: parentless spans plus spans whose parent isn't in this slice
    roots = [r for r in spans if r["parent_id"] is None or r["parent_id"] not in present]
    for root in sorted(roots, key=lambda r: (r["rid"], r["t_start"])):
        walk(root, 0)
    orphans = points_by_span.get(None, ())
    for p in orphans:
        emark = " !" if p.get("error") else ""
        lines.append(f"· {p['name']}{emark} {p.get('attrs') or ''}")
    return "\n".join(lines) if lines else "(no spans captured)"


def main(argv: list[str] | None = None) -> int:
    import argparse

    from repro_torch.obs.export import read_jsonl, validate_events

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a repro_torch.obs JSONL trace export.",
    )
    parser.add_argument("path", help="JSONL event file (from obs.enable(jsonl=...))")
    parser.add_argument("--rid", default=None, help="render only this request id")
    parser.add_argument("--no-tree", action="store_true", help="table only")
    args = parser.parse_args(argv)

    events = read_jsonl(args.path)
    summary = validate_events(events)
    print(
        f"{summary['spans']} spans, {summary['events']} events, "
        f"{summary['errors']} errors, {len(summary['rids'])} rids\n"
    )
    print(stage_table(events))
    if not args.no_tree:
        print()
        print(tree(events, rid=args.rid))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
