"""The port's JSONL export, its report and its profiler bridge, held to
the reference's ``repro.obs``.

Events captured from a port ``search`` (a small clustered corpus on the
CPU) pass both the port's and the reference's ``validate_events``; the
JSONL file round-trips; ``stage_table`` and ``tree`` give the reference's
strings on the same event list; malformed records fail both validators
with the same message; and under ``torch.profiler.profile`` on the CPU the
bridge (``capture(record_function=True)``, the reference's ``xla=True``)
emits one ``record_function`` range per span, by name.  Exact comparisons
throughout: the functions are pure Python over the same dicts.
"""
import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import export as ref_export  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.data.pointclouds import clustered_sets  # noqa: E402
from repro_torch.hd import search  # noqa: E402
from repro_torch.index import SetStore  # noqa: E402
from repro_torch.obs import export, report  # noqa: E402

D, K = 8, 3
STAGES = ("cascade.stage0", "cascade.stage1", "cascade.stage2a", "cascade.stage2b")


@pytest.fixture(scope="module")
def store():
    sets, _ = clustered_sets(0, 48, D, sizes=(10, 20, 30))
    s = SetStore(dim=D, device="cpu")
    s.add_many(sets)
    return s, sets


def _query(sets):
    rng = np.random.RandomState(1)
    return torch.from_numpy(sets[5].mean(axis=0) + rng.randn(16, D).astype(np.float32) * 0.5)


@pytest.fixture(scope="module")
def traced(store, tmp_path_factory):
    s, sets = store
    path = tmp_path_factory.mktemp("obs") / "trace.jsonl"
    with obs.capture(jsonl=str(path)) as get_events:
        search(_query(sets), s, K)
        events = get_events()
    return events, path


def test_search_export_passes_both_validators(traced):
    events, _ = traced
    mine = obs.validate_events(events)
    theirs = ref_export.validate_events(events)
    assert mine == theirs
    assert mine["spans"] > 0 and len(mine["rids"]) == 1 and mine["errors"] == 0
    names = {e["name"] for e in events if e["type"] == "span"}
    assert {"index.search", *STAGES} <= names


def test_jsonl_round_trip(traced, tmp_path):
    events, path = traced
    assert obs.read_jsonl(path) == events == ref_export.read_jsonl(path)
    again = tmp_path / "again.jsonl"
    obs.write_jsonl(again, events)
    assert again.read_text() == path.read_text()
    assert obs.OBS_SCHEMA_VERSION == ref_export.OBS_SCHEMA_VERSION


def test_report_strings_equal_the_reference(traced):
    events, _ = traced
    assert report.stage_table(events) == ref_report.stage_table(events)
    assert report.tree(events) == ref_report.tree(events)
    rid = events[0]["rid"]
    assert report.tree(events, rid=rid) == ref_report.tree(events, rid=rid)
    assert report.stage_table([]) == ref_report.stage_table([]) == "(no spans captured)"


def test_report_cli_prints_summary_table_and_tree(traced, capsys):
    events, path = traced
    assert report.main([str(path)]) == 0
    mine = capsys.readouterr().out
    assert ref_report.main([str(path)]) == 0
    assert mine == capsys.readouterr().out
    assert report.stage_table(events) in mine


def _break(events, how):
    ev = copy.deepcopy(events)
    span = next(e for e in ev if e["type"] == "span")
    if how == "missing_field":
        del span["dur_s"]
    elif how == "negative_duration":
        span["dur_s"] = -1.0
    elif how == "bad_status":
        span["status"] = "maybe"
    elif how == "dangling_parent":
        span["parent_id"] = 10 ** 9
    elif how == "unknown_type":
        span["type"] = "metric"
    elif how == "bool_span_id":
        span["span_id"] = True
    return ev


@pytest.mark.parametrize("how", ["missing_field", "negative_duration", "bad_status", "dangling_parent",
                                 "unknown_type", "bool_span_id"])
def test_malformed_records_fail_both_validators_alike(traced, how):
    bad = _break(traced[0], how)
    with pytest.raises(export.SchemaError) as mine:
        export.validate_events(bad)
    with pytest.raises(ref_export.SchemaError) as theirs:
        ref_export.validate_events(bad)
    assert str(mine.value) == str(theirs.value)


def test_profiler_bridge_emits_one_range_per_span(store):
    s, sets = store
    q = _query(sets)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with obs.capture(record_function=True) as get_events:
        with torch.profiler.profile(activities=acts) as prof:
            search(q, s, K)
        events = get_events()
    spans = [e["name"] for e in events if e["type"] == "span"]
    ranges = {}
    for e in prof.events():
        ranges[e.name] = ranges.get(e.name, 0) + 1
    for name in set(spans):
        assert ranges.get(name, 0) == spans.count(name), (name, ranges.get(name), spans.count(name))
    assert set(STAGES) <= set(ranges)


def test_bridge_is_off_unless_asked(store):
    s, sets = store
    with obs.capture() as get_events:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            search(_query(sets), s, K)
        spans = {e["name"] for e in get_events() if e["type"] == "span"}
    assert spans and not spans & {e.name for e in prof.events()}
    assert not obs.trace._STATE.record_function and not obs.enabled()


def test_exports_match_the_reference_package():
    import repro.obs as ref_obs

    assert set(obs.__all__) == set(ref_obs.__all__)
    json.dumps(obs.validate_events([]))  # the summary is JSON
