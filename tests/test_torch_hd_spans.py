"""The pairwise path's spans (``hd.*``) and the tracer's device time.

``set_distance`` exact and ProHD each emit one span tree under one rid:
``hd.set_distance`` over ``hd.validate``, ProHD's three selection phases
and one ``hd.scan`` per kernel-1 scan, whose attributes are plain values
the host already has.  On the CPU no span carries ``device_s``; with
tracing off nothing is emitted; under ``torch.profiler`` each span's
``t_start`` agrees with its ``record_function`` range's start.  The
tracer's handling of device time (resolution when records are read, JSONL
lines held back in emit order) runs here on stand-in events; the case on
real CUDA events is marked ``cuda``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import selection  # noqa: E402
from repro_torch.hd import HDConfig, set_distance  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

N_A, N_B, D, ALPHA = 200, 180, 8, 0.05
M = 2  # floor(sqrt(D))
PHASES = ("hd.prohd.directions", "hd.prohd.extremes", "hd.scan", "hd.scan", "hd.prohd.certificate")


def _clouds(device="cpu"):
    g = torch.Generator().manual_seed(3)
    a = torch.rand(N_A, D, generator=g)
    b = torch.rand(N_B, D, generator=g) + 0.1
    return a.to(device), b.to(device)


def _call(method, a, b):
    cfg = HDConfig(alpha=ALPHA) if method == "prohd" else None
    return set_distance(a, b, method=method, backend="fused_cuda", config=cfg)


def _spans(records):
    return [r for r in records if r["type"] == "span"]


@pytest.mark.parametrize("method", ["exact", "prohd"])
def test_set_distance_emits_the_span_tree(method):
    a, b = _clouds()
    with obs.capture() as get_events:
        _call(method, a, b)
        spans = _spans(get_events())
    root = spans[-1]
    assert root["name"] == "hd.set_distance" and root["parent_id"] is None
    assert root["attrs"] == {"variant": "hausdorff", "method": method, "backend": "fused_cuda",
                             "n_a": N_A, "n_b": N_B, "d": D}
    children = [s for s in spans if s is not root]
    assert all(s["parent_id"] == root["span_id"] and s["rid"] == root["rid"] for s in children)
    names = tuple(s["name"] for s in children)
    scans = [s["attrs"] for s in children if s["name"] == "hd.scan"]
    if method == "exact":
        assert names == ("hd.validate", "hd.scan")
        assert scans == [{"rows": N_A, "cols": N_B, "d": D, "directed": False, "pruned": False}]
    else:
        assert names == ("hd.validate", *PHASES)
        cap_a = selection.selection_capacity(N_A, M, ALPHA)
        cap_b = selection.selection_capacity(N_B, M, ALPHA)
        assert scans == [{"rows": cap_a, "cols": N_B, "d": D, "directed": True, "pruned": False},
                         {"rows": cap_b, "cols": N_A, "d": D, "directed": True, "pruned": False}]
        by_name = {s["name"]: s["attrs"] for s in children}
        assert by_name["hd.prohd.directions"] == {"m": M, "pca_method": "gram"}
        assert by_name["hd.prohd.extremes"] == {"cap_a": cap_a, "cap_b": cap_b}
        assert by_name["hd.prohd.certificate"] == {"m": M}
    for s in spans:
        assert all(type(v) in (int, float, str, bool) for v in s["attrs"].values()), s
        assert "device_s" not in s


def test_nothing_is_emitted_with_tracing_off():
    a, b = _clouds()
    obs.drain()
    for method in ("exact", "prohd"):
        _call(method, a, b)
    assert not obs.enabled() and obs.drain() == []
    assert trace.span("hd.scan", device=a.device) is trace._NOOP


def test_spans_share_the_profiler_clock():
    a, b = _clouds()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof, obs.capture(record_function=True) as get_events:
        _call("exact", a, b)
        _call("prohd", a, b)
        spans = _spans(get_events())
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("hd."):
            ranges.setdefault(e.name(), []).append(e.start_ns() * 1e-9)
    for name in {s["name"] for s in spans}:
        starts = sorted(s["t_start"] for s in spans if s["name"] == name)
        assert len(ranges[name]) == len(starts), name
        for t_span, t_range in zip(starts, sorted(ranges[name])):
            assert abs(t_range - t_span) < 1e-3, (name, t_range - t_span)


class _StandInEvent:
    """A CUDA timing event's surface, on a host clock set by the test."""

    def __init__(self, at_ms):
        self.at_ms, self.reached = at_ms, False

    def query(self):
        return self.reached

    def synchronize(self):
        self.reached = True

    def elapsed_time(self, end):
        assert self.reached and end.reached
        return end.at_ms - self.at_ms


def test_device_time_resolves_on_read_and_holds_jsonl_lines_in_order(monkeypatch, tmp_path):
    from repro.obs import export as ref_export

    clock = iter([10.0, 12.5, 20.0, 20.25])
    monkeypatch.setattr(trace, "_device_stream", lambda device: "stream")
    monkeypatch.setattr(trace, "_timing_event", lambda stream: _StandInEvent(next(clock)))
    path = tmp_path / "trace.jsonl"
    with obs.capture(jsonl=str(path)) as get_events:
        with trace.span("hd.set_distance", device="stand-in"):
            pass
        with trace.span("hd.scan", device="stand-in"):
            pass
        trace.event("after")
        assert path.read_text() == ""  # no line passes a span whose device_s is due
        records = get_events()
        assert [r.get("device_s") for r in records] == [2.5e-3, 0.25e-3, None]
    exported = obs.read_jsonl(path)
    assert exported == records
    assert obs.validate_events(exported) == ref_export.validate_events(exported)
    bad = [dict(exported[0], device_s=-1.0)]
    with pytest.raises(obs.SchemaError, match="device_s"):
        obs.validate_events(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["exact", "prohd"])
def test_device_time_nests_on_the_card(method):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device_s comes from CUDA events")
    a, b = _clouds("cuda")
    _call(method, a, b)  # the kernel's build and first launch stay out of the trace
    with obs.capture() as get_events:
        _call(method, a, b)
        spans = _spans(get_events())
    root = spans[-1]
    assert root["name"] == "hd.set_distance" and root["device_s"] > 0
    for s in spans[:-1]:
        assert 0 < s["device_s"] <= root["device_s"], s
    assert obs.validate_events(spans)
