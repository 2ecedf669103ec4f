"""The readers of the program's spans on canned traces: each reads a value
from spans with ``device_s`` (or from the ``hd.set_distance`` ranges), and
nothing where the spans, their ``device_s`` or the device's operations
are missing."""
import copy

import pytest

from bench.harness import spec as S
from bench.harness.profiling import TraceView

MS = 1_000_000  # ns
PHASES = {"directions_pct": "hd.prohd.directions", "extremes_pct": "hd.prohd.extremes",
          "certificate_pct": "hd.prohd.certificate"}


def read(name, view):
    return S.load_reader("metrics", name).read(view)


def span(name, device_s=None, **attrs):
    rec = {"type": "span", "name": name, "attrs": attrs}
    if device_s is not None:
        rec["device_s"] = device_s
    return rec


def prohd_view():
    """Two 1-second ProHD calls.  In each, the program's call spans 10-990
    ms, its phases take 20, 10 and 5 ms of device time, and its two scans
    hand kernel 1 100 and 50 rows of 8 coordinates against 1,000 columns;
    the benchmark counts 90 and 45 useful rows.  The device idles 10-40 ms
    inside the program's range and 990-1000 ms outside it."""
    host, dev, spans = [], [], []
    for k in range(2):
        t = k * 1000 * MS
        host += [("bench.call", t, t + 1000 * MS), ("hd.set_distance", t + 10 * MS, t + 990 * MS)]
        dev += [("elementwise", t, t + 10 * MS), ("fused_minscan", t + 40 * MS, t + 990 * MS)]
        spans += [span("hd.prohd.directions", 0.020, m=2, pca_method="gram"),
                  span("hd.prohd.extremes", 0.010, cap_a=100, cap_b=50),
                  span("hd.scan", 0.5, rows=100, cols=1000, d=8, directed=True, pruned=False),
                  span("hd.scan", 0.4, rows=50, cols=1000, d=8, directed=True, pruned=False),
                  span("hd.prohd.certificate", 0.005, m=2),
                  span("hd.set_distance", 0.98, variant="hausdorff", method="prohd")]
        spans.append({"type": "event", "name": "cascade.fault", "attrs": {}})
    useful = 2.0 * 8 * (90 + 45) * 1000
    return TraceView(device_ops=dev, host_ops=host, records=[{}, {}], spans=spans,
                     flops=[useful, useful], peak_flops=67e12)


@pytest.mark.parametrize("name,share", [("directions_pct", 2.0), ("extremes_pct", 1.0),
                                        ("certificate_pct", 0.5)])
def test_phase_shares(name, share):
    v = prohd_view()
    assert read(name, v) == pytest.approx(share)
    v.spans = [s for s in v.spans if s["name"] != PHASES[name]]
    assert read(name, v) is None
    v = prohd_view()
    del next(s for s in v.spans if s["name"] == PHASES[name])["device_s"]
    assert read(name, v) is None


def test_scan_useful_share():
    v = prohd_view()
    assert read("scan_useful_pct", v) == pytest.approx(100.0 * 135 / 150)
    exact = copy.deepcopy(v)
    exact.spans = [span("hd.scan", 1.0, rows=300, cols=200, d=8, directed=False, pruned=False)]
    exact.flops = [2.0 * 8 * 300 * 200]
    assert read("scan_useful_pct", exact) == pytest.approx(100.0)
    for s in v.spans:
        s.pop("device_s", None)
    assert read("scan_useful_pct", v) is None
    assert read("scan_useful_pct", TraceView(**{**vars(prohd_view()), "flops": [1.0, None]})) is None
    assert read("scan_useful_pct", TraceView(**{**vars(prohd_view()), "spans": []})) is None


def test_idle_in_program_counts_only_gaps_inside_set_distance():
    v = prohd_view()
    assert read("idle_pct.pair", v) == pytest.approx(100.0 * 80 / 2000)
    assert read("idle_in_program_pct", v) == pytest.approx(100.0 * 60 / 2000)
    v.host_ops = [op for op in v.host_ops if op[0] != "hd.set_distance"]
    assert read("idle_in_program_pct", v) is None
    v = prohd_view()
    v.device_ops = []
    assert read("idle_in_program_pct", v) is None
