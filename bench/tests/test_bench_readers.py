"""Each per-layer and end-to-end reader on canned traces and windows."""
import pytest

from bench.harness import spec as S
from bench.harness.profiling import TraceView, breakdown, union_ns

MS = 1_000_000  # ns


def read(name, view, kind="metrics"):
    return S.load_reader(kind, name).read(view)


def pair_view(flops=(2.0e12, 2.0e12), peak=10e12):
    """Two 1-second calls: in each, kernel 1 runs 0.6 s, another op 0.1 s."""
    host = [("bench.call", 0, 1000 * MS), ("aten::topk", 20 * MS, 80 * MS),
            ("bench.call", 1100 * MS, 2100 * MS)]
    dev = [("void fused_minscan_kernel<false, true>(float const*)", 300 * MS, 900 * MS),
           ("at::native::topk_kernel", 100 * MS, 200 * MS),
           ("void fused_minscan_kernel<false, true>(float const*)", 1400 * MS, 2000 * MS),
           ("at::native::topk_kernel", 1200 * MS, 1300 * MS),
           ("uniform_", 1000 * MS, 1050 * MS)]
    return TraceView(device_ops=dev, host_ops=host, records=[{}, {}], spans=[], flops=list(flops), peak_flops=peak)


def test_union_clips_and_merges():
    assert union_ns([(0, 10), (5, 20), (30, 40)], 0, 100) == 30
    assert union_ns([(0, 10), (5, 20), (30, 40)], 8, 35) == 17
    assert union_ns([], 0, 1) == 0


def test_window_busy_and_idle():
    v = pair_view()
    assert v.window == (0, 2100 * MS) and v.window_s == pytest.approx(2.1)
    assert v.busy_s() == pytest.approx(1.45)
    assert read("idle_pct.pair", v) == pytest.approx(100 * (1 - 1.45 / 2.1))


def test_pair_metrics():
    v = pair_view()
    assert read("pair_mfu_pct", v) == pytest.approx(100 * 4e12 / (2.0 * 10e12))
    assert read("fused_minscan_roofline", v) == pytest.approx(100 * 4e12 / 10e12 / 1.2)
    assert read("select_pct", v) == pytest.approx(100 * (1 - 1.2 / 2.0))


def test_pair_metrics_read_nothing_without_flops_peak_or_kernel():
    assert read("pair_mfu_pct", pair_view(flops=(1e12, None))) is None
    assert read("fused_minscan_roofline", pair_view(peak=None)) is None
    v = pair_view()
    v.device_ops = [op for op in v.device_ops if "fused_minscan" not in op[0]]
    assert read("select_pct", v) is None and read("fused_minscan_roofline", v) is None
    v.device_ops = []
    assert read("idle_pct.pair", v) is None


def test_end_to_end_readers():
    calls = {"setup_s": 12.5, "start": 10.0, "end": 20.5,
             "records": [{"requests": 1, "failed": 0}] * 10 + [{"requests": 1, "failed": 1}]}
    assert read("pair_s", calls, "end_to_end") == pytest.approx(10.5 / 10)
    assert read("setup_s", calls, "end_to_end") == 12.5
    assert read("pair_s", dict(calls, records=[{"requests": 1, "failed": 1}]), "end_to_end") is None


def test_breakdown_names_ops_and_gaps():
    b = breakdown(pair_view())
    assert b["device_ops"][0][0].startswith("void fused_minscan_kernel")
    assert b["device_ops"][0][1] == pytest.approx(1.2)
    named = dict(b["idle_gaps"])
    assert named["bench.call > aten::topk"] == pytest.approx(0.1)
    assert named["bench.call"] == pytest.approx(0.55)
    assert sum(named.values()) == pytest.approx(2.1 - 1.45)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
