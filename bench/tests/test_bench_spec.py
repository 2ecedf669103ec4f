"""BENCHMARK.json against its contract, and the harness finding every
cell's files by name."""
import json
import re
import shutil

import pytest

from bench.harness import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = S.read_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_names_units_and_bounds():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        group = [e["name"] for e in BENCH[key]]
        assert len(group) == len(set(group)), key
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    layers = {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS), m
    assert "fused_minscan_roofline" in layers


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(name):
    cell = S.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert cell.chips == 1


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = S.load_cell(name)
    driver = S.load_driver(cell.traffic["driver"])
    assert hasattr(driver, "Driver")
    for m in cell.end_to_end:
        assert callable(S.load_reader("end_to_end", m["name"]).read)
    for m in cell.per_layer:
        assert callable(S.load_reader("metrics", m["name"]).read)
    assert "limits" in cell.traffic["check"]


def test_config_files_lie_under_paths_and_name_their_source():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench/configs/")
        body = json.loads((S.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert set(c["reduced"]) <= set(body), "a reduced key is a key of the file as run"
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_a_new_cell_is_found_from_added_files_alone(tmp_path):
    """A later PR adds a configuration, a mix and a metric as files and
    entries; the harness finds them without an edit."""
    shutil.copytree(S.BENCH_DIR, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "bench/configs/gmm_d256.json").write_text(json.dumps({"name": "gmm_d256", "points_per_side": 7}))
    (tmp_path / "bench/traffic/prohd_2m.json").write_text(json.dumps({"driver": "pairwise", "sample": 2}))
    (tmp_path / "bench/metrics/new_share.py").write_text("def read(view):\n    return 42.0\n")
    bench["configs"].append({"name": "gmm_d256", "source": "https://arxiv.org/pdf/2511.18207",
                             "file": "bench/configs/gmm_d256.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "gmm.prohd_2m", "config": "gmm_d256", "traffic": "prohd_2m",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_share", "unit": "%", "better": "higher", "source": "device_trace",
                               "layer": "front door", "moves": "pair_s", "workloads": ["gmm.prohd_2m"]})
    bench["end_to_end"][0]["workloads"].append("gmm.prohd_2m")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = S.load_cell("gmm.prohd_2m", root=tmp_path)
    assert cell.config["points_per_side"] == 7 and cell.traffic["sample"] == 2
    assert [m["name"] for m in cell.per_layer] == ["new_share"]
    assert {m["name"] for m in cell.end_to_end} == {"pair_s", "setup_s"}
    assert S.load_reader("metrics", "new_share", root=tmp_path).read(None) == 42.0
    with pytest.raises(KeyError):
        S.load_cell("no.such_cell", root=tmp_path)
