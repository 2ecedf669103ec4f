"""Find a cell's pieces by the names that ``BENCHMARK.json`` gives.

A workload names a configuration and a traffic mix; each is a JSON file of
its own (``configs/<config>.json``, ``traffic/<traffic>.json``), the mix's
``driver`` names the general loop that reads it (``harness/drivers``), and
each metric is a small reader in a file named after it
(``end_to_end/<name>.py``, ``metrics/<name>.py``).  A new cell, mix,
configuration or metric is therefore new files and new entries, never an
edit of a file that is here.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell", "load_reader", "load_driver", "read_benchmark"]


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]   # the cell's end-to-end metrics (BENCHMARK.json entries)
    per_layer: list[dict]    # the cell's per-layer metrics


def read_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration, traffic and metrics."""
    bench = read_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer)


def _load_file(path: Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The reader module of metric ``name``: ``<kind>/<name>.py`` with a
    ``read(view)`` function (``kind`` is ``end_to_end`` or ``metrics``)."""
    path = root / "bench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    return _load_file(path, f"bench_{kind}_{name.replace('.', '_')}")


def load_driver(name: str) -> ModuleType:
    """The general loop ``harness/drivers/<name>.py`` that a traffic mix names."""
    return importlib.import_module(f"bench.harness.drivers.{name}")
