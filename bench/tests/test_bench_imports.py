"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level name: ``repro_torch`` begins with ``repro``), and the plain
references import nothing of the program."""
import subprocess
import sys
from pathlib import Path

from bench.harness.runner import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]

EVERY_FILE = r"""
import importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1])
spec = importlib.util.spec_from_file_location("bench_run_entry", root / "bench/run.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from bench.harness import spec as S
for w in S.read_benchmark()["workloads"]:
    cell = S.load_cell(w["name"])
    drv = S.load_driver(cell.traffic["driver"])
    for m in cell.end_to_end:
        S.load_reader("end_to_end", m["name"])
    for m in cell.per_layer:
        S.load_reader("metrics", m["name"])
for kind in ("end_to_end", "metrics"):
    for f in sorted((root / "bench" / kind).glob("*.py")):
        S.load_reader(kind, f.stem)
for f in sorted((root / "bench/harness/drivers").glob("[a-z]*.py")):
    S.load_driver(f.stem)
import bench.harness.runner, bench.harness.faults, bench.harness.profiling
import repro_torch.hd, repro_torch.obs.trace
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path[:0] = [sys.argv[1]]
import bench.reference.pairwise, bench.reference.precision
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str, home) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env={"PATH": "/usr/bin:/bin", "HOME": str(home)})
    assert out.returncode == 0, out.stderr
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_and_no_jax_package_in_a_run(tmp_path):
    mods = _modules(EVERY_FILE, tmp_path)
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert "repro_torch" in mods and "bench.harness.drivers.pairwise" in mods


def test_references_load_nothing_of_the_program(tmp_path):
    mods = _modules(REFERENCE_ONLY, tmp_path)
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN + ("repro_torch",)]
    assert "bench.reference.pairwise" in mods
