"""``examples/torch_train_lm.py`` (the port of ``examples/train_lm.py``) runs
on the CPU for a few steps: the demo LM trains through ``fit`` with async
checkpoints, an injected failure after the first checkpoint and the resume
from it, and the ProHD drift hook reports a certified lower bound."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent


def test_train_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(REPO / "examples" / "torch_train_lm.py"), "--device", "cpu",
                           "--steps", "5", "--ckpt-every", "2", "--drift-every", "2", "--d-model", "64"],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "on cpu" in out and "a failure is injected at step 3" in out
    # every step logged once, the failed one after the resume
    assert [int(s) for s in re.findall(r"^step +(\d+):", out, re.M)] == list(range(5))
    drifts = re.findall(r"\[drift@(\d+)\] ProHD\(hidden_t, hidden_0\) = ([\d.]+) certified ≥ ([\d.]+)", out)
    assert [int(d[0]) for d in drifts] == [2, 4]
    assert all(float(lo) <= float(v) for _, v, lo in drifts)
    assert "final loss:" in out
