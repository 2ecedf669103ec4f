"""The command line: no card, no result."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the check is for one without")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "rc256.exact_256k", "--seed",
                          str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_unknown_workload_is_refused():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "no.such", "--seed", "1",
                          "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
