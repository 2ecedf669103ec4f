"""A whole run on the CPU with the timed path broken underneath: the check
sees each fault, and a sound run passes."""
import pytest

from bench.harness.faults import FAULTS
from bench.harness.runner import run_cell
from bench.tests.tiny import SIZES, tiny_cell


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SIZES))
def test_fault_makes_the_run_not_correct(name, fault):
    out = run_cell(tiny_cell(name), 2**31 + 5, 0.0, False, device="cpu", program=FAULTS[fault])
    assert out["correct"] is False, (name, fault, out["checks"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", sorted(SIZES))
def test_traced_run_reads_its_metrics_and_checks_every_step(name):
    out = run_cell(tiny_cell(name), 2**31 + 3, 0.0, True, device="cpu", peak_flops=1e12)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["metrics"]  # the CPU has no device trace, but the calls' share of the peak reads
