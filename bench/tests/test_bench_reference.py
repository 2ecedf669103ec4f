"""The plain references against float64 and the program at tiny sizes, and
the TF32 control against the cells' limits."""
import math

import pytest
import torch

from bench.harness.runner import run_cell
from bench.reference import pairwise as P
from bench.reference.precision import mm, tf32_round
from bench.tests.tiny import SIZES, tiny_cell


def _cloud(seed, n, d, shift=0.0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, d), generator=g) + shift


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-12, 1.0 + 3 * 2**-12, -3.14159265])
    r = tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0  # a tie rounds to even
    assert r[3] == 1.0 + 2**-10
    assert abs(float(r[4]) + 3.14159265) <= 3.15 * 2**-11
    y = torch.randn(64, 64, dtype=torch.float64)
    err = (mm(y.float(), y.float(), "tf32").double() - y @ y).abs().max()
    assert 1e-5 < float(err) < 1e-1


def test_exact_reference_is_the_float64_hausdorff_distance():
    a, b = _cloud(1, 300, 24), _cloud(2, 250, 24, 0.1)
    d = torch.cdist(a.double(), b.double())
    want = max(float(d.min(1).values.max()), float(d.min(0).values.max()))
    assert P.hausdorff(a, b) == pytest.approx(want, rel=1e-12)
    ra, cb = P.min_sqdists(a, b, "float64")
    assert torch.allclose(ra, d.min(1).values ** 2) and torch.allclose(cb, d.min(0).values ** 2)


def test_prohd_reference_matches_the_program_and_its_guarantees():
    from repro_torch.hd import HDConfig, set_distance

    a, b = _cloud(3, 4000, 64), _cloud(4, 3500, 64, 0.1)
    want = P.prohd(a, b, 0.01)
    got = set_distance(a, b, method="prohd", config=HDConfig(alpha=0.01, inner="full"))
    assert want["value"] == pytest.approx(float(got.value), rel=1e-5)
    assert want["lower"] == pytest.approx(float(got.lower), rel=1e-5)
    h = P.hausdorff(a, b)
    assert want["value"] <= h + 1e-12 and want["lower"] <= h <= want["upper"]
    for n, n_sel in ((4000, want["n_sel_a"]), (3500, want["n_sel_b"]), (4000, int(got.stats["n_sel_a"]))):
        assert P.selection_floor(n, 0.01) <= n_sel <= P.selection_capacity(n, 8, 0.01)


def test_bounds_of_h_hold_it_between_them():
    a, b = _cloud(5, 900, 32), _cloud(6, 800, 32, 0.1)
    h = P.hausdorff(a, b)
    assert P.hausdorff_above(a, b, 800) == pytest.approx(h, rel=1e-12)
    above = P.hausdorff_above(a, b, 64)
    assert h < above < 2 * h
    assert P.prohd(a, b, 0.05)["value"] <= h


def test_selection_floor_and_capacity():
    assert P.selection_floor(1_048_576, 0.01) == 2 * 10_485
    assert P.selection_capacity(1_048_576, 16, 0.01) == 2 * 10_485 + 16 * 2 * 655 == 41_930
    assert P.selection_floor(3, 0.01) == 2 and P.selection_capacity(3, 16, 0.01) == 3


@pytest.mark.parametrize("name", sorted(SIZES))
def test_program_is_correct_at_a_tiny_size(name):
    out = run_cell(tiny_cell(name), 2**31 + 99, 0.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("name", sorted(SIZES))
def test_tf32_control_is_not_correct(name):
    """The control (the reference in TF32 in the program's place) fails at
    least one of the cell's limits."""
    from bench.harness import spec as S

    cell = tiny_cell(name)
    control = S.load_driver(cell.traffic["driver"]).Driver.control_program
    out = run_cell(cell, 2**31 + 7, 0.0, False, device="cpu", program=control)
    assert not out["correct"], out["checks"]
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())


def test_compared_numbers_read_each_fault():
    from bench.harness.drivers.pairwise import Driver

    drv = Driver({"d": 256, "offset": 0.1, "points_per_side": 1_048_576},
                 {"call": {"method": "prohd", "alpha": 0.01, "inner": "full"}}, 1, "cpu",
                 program=lambda d: None)
    want = {"value": 5.0, "above": 7.0}
    got = {"value": 5.0, "lower": 1.7, "upper": 12.0, "n_sel_a": 40_000, "n_sel_b": 41_930}
    assert [drv._number(n, got, want) for n in ("value_rel_err", "bracket_miss", "n_sel_out")] == [0.0, 0.0, 0.0]
    assert drv._number("value_rel_err", dict(got, value=5.001), want) == pytest.approx(2e-4)
    assert drv._number("bracket_miss", dict(got, lower=5.5), want) == pytest.approx(0.1)
    assert drv._number("bracket_miss", dict(got, upper=6.5), want) == pytest.approx(0.1)
    assert drv._number("n_sel_out", dict(got, n_sel_b=41_931), want) == 1.0
    assert drv._number("n_sel_out", dict(got, n_sel_a=20_969), want) == 1.0
    assert drv._number("value_rel_err", dict(got, upper=math.nan), want) == math.inf
    assert drv._number("n_sel_out", None, want) == math.inf
