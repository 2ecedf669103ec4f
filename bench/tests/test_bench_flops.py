"""FLOP counts against hand-worked shapes."""
import pytest

from bench.harness.flops import fp32_peak, pair_flops


def test_exact_counts_every_pair_once():
    # 262,144^2 pairs x 2 x 256: 3.52e13 (one bidirectional scan)
    assert pair_flops("exact", 256, 262_144, 262_144) == 2 * 256 * 262_144**2 == pytest.approx(3.518e13, rel=1e-3)


def test_prohd_counts_the_two_directed_sweeps():
    # 41,930 selected rows a side against 1,048,576: 4.50e13
    n = 1_048_576
    assert pair_flops("prohd", 256, n, n, 41_930, 41_930) == 2 * 256 * 2 * 41_930 * n
    assert pair_flops("prohd", 256, n, n, 41_930, 41_930) == pytest.approx(4.501e13, rel=1e-3)
    assert pair_flops("prohd", 4, 10, 20, 3, 5) == 2 * 4 * (3 * 20 + 5 * 10)


def test_peaks_and_unknown_methods():
    assert fp32_peak("NVIDIA H100 80GB HBM3") == 67e12
    assert fp32_peak("cpu") is None
    with pytest.raises(ValueError):
        pair_flops("sampling", 4, 1, 1)
