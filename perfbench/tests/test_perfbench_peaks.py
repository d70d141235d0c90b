"""The operation and byte counts of the MVM against hand counts, and the
roofline bound."""
import pytest

from perfbench.peaks import (PEAK_BYTES_PER_S, PEAK_FLOPS, least_seconds,
                             mvm_bytes, mvm_flops)


def test_mvm_flops_by_hand():
    # U (n, m) @ K2 (m, m): n*m*m multiply-adds; K1 (n, n) @ T: n*n*m.
    n, m = 3, 2
    assert mvm_flops(n, m, 1) == 2 * (3 * 2 * 2 + 3 * 3 * 2)
    assert mvm_flops(4096, 52, 65) == pytest.approx(1.1496e11, rel=1e-3)


def test_mvm_bytes_by_hand():
    n, m = 3, 2
    # one sweep of 5 columns: K1 9, K2 4, mask 6 floats; 5 columns in and out
    assert mvm_bytes(n, m, 1, 5) == 4 * (9 + 4 + 6) + 2 * 4 * 5 * 6


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(495e12, 0.0) == pytest.approx(1.0)
    assert least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert PEAK_FLOPS["tf32"] == 495e12 and PEAK_BYTES_PER_S == 3.35e12
