"""The work count against a count by hand at a tiny grid and two bands."""

import numpy as np

import _tiny  # noqa: F401
from benchmark import workcount


def _bands():
    # two bands with supports [1000, 1100] and [1050, 1300] Å (overlapping:
    # one merged interval) and a third far away, [2000, 2100]
    lam = np.array([900.0, 1000.0, 1100.0, 1200.0, 1300.0, 1400.0])
    t = np.array([0.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    b1 = ("a", lam, t)
    lam2 = np.array([1000.0, 1050.0, 1300.0, 1350.0])
    b2 = ("b", lam2, np.array([0.0, 0.5, 0.5, 0.0]))
    b3 = ("c", np.array([2000.0, 2100.0]), np.array([1.0, 1.0]))
    return [b1, b2, b3]


def test_band_support_merges_overlaps():
    assert workcount.band_support(_bands()) == [(1000.0, 1300.0),
                                                (2000.0, 2100.0)]


def test_columns_and_operations_by_hand():
    grid = np.arange(400.0, 2200.0, 50.0)  # 400, 450, ..., 2150 Å
    support = workcount.band_support(_bands()[:2])  # [(1000, 1300)]
    # z = 0: columns 1000..1300 -> 7; z = 1: rest 500..650 -> 4
    cols = workcount.columns_per_row(grid, support, [0.0, 1.0])
    assert cols.tolist() == [7, 4]
    # both rows together cover rest 500..1300: 17 columns
    assert workcount.columns_covered(grid, support, [0.0, 1.0]) == 17
    c, f = 3, 2
    w = workcount.launch_work(grid, support, np.array([0.0, 1.0]), c, f)
    assert w["ops"] == 2 * c * 11 + 2 * 11 * f
    assert w["bytes"] == 4 * (c * 17 + 2 * c + 2 * f)
    assert w["least_s"] == max(w["ops"] / 67e12, w["bytes"] / 3.35e12)
