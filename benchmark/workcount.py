"""The work a library call needs, counted from the model's inputs.

The count is the model's, not the implementation's: a galaxy at redshift
z needs the grid's λ columns that fall inside the bands' support once
shifted to its rest frame, L_row of them, and nothing else; padded
windows, padded rows and recomputed products are not counted. Per row:

    operations = 2·C·L_row   (SFZH × spectra, the first product)
               + 2·L_row·F   (the band integrals)

and per kernel launch, the bytes it must move at the least: the grid
columns its rows cover, read once (C·cols·4), the SFZH weights (B·C·4) and
the output (B·F·4). A launch's least time is the larger of operations at
the fp32 peak and bytes at the memory bandwidth (`PEAKS`).
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5 80GB data sheet: dense fp32 outside the tensor cores,
# HBM3 bandwidth (at the 700 W power limit)
PEAKS = {"fp32_flops": 67.0e12, "hbm_bytes_per_s": 3.35e12}


def band_support(filters) -> list:
    """Disjoint observed-frame intervals [lo, hi] (Å) where some band's
    transmission is above zero; `filters` is [(code, λ, T)]."""
    spans = []
    for _, lam, trans in filters:
        on = np.nonzero(np.asarray(trans) > 0.0)[0]
        if len(on):
            spans.append((float(lam[on[0]]), float(lam[on[-1]])))
    spans.sort()
    merged = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [tuple(s) for s in merged]


def _count(lam, lo, hi):
    """Number of grid wavelengths in [lo, hi], elementwise."""
    return np.maximum(np.searchsorted(lam, hi, side="right")
                      - np.searchsorted(lam, lo, side="left"), 0)


def columns_per_row(lam, support, z) -> np.ndarray:
    """L_row: grid columns inside the support in each row's rest frame."""
    lam = np.asarray(lam, np.float64)
    zp1 = 1.0 + np.asarray(z, np.float64)
    return sum(_count(lam, lo / zp1, hi / zp1) for lo, hi in support)


def columns_covered(lam, support, z) -> int:
    """Grid columns that some row of `z` needs (the union over rows)."""
    lam = np.asarray(lam, np.float64)
    z = np.asarray(z, np.float64)
    zp_lo, zp_hi = 1.0 + z.min(), 1.0 + z.max()
    spans = sorted((lo / zp_hi, hi / zp_lo) for lo, hi in support)
    merged = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return int(sum(_count(lam, lo, hi) for lo, hi in merged))


def launch_work(lam, support, z, n_cells: int, n_bands: int) -> dict:
    """Operations, bytes and least time of one launch over rows `z`."""
    cols = columns_per_row(lam, support, z).astype(np.float64)
    ops = float(np.sum(2.0 * n_cells * cols + 2.0 * cols * n_bands))
    b = len(z)
    nbytes = 4.0 * (n_cells * columns_covered(lam, support, z)
                    + b * n_cells + b * n_bands)
    return {"ops": ops, "bytes": nbytes,
            "least_s": max(ops / PEAKS["fp32_flops"],
                           nbytes / PEAKS["hbm_bytes_per_s"])}
