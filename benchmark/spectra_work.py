"""The work a spectroscopic library call needs, counted from the model's
inputs, as `workcount.py` counts a photometry call.

Per row, at its redshift:

    operations = 2·2·C·L     (the two full-grid contractions, SFZH ×
                              incident and SFZH × total spectra)
               + 2·T·L       (the LSF: T taps on each of the L columns)
               + 2·L_row·F   (the band integrals over the columns their
                              support needs, `workcount.columns_per_row`)

Pad rows are not counted, nor the slab passes (dust, IGM, distance) and
the resampling, which move bytes and need no more than a few operations a
column. The contractions' least time is their operations at the fp32
peak: a batch of B rows reads the grid (C·L·4 bytes) once and writes
2·B·L·4, which at the memory bandwidth takes a nineteenth of it.
"""

from __future__ import annotations

import numpy as np

from benchmark.workcount import PEAKS, band_support, columns_per_row


def contraction_ops(n_rows: int, n_cells: int, n_wav: int) -> float:
    """Operations of the two full-grid contractions of `n_rows` rows."""
    return 4.0 * n_cells * n_wav * n_rows


def call_work(lam, filters, z, n_cells: int, n_taps: int) -> dict:
    """Operations and the contractions' least time of one call's real
    rows at redshifts `z`; `filters` is [(code, λ, T)]."""
    n_wav = len(lam)
    cols = columns_per_row(lam, band_support(filters), z)
    contract = contraction_ops(len(z), n_cells, n_wav)
    ops = (contract + 2.0 * n_taps * n_wav * len(z)
           + float(np.sum(2.0 * cols * len(filters))))
    return {"ops": ops, "contract_least_s": contract / PEAKS["fp32_flops"]}


def window_work(lam, filters, zs, n_cells: int, n_taps: int) -> dict:
    """`call_work` summed over the window's calls (`zs`, one array of
    redshifts a call)."""
    out = {"ops": 0.0, "contract_least_s": 0.0}
    for z in zs:
        for k, v in call_work(lam, filters, z, n_cells, n_taps).items():
            out[k] += v
    return out
