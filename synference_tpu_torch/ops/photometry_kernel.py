"""Knot-matrix photometry: tables and shift-space interpolation.

Counterpart of the non-Pallas parts of `synference_tpu/ops/photometry_kernel.py`
that the window engine uses:

    num(b, f; s) = Σ_l fw[b,l] · T_f(λ0·10^{(l+s)Δ})   is smooth in s,

so it is evaluated at integer-column knots s = k·δ by one matrix product
(B, L) @ (L, K·F8) and each galaxy's real shift is interpolated between its
knots (`_knot_interp`). The denominators Σ_l w_l T_f(...) are exact per
1/8-column shift (`build_den_table`) and are interpolated at the same knots,
so the filter-edge staircase cancels in num/den.

The JAX package's exact-shift Pallas numerators (`roll`, `bank`) and the
table-free `conv` engine are not ported yet (ROADMAP queue 2, M9).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "N_SUB",
    "KNOT_DELTA",
    "KNOT_INTERP_ORDER",
    "build_knot_matrix_device",
    "build_den_table",
]

N_SUB = 8  # sub-column shift resolution of the den table (1/8 column)
KNOT_DELTA = 8  # default knot spacing in λ columns
KNOT_INTERP_ORDER = 3  # monotone cubic across knots (1 = linear)


def _interp_f32(x, xp, fp):
    """`jnp.interp(x, xp, fp, left=0, right=0)` in float32 on tensors, with
    the same bracketing and the same arithmetic, so knot tables built here
    match the JAX package's to float32 rounding."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], 0.0, f)
    return torch.where(x > xp[-1], 0.0, f)


def build_knot_matrix_device(filter_set, lam_rest, dlog: float,
                             max_shift: int, n_wav: int, device,
                             delta: int = KNOT_DELTA, l_range=None):
    """(L, K·F8) knot table M[l, k·F8+f] = T_f(λ0·10^{(l + kδ)Δ}) on `device`.
    Returns (M, n_knots).

    `l_range=(l_lo, l_hi)` builds only those rows: rows outside the union
    filter support over every knot shift are identically zero, so trimming
    them is exact; callers slice their flux rows the same way."""
    f = len(filter_set)
    f8 = int(np.ceil(f / 8) * 8)
    n_knots = int(max_shift // delta) + 2  # cover s ∈ [0, max_shift]
    l_lo, l_hi = (0, n_wav) if l_range is None else l_range
    lam0 = torch.tensor(float(lam_rest[0]), dtype=torch.float32, device=device)
    dlog32 = torch.tensor(dlog, dtype=torch.float32, device=device)
    l_idx = torch.arange(l_lo, l_hi, dtype=torch.float32, device=device)
    out = torch.zeros(n_knots, f8, l_hi - l_lo, dtype=torch.float32,
                      device=device)
    for k in range(n_knots):
        lam_eval = lam0 * 10.0 ** ((l_idx + float(k * delta)) * dlog32)
        for i, filt in enumerate(filter_set.filters):
            xp = torch.as_tensor(np.asarray(filt.lam, np.float32), device=device)
            fp = torch.as_tensor(np.asarray(filt.transmission, np.float32),
                                 device=device)
            out[k, i] = _interp_f32(lam_eval, xp, fp)
    # (K, F8, L) -> (L, K·F8)
    return (out.permute(2, 0, 1).reshape(l_hi - l_lo, n_knots * f8)
            .contiguous(), n_knots)


def build_den_table(filter_set, lam_rest: np.ndarray, wlam: np.ndarray,
                    dlog: float, max_shift: int) -> np.ndarray:
    """(N_SUB·max_shift + N_SUB, F) exact denominators per 1/8-column shift:
    den[s4, f] = Σ_l w_l T_f(λ0·10^{(l + s4/8)Δ}). Host numpy in float64,
    identical to the JAX package's."""
    f = len(filter_set)
    n_wav = len(lam_rest)
    n_s4 = N_SUB * max_shift + N_SUB
    n_m = max_shift + 2  # integer part of the shift
    lam0 = float(lam_rest[0])
    den = np.zeros((n_s4, f), dtype=np.float32)
    w = np.asarray(wlam, dtype=np.float64)
    j_ext = np.arange(n_wav + n_m)
    for rs in range(N_SUB):
        lam_eval = lam0 * 10.0 ** ((j_ext + rs / N_SUB) * dlog)
        for fi, filt in enumerate(filter_set.filters):
            t_ext = np.interp(lam_eval, filt.lam, filt.transmission,
                              left=0.0, right=0.0)
            # den for shift m + rs/N_SUB = sliding dot of t_ext with w
            wins = np.lib.stride_tricks.sliding_window_view(t_ext, n_wav)
            vals = wins[: (n_s4 - rs) // N_SUB + 1] @ w
            den[rs::N_SUB, fi] = vals[: len(den[rs::N_SUB, fi])]
    return den


def _fb_slope(da, db):
    """Fritsch–Butland harmonic-mean slope in scale-normalized form:
    m·2·n_a·n_b/(n_a+n_b) with n = d/m, m = |da|+|db|. The product form
    da·db overflows float32 at L_ν-scale knot values (~1e30); normalized,
    every division operand is O(1). Zero where the differences change sign.
    """
    same = ((da > 0.0) & (db > 0.0)) | ((da < 0.0) & (db < 0.0))
    m = torch.abs(da) + torch.abs(db)
    sc = 1.0 / torch.clamp(m, min=1.0e-30)
    das, dbs = da * sc, db * sc
    ms = torch.abs(das) + torch.abs(dbs)
    ms_s = torch.where(same, ms, 1.0)
    na = torch.where(same, das / ms_s, 0.5)
    nb = torch.where(same, dbs / ms_s, 0.5)
    return torch.where(same, m * (2.0 * na * nb) / (na + nb), 0.0)


def _knot_interp(vals, s, n_knots: int, delta: int, order: int):
    """(B, K, F) knot samples, or a (K, F) table shared by the batch ->
    (B, F) at real column shifts s (B,).

    order=1: lerp between the bracketing knots. order=3: monotone cubic
    Hermite through 4 knots with Fritsch–Butland slopes; the end knots use
    linearly extrapolated virtual neighbours. The four knot rows are read
    by direct index. num AND den must use the same order and knots.
    """
    c = torch.clamp(s, 0.0, (n_knots - 1) * delta - 1.0e-3) / delta
    k = torch.floor(c).to(torch.int64)  # 0 .. n_knots-2
    t = (c - k.to(c.dtype))[:, None]

    def rows(kk):
        if vals.ndim == 2:
            return vals[kk]
        return torch.gather(
            vals, 1, kk[:, None, None].expand(-1, 1, vals.shape[2]))[:, 0]

    if order == 1:
        return rows(k) * (1.0 - t) + rows(k + 1) * t
    if order != 3:
        raise ValueError(f"knot interpolation order must be 1 or 3, not {order}")
    vm1 = rows(torch.clamp(k - 1, min=0))
    v0, v1 = rows(k), rows(k + 1)
    v2 = rows(torch.clamp(k + 2, max=n_knots - 1))
    vm1 = torch.where((k == 0)[:, None], 2.0 * v0 - v1, vm1)
    v2 = torch.where((k + 2 > n_knots - 1)[:, None], 2.0 * v1 - v0, v2)
    d0, d1, d2 = v0 - vm1, v1 - v0, v2 - v1
    m0, m1 = _fb_slope(d0, d1), _fb_slope(d1, d2)
    t2 = t * t
    t3 = t2 * t
    h00 = 2.0 * t3 - 3.0 * t2 + 1.0
    h10 = t3 - 2.0 * t2 + t
    h01 = -2.0 * t3 + 3.0 * t2
    h11 = t3 - t2
    return h00 * v0 + h10 * m0 + h01 * v1 + h11 * m1
