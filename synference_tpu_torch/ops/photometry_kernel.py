"""Knot-matrix photometry: tables and shift-space interpolation.

Counterpart of the non-Pallas parts of `synference_tpu/ops/photometry_kernel.py`
that the window engine uses:

    num(b, f; s) = Σ_l fw[b,l] · T_f(λ0·10^{(l+s)Δ})   is smooth in s,

so it is evaluated at integer-column knots s = k·δ by one matrix product
(B, L) @ (L, K·F8) and each galaxy's real shift is interpolated between its
knots (`_knot_interp`). The denominators Σ_l w_l T_f(...) are exact per
1/8-column shift (`build_den_table`) and are interpolated at the same knots,
so the filter-edge staircase cancels in num/den.

The exact route (`roll`/`bank`) snaps each shift to 1/8 column, s4 = 8m + rs
(`shift_decompose`), and sums the flux row against the sub-column table row
rs read at offset m (`build_subshift_table`): K3, `shift_photometry_num`
(`csrc/shift_num.cu`), one kernel for both variant names. It visits the rows
in shift order (`shift_row_order`) and reads the table from its
band-adjacent copy (`band_adjacent_table`).

The table-free `conv` engine (`conv_photometry_num`) computes the same knot
numerators without a stored knot matrix: row k of the matrix IS the
extended filter table read at offset k·δ, M[l, k, f] = G[f, l + kδ], so each
chunk of knots is gathered from G, multiplied and released. With per-filter
support columns it takes the windowed form (`_conv_num_windowed`), where
each group of filters reads only the λ window that can reach it. It is
plain PyTorch: a strided correlation, not a TPU kernel.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ._cuda import refuse_autodiff

__all__ = [
    "N_SUB",
    "KNOT_DELTA",
    "KNOT_INTERP_ORDER",
    "build_knot_matrix_device",
    "conv_photometry_num",
    "build_den_table",
    "build_subshift_table",
    "shift_decompose",
    "shift_row_order",
    "shift_row_keys_reference",
    "band_adjacent_table",
    "band_adjacent_table_inverse",
    "shift_photometry_num",
    "shift_photometry_num_reference",
    "shift_photometry_num_ordered_reference",
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
    # every knot's shifted grid at once: (K, L), the same float32 arithmetic
    # per element as one knot at a time
    shifts = torch.arange(n_knots, dtype=torch.float32, device=device) * delta
    lam_eval = (lam0 * 10.0 ** ((l_idx[None, :] + shifts[:, None])
                                * dlog32)).reshape(-1)
    for i, filt in enumerate(filter_set.filters):
        xp = torch.as_tensor(np.asarray(filt.lam, np.float32), device=device)
        fp = torch.as_tensor(np.asarray(filt.transmission, np.float32),
                             device=device)
        out[:, i] = _interp_f32(lam_eval, xp, fp).reshape(n_knots, -1)
    # (K, F8, L) -> (L, K·F8)
    return (out.permute(2, 0, 1).reshape(l_hi - l_lo, n_knots * f8)
            .contiguous(), n_knots)


def build_subshift_table(filter_set, lam_rest, dlog: float, max_shift: int,
                         n_wav: int, device):
    """(N_SUB, F8, n_wav + max_shift) table on `device`:
    table[rs, f, j] = T_f(λ0·10^{(j + rs/8)Δ}), in float32 with the
    arithmetic of the JAX package's `build_subshift_table_device`. It covers
    j = l + m for every l < n_wav and integer shift m < max_shift; there is
    no 128-lane padding (an arbitrary-offset load has no alignment rule on
    the card)."""
    f8 = int(np.ceil(len(filter_set) / 8) * 8)
    n_cols = n_wav + max_shift
    lam0 = torch.tensor(float(lam_rest[0]), dtype=torch.float32, device=device)
    dlog32 = torch.tensor(dlog, dtype=torch.float32, device=device)
    j = torch.arange(n_cols, dtype=torch.float32, device=device)
    out = torch.zeros(N_SUB, f8, n_cols, dtype=torch.float32, device=device)
    for rs in range(N_SUB):
        lam_eval = lam0 * 10.0 ** ((j + rs / N_SUB) * dlog32)
        for i, filt in enumerate(filter_set.filters):
            xp = torch.as_tensor(np.asarray(filt.lam, np.float32), device=device)
            fp = torch.as_tensor(np.asarray(filt.transmission, np.float32),
                                 device=device)
            out[rs, i] = _interp_f32(lam_eval, xp, fp)
    return out


def shift_decompose(s, max_shift: int):
    """Real column shifts -> snapped 1/8-column indices s4 (int32), clipped
    to [0, N_SUB·max_shift − 1]: m = s4 // N_SUB is the integer shift, rs =
    s4 % N_SUB the table row."""
    # clip before the cast: a float beyond int32 has no defined conversion
    return torch.clamp(torch.round(s * N_SUB), 0,
                       N_SUB * max_shift - 1).to(torch.int32)


def _shift_parts(s4, n_l: int, n_cols: int):
    """(m, rs) of snapped shifts, with m clipped to the table's reach."""
    s4 = torch.clamp(s4.long(), min=0)
    return torch.clamp(s4 // N_SUB, max=n_cols - n_l), s4 % N_SUB


def shift_photometry_num_reference(fw, table, s4, rows: int = 1024):
    """Plain PyTorch K3 (same arguments as `shift_photometry_num`), `rows`
    galaxies at a time to bound the (rows, F8, L) table gather."""
    b, n_l = fw.shape
    _, f8, n_cols = table.shape
    m, rs = _shift_parts(s4, n_l, n_cols)
    cols = torch.arange(n_l, device=fw.device)
    out = torch.empty(b, f8, dtype=torch.float32, device=fw.device)
    for i in range(0, b, rows):
        r = slice(i, i + rows)
        idx = (m[r, None] + cols)[:, None, :].expand(-1, f8, -1)
        t = torch.gather(table[rs[r]], 2, idx)  # (rows, F8, L)
        out[r] = (t * fw[r, None, :]).sum(dim=2)
    return out


def shift_row_keys_reference(s4, n_m: int):
    """Plain PyTorch row keys (same arguments as `_shift_row_keys`)."""
    s = torch.clamp(s4.to(torch.int32), min=0)
    key = torch.add(torch.clamp(s // N_SUB, max=n_m - 1), s % N_SUB,
                    alpha=n_m)
    return key.to(_key_dtype(n_m))


def _key_dtype(n_m: int):
    """int16 where every key rs·n_m + m fits (the sort then makes half the
    radix passes), else int32."""
    return torch.int16 if N_SUB * n_m <= 32767 else torch.int32


def _shift_row_keys(s4, n_m: int):
    """(B,) keys rs·n_m + min(m, n_m − 1) of the snapped shifts s4 = 8m + rs
    (negative s4 count as 0): the plain version on a CPU tensor, one small
    kernel of `csrc/shift_num.cu` on a CUDA tensor."""
    if s4.device.type != "cuda":
        return shift_row_keys_reference(s4, n_m)
    if s4.dtype != torch.int32 or s4.ndim != 1 or not s4.is_contiguous():
        raise ValueError("shift_row_order: s4 must be a contiguous (B,) "
                         "int32 tensor")
    from ._cuda import load_library

    lib = load_library()
    keys = torch.empty(s4.shape, dtype=_key_dtype(n_m), device=s4.device)
    err = lib.k3_shift_keys(s4.data_ptr(), keys.data_ptr(), s4.shape[0], n_m,
                            keys.element_size(),
                            torch.cuda.current_stream(s4.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"K3 key launch failed: {lib.k1_error_string(err).decode()}")
    return keys


def shift_row_order(s4, n_l: int, n_cols: int):
    """(order, keys) of K3's row visit, for contiguous int32 `s4` (B,):
    `keys` (B,) are the rows' keys rs·n_m + m in ascending order, n_m =
    n_cols − L + 1 the number of integer shifts and m clipped as
    `_shift_parts` clips it; `order` (B,) int64 is the stable permutation
    that sorts them (`keys[g]` belongs to row `order[g]`). Consecutive rows
    then share one table row rs and neighbouring m. One sort on `s4`'s
    device, no host readback."""
    keys, order = torch.sort(_shift_row_keys(s4, n_cols - n_l + 1),
                             stable=True)
    return order, keys


def band_adjacent_table(table):
    """(N_SUB, F8, n_cols) sub-column table -> (N_SUB, F8/4, ncp, 4), the
    layout K3 stages: the 8 bands of a column are two adjacent groups of
    4 (one 16-byte read each), ncp = n_cols rounded up to 32 with zeros in
    the padding columns."""
    n_sub, f8, n_cols = table.shape
    ncp = -(-n_cols // 32) * 32
    padded = torch.nn.functional.pad(table, (0, ncp - n_cols))
    return (padded.reshape(n_sub, f8 // 4, 4, ncp).permute(0, 1, 3, 2)
            .contiguous())


def band_adjacent_table_inverse(laid, n_cols: int):
    """The (N_SUB, F8, n_cols) table that `band_adjacent_table` laid out."""
    n_sub, quads, ncp, _ = laid.shape
    return (laid.permute(0, 1, 3, 2).reshape(n_sub, quads * 4, ncp)
            [:, :, :n_cols].contiguous())


_LAID = {}  # id(table) -> (weakref, version, band-adjacent copy)


def _laid_table(table):
    """`band_adjacent_table(table)`, made once per table: cached on the
    tensor's identity and version counter, dropped with the tensor."""
    key = id(table)
    hit = _LAID.get(key)
    if hit is not None and hit[0]() is table and hit[1] == table._version:
        return hit[2]
    ref = weakref.ref(table, lambda _, key=key: _LAID.pop(key, None))
    _LAID[key] = (ref, table._version, band_adjacent_table(table))
    return _LAID[key][2]


def shift_photometry_num_ordered_reference(fw, table, s4, rows: int = 1024):
    """Plain PyTorch K3 along the kernel's data path: rows visited in
    `shift_row_order`, each shift decoded from its sorted key, the band
    values read from the band-adjacent table, results written to
    out[order[g]]. Same arguments and result as
    `shift_photometry_num_reference`."""
    b, n_l = fw.shape
    _, f8, n_cols = table.shape
    order, keys = shift_row_order(s4, n_l, n_cols)
    n_m = n_cols - n_l + 1
    rs, m = keys.long() // n_m, keys.long() % n_m
    laid = band_adjacent_table(table)
    cols = torch.arange(n_l, device=fw.device)
    out = torch.empty(b, f8, dtype=torch.float32, device=fw.device)
    for i in range(0, b, rows):
        r = slice(i, i + rows)
        # (rows, L, F8/4, 4): band f = 4·quad + position
        t = laid[rs[r, None], :, m[r, None] + cols].reshape(-1, n_l, f8)
        out[order[r]] = (t * fw[order[r], :, None]).sum(dim=1)
    return out


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"shift_photometry_num: {msg}")


def shift_photometry_num(fw, table, s4):
    """Exact numerators num[b, f] = Σ_l fw[b, l]·table[rs_b, f, l + m_b] at
    each galaxy's snapped shift s4 = 8m + rs, one kernel per call.

    Args:
        fw: (B, L) flux × dλ/λ, float32, unit column stride; a row or
            column slice of a larger slab is fine.
        table: (N_SUB, F8, L + max_shift) float32 from `build_subshift_table`.
        s4: (B,) int32 from `shift_decompose`.
    Returns:
        (B, F8) float32 numerators, rows in the caller's order.

    CPU tensors go through `shift_photometry_num_reference`. CUDA tensors
    launch the kernel (`csrc/shift_num.cu`) on the current stream: the rows
    are visited in `shift_row_order` (one sort per call), the table goes in
    as its band-adjacent copy (made once per table), and m is clipped to
    the table's reach as the plain version clips it. Flux rows that start
    16-byte aligned are streamed in 16-byte copies, others in 4-byte copies
    by the same kernel; a row's result is the same bits either way, and
    whatever the other rows of the batch are. Inputs the kernel does not
    take raise ValueError, a failed launch or an input that needs a
    gradient RuntimeError. Each launch adds one to
    `shift_photometry_num.launches`.
    """
    if fw.device.type == "cpu":
        return shift_photometry_num_reference(fw, table, s4)
    _require(fw.device.type == "cuda",
             f"tensors on {fw.device} are neither CPU nor CUDA")
    refuse_autodiff("shift_photometry_num", fw, table, s4)
    for name, t, dtype in (("fw", fw, torch.float32),
                           ("table", table, torch.float32),
                           ("s4", s4, torch.int32)):
        _require(t.device == fw.device, f"{name} is on {t.device}")
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _require(fw.ndim == 2 and fw.stride(1) == 1,
             "fw must be (B, L) with unit column stride")
    b, n_l = fw.shape
    _require(table.ndim == 3 and table.shape[0] == N_SUB
             and table.is_contiguous(),
             f"table must be a contiguous ({N_SUB}, F8, L + max_shift) tensor")
    _, f8, n_cols = table.shape
    _require(f8 % 8 == 0 and n_cols >= n_l,
             f"table has shape {tuple(table.shape)} for L = {n_l}")
    _require(tuple(s4.shape) == (b,) and s4.is_contiguous(),
             "s4 must be a contiguous (B,) tensor")
    _require(b >= 1 and n_l >= 1, "empty batch or flux row")
    from ._cuda import load_library

    lib = load_library()
    order, keys = shift_row_order(s4, n_l, n_cols)
    laid = _laid_table(table)
    aligned = fw.data_ptr() % 16 == 0 and (b == 1 or fw.stride(0) % 4 == 0)
    out = torch.empty((b, f8), dtype=torch.float32, device=fw.device)
    stream = torch.cuda.current_stream(fw.device).cuda_stream
    err = lib.k3_shift_num(fw.data_ptr(), fw.stride(0), laid.data_ptr(),
                           keys.data_ptr(), keys.element_size(),
                           order.data_ptr(), out.data_ptr(), b, n_l, f8,
                           n_cols, laid.shape[2], 4 if aligned else 1, stream)
    if err:
        raise RuntimeError(
            f"K3 launch failed: {lib.k1_error_string(err).decode()}")
    shift_photometry_num.launches += 1
    return out


shift_photometry_num.launches = 0


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

    The rescale 1/m is detached, as the JAX package stops its gradient: the
    normalised slope is homogeneous of degree 0 in (da, db), so the rescale
    changes neither value nor derivative, while the derivative of 1/m at
    m ~ 1e30 would form inf·0 = NaN in either AD mode.
    """
    same = ((da > 0.0) & (db > 0.0)) | ((da < 0.0) & (db < 0.0))
    m = torch.abs(da) + torch.abs(db)
    sc = (1.0 / torch.clamp(m, min=1.0e-30)).detach()
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
    # 0 .. n_knots-2; the clamp keeps a NaN shift's index in range (the
    # result is NaN through t), where the JAX package's gather clamps
    k = torch.clamp(torch.floor(c).to(torch.int64), 0, n_knots - 2)
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


def _bf16(x):
    """x rounded to bf16 and back: the knot products' input type."""
    return x.to(torch.bfloat16).float()


def conv_photometry_num(fnu_w, ext_table, n_knots: int, s,
                        delta: int = KNOT_DELTA,
                        order: int = KNOT_INTERP_ORDER,
                        chunk_knots: int = 16, l_offset: int = 0,
                        filter_cols=None, group_filters: int = 8):
    """(B, F) numerators from chunked on-the-fly knot products, the same
    numbers as the interp variant's knot product without a stored knot
    matrix.

    Args:
        fnu_w: (B, L) flux × dλ/λ on rest columns l_offset .. l_offset+L−1.
        ext_table: (F, n_cols) transmissions at λ0·10^{jΔ}
            (`FilterSet.shifted_table`).
        s: (B,) real column shifts log10(1+z)/Δ.
        filter_cols: optional per-filter (c0, c1) nonzero column ranges of
            `ext_table`; given, the windowed engine runs.
    Inputs of each product are rounded to bf16 and accumulated in fp32, as
    in `fused_sed.knot_product`. Pair with the den knots of
    `build_den_table` interpolated the same way.
    """
    b, n_l = fnu_w.shape
    f = ext_table.shape[0]
    need = l_offset + n_l + (n_knots - 1) * delta + 1
    if ext_table.shape[1] < need:
        ext_table = torch.nn.functional.pad(
            ext_table, (0, need - ext_table.shape[1]))
    g_t = _bf16(ext_table.T)  # (n_cols, F)
    fw = _bf16(fnu_w)
    if filter_cols is not None:
        num_all = _conv_num_windowed(fw, g_t, n_knots, delta, chunk_knots,
                                     l_offset, filter_cols, group_filters)
        return _knot_interp(num_all, s, n_knots, delta, order)
    l_idx = torch.arange(l_offset, l_offset + n_l,
                         device=fw.device)[:, None]  # (L, 1)
    chunks = []
    for k0 in range(0, n_knots, chunk_knots):
        kc = min(chunk_knots, n_knots - k0)
        col = (k0 + torch.arange(kc, device=fw.device)) * delta
        m = g_t[l_idx + col[None, :]]  # (L, Kc, F), released after the product
        chunks.append((fw @ m.reshape(n_l, kc * f)).reshape(b, kc, f))
    return _knot_interp(torch.cat(chunks, dim=1), s, n_knots, delta, order)


def _conv_num_windowed(fw, g_t, n_knots: int, delta: int, chunk_knots: int,
                       l_offset: int, filter_cols, group_filters: int):
    """(B, K, F) windowed conv numerators.

    For filter f with support [c0_f, c1_f) on the extended table,
    num[b, k, f] = Σ_l fw[b, l]·G[f, l + kδ] is nonzero only for l in
    [c0_f − kδ, c1_f − kδ). Filters sorted by c0 form groups of
    `group_filters`; each (group, knot chunk) is one (B, V) @ (V, Kc·Fg)
    product over a window of V columns, the same V for every pair (the
    widened columns meet zero transmission). fw is zero-padded on the blue
    side so every window lies inside it.
    """
    b, n_l = fw.shape
    f = g_t.shape[1]
    c0 = np.array([c[0] for c in filter_cols])
    c1 = np.array([c[1] for c in filter_cols])
    order_f = np.argsort(c0, kind="stable")
    groups = []
    for gi in range(0, f, group_filters):
        idx = order_f[gi:gi + group_filters]
        groups.append((idx, int(c0[idx].min()), int(c1[idx].max())))
    v_win = (max(a1 - a0 for _, a0, a1 in groups)
             + (chunk_knots - 1) * delta)
    plan = []  # (k0, kc, [(idx, w_start), ...])
    w_min = l_offset
    for k0 in range(0, n_knots, chunk_knots):
        kc = min(chunk_knots, n_knots - k0)
        row = []
        for idx, _, a1 in groups:
            w_start = min(a1 - k0 * delta, l_offset + n_l) - v_win
            w_min = min(w_min, w_start)
            row.append((idx, w_start))
        plan.append((k0, kc, row))
    fw_pad = torch.nn.functional.pad(fw, (l_offset - w_min, 0))
    dev = fw.device
    chunk_outs = []
    for k0, kc, row in plan:
        col = (k0 + torch.arange(kc, device=dev)) * delta
        per_group = []
        for idx, w_start in row:
            win = fw_pad[:, w_start - w_min:w_start - w_min + v_win]
            # columns below l_offset lie in the zero pad: the clamped G rows
            # they gather multiply zeros
            j = torch.clamp(torch.arange(w_start, w_start + v_win,
                                         device=dev), min=0)[:, None]
            g = g_t[:, torch.as_tensor(idx, device=dev)]
            m = g[j + col[None, :]]  # (V, Kc, Fg)
            per_group.append((win @ m.reshape(v_win, kc * len(idx)))
                             .reshape(b, kc, len(idx)))
        chunk_outs.append(torch.cat(per_group, dim=2))
    num_sorted = torch.cat(chunk_outs, dim=1)  # (B, K, F sorted)
    inv = torch.as_tensor(np.argsort(order_f), device=dev)
    return num_sorted[:, :, inv]
