"""K1 and K2: the SED → photometry megakernels and their plain versions.

Counterpart of `synference_tpu/ops/fused_sed.py` (the TPU Pallas
`_mega_kernel`, reached through `fused_window_photometry` and
`fused_sed_photometry`). Per galaxy, over W rest-frame λ columns and kc
knots of the IGM-baked knot matrix:

    lnu  = sfzh @ sed_w                 (fp32; sed_w carries dλ/λ)
    fw   = lnu · (fesc + (1−fesc)·exp(−τ_V·k_λ))

With a birth-cloud screen (`tau_bc`, Charlot & Fall 2000) the first
`n_young` cells, the young stars of the age-major SFZH, also sit behind
exp(−τ_BC·k_λ):

    lnu  = (sfzh[:, :n_young] @ sed_w[:n_young])·exp(−τ_BC·k_λ)
           + sfzh[:, n_young:] @ sed_w[n_young:]

With a per-row escape fraction (`fesc_row`, Pacman emission) a second
table, the incident spectra `sed_inc` (tables["inc"]), escapes unscreened
beside the screened reprocessed light of `sed_w`:

    fw   = fesc_row·(sfzh @ sed_inc)
           + (1−fesc_row)·(sfzh @ sed_w)·exp(−τ_V·k_λ)

    acc  = bf16(fw) @ bf16(knot_w)      (fp32 accumulation)
    out  = interp(acc; s) / max(interp(den_w; s), 1e-30) · scale

K1 (`csrc/fused_window.cu`) runs it over z-sorted sub-chunks, each through
its own window: `fused_window_photometry_grouped` covers a whole batch of
sub-chunks in one launch (the counterpart of the JAX package's `lax.scan`
over sub-chunks), `fused_window_photometry` one sub-chunk. K2
(`fused_sed_photometry`, `csrc/fused_sed.cu`) runs it over the whole λ
support and knot table for θ in any order, visiting the rows in the order
of `k2_row_order`. Both kernels share one core (`csrc/sed_tile.cuh`): an
fp32 FMA first product fed by TMA with K-major operands (sfzh's rows and
the spectra's (L, C) transpose, both through `k_major`); at
more than 8 bands its blocks run in thread-block clusters of
`cluster_size(F8)` band groups that share one first product. The
wrappers launch their kernel for tensors on a card and take the plain
version only for CPU tensors. `fused_window_photometry_reference` is the
one plain version (the grouped one loops it over sub-chunks, K2's runs it
over the full tables); `window_ratio` is the one num/den/interpolation
definition the kernels' plain versions and the simulator's plain bodies
use. `fused_window_photometry_exact` (the first product in float64) and
`exact_gate` are what the card checks hold the kernels to;
`tf32x3_first_product` is the tensor-core scheme that gate rejects on the
card.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from ._cuda import refuse_autodiff
from .photometry_kernel import _knot_interp

__all__ = ["fused_window_photometry", "fused_window_photometry_reference",
           "fused_window_photometry_exact",
           "fused_window_photometry_grouped",
           "fused_window_photometry_grouped_reference",
           "fused_sed_photometry", "fused_sed_photometry_reference",
           "k2_row_order", "prepare_megakernel_tables", "knot_product",
           "window_ratio", "cluster_size", "band_group_tables", "TILE_ROWS",
           "tf32_split", "k_major", "exact_first_product", "exact_gate"]

# galaxies per block of both kernels: the unit that `k2_row_order` packs
# into narrow knot bands
TILE_ROWS = 128


def cluster_size(f8: int) -> int:
    """Blocks per thread-block cluster of K1 and K2 at F8 bands: the band
    groups of 8 that share one galaxy tile's first product. The f8/8 groups
    go into the fewest clusters of at most 8 blocks (the portable cluster
    size), ceil(f8/64), as evenly as they go; the last cluster may hold
    padding slots that compute their share of the product and no bands. So
    each λ column's first product is computed ceil(f8/64) times per galaxy:
    once up to 64 bands, twice at 128. 1 (no cluster) at F8 = 8."""
    groups = f8 // 8
    return -(-groups // -(-groups // 8))


def band_group_tables(tables: dict, g: int, n_knots: int) -> dict:
    """Bands 8g .. 8g+7 of kernel tables of F8 bands: the knot columns
    k·F8 + 8g .. k·F8 + 8g + 7 of every knot k re-packed as an 8-band knot
    matrix, and the den columns 8g .. 8g + 7. K1 and K2 at F8 bands equal,
    bit for bit, their F8 = 8 launches on these tables side by side."""
    n_l, f8 = tables["knot"].shape[0], tables["den"].shape[1]
    knot = tables["knot"].reshape(n_l, n_knots, f8)[:, :, 8 * g:8 * g + 8]
    return dict(tables, knot=knot.reshape(n_l, 8 * n_knots).contiguous(),
                den=tables["den"][:, 8 * g:8 * g + 8].contiguous())


def knot_product(fw: torch.Tensor, knot_w: torch.Tensor) -> torch.Tensor:
    """fw @ knot_w with both inputs rounded to bf16 and fp32 accumulation
    (the products of bf16 values are exact in fp32)."""
    return fw.to(torch.bfloat16).float() @ knot_w.to(torch.bfloat16).float()


def window_ratio(acc, den_w, s_rel, scale, kc: int, delta: int, order: int):
    """(B, kc·F8) knot numerators + (kc, F8) den knots -> (B, F8) fluxes:
    num and den interpolated with the same weights (the filter-edge
    staircase cancels), their ratio times the per-galaxy scale (None: no
    scale)."""
    b, f8 = acc.shape[0], den_w.shape[1]
    num = _knot_interp(acc.reshape(b, kc, f8), s_rel, kc, delta, order)
    den = _knot_interp(den_w, s_rel, kc, delta, order)
    ratio = num / torch.clamp(den, min=1.0e-30)
    return ratio if scale is None else ratio * scale[:, None]


def prepare_megakernel_tables(sed_table, wlam, dust_curve, knot_matrix,
                              den_knots, f8: int, inc_table=None) -> dict:
    """The kernels' tables, built once per simulator: "sed" (C, L) spectra
    with dλ/λ folded in, "curve" (L,) dust curve, "knot" (L, K·F8) IGM-baked
    knot matrix in bf16 (the second product's input type) and "den" (K, F8)
    den knots zero-padded to F8 bands; with `inc_table` (a per-row escape
    fraction's incident spectra, (C, L)) also "inc", it with dλ/λ. K1 reads
    windows of them, K2 the whole. No TPU padding: no 128-lane or
    power-of-two knot slots, no lane maps, no precomputed den slopes (the
    kernels take `_knot_interp`'s)."""
    den = torch.zeros(den_knots.shape[0], f8, dtype=torch.float32,
                      device=den_knots.device)
    den[:, :den_knots.shape[1]] = den_knots
    sed = (sed_table * wlam[None, :]).contiguous()
    out = {"sed": sed, "curve": dust_curve.contiguous(),
           "knot": knot_matrix.to(torch.bfloat16).contiguous(), "den": den}
    if inc_table is not None:  # one table when the two are one
        out["inc"] = (sed if inc_table is sed_table
                      else (inc_table * wlam[None, :]).contiguous())
    return out


def k_major(x):
    """x (R, C) float32 as the kernels' TMA loads read an operand: K-major,
    each row's C cells contiguous and 16-byte aligned. x itself when it
    already is so, else a copy with its cells zero-padded to a multiple of
    4. The kernels' B operand is `k_major(sed.t())` (`_b_operand`); their
    A operand is sfzh in the blocks' row order."""
    if x.stride(1) == 1 and x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    r, c = x.shape
    out = x.new_zeros((r, -(-c // 4) * 4))
    out[:, :c] = x
    return out


def tf32_truncate(x):
    """x with the 13 low mantissa bits cleared: the TF32 value the tensor
    cores read from a float32."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_split(a):
    """(hi, lo) float32 tensors with hi = a rounded to TF32 to nearest, ties
    away from zero (PTX `cvt.rna.tf32.f32`: round on the 13 low mantissa
    bits), and lo = a − hi, which is exact: hi + lo == a bit for bit."""
    bits = a.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, a - hi


def exact_first_product(sfzh, sed_w):
    """sfzh @ sed_w taken in float64 and rounded once to float32: the exact
    first product, which the kernels are held to."""
    return (sfzh.double() @ sed_w.double()).float()


def tf32x3_first_product(sfzh, sed_w):
    """A 3xTF32 first product as three matrix products: (lo_a·hi_b +
    hi_a·lo_b) + hi_a·hi_b, with (hi, lo) from `tf32_split` and each lo
    truncated to TF32 as the tensor cores read it. The products of TF32
    values are exact in float32, so on the CPU this is the split with
    float32 sums, which passes `exact_gate`; on a card it runs TF32 matrix
    products (TF32 allowed for the call) on the tensor cores, whose
    accumulation fails the gate at the main-path shapes, so the kernels do
    not take this route."""
    hi_a, lo_a = tf32_split(sfzh)
    hi_b, lo_b = tf32_split(sed_w)
    lo_a, lo_b = tf32_truncate(lo_a), tf32_truncate(lo_b)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return (lo_a @ hi_b + hi_a @ lo_b) + hi_a @ hi_b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def exact_gate(out, exact, plain) -> dict:
    """The kernels' correctness gate against the exact first product, on
    fluxes above 1e-3 of their row's maximum in `exact`: relative p99 <
    1e-5, max < 1e-3, and a share of fluxes off by more than 1e-5 at most
    twice the fp32 plain version's share against the same exact answer,
    plus 1e-4. Returns the readings and "ok"."""
    def rel(x):
        x, e = x.detach().cpu().double(), exact.detach().cpu().double()
        r = (x - e).abs() / e.abs().clamp(min=1e-30)
        return r[e > 1e-3 * e.max(dim=1, keepdim=True).values]

    r, r_plain = rel(out), rel(plain)
    share = float((r > 1e-5).double().mean())
    share_plain = float((r_plain > 1e-5).double().mean())
    p99 = float(torch.quantile(r, 0.99)) if r.numel() else 0.0
    mx = float(r.max()) if r.numel() else 0.0
    finite = bool(torch.isfinite(out).all())
    return {"p99": p99, "max": mx, "share": share,
            "share_plain": share_plain,
            "ok": (finite and p99 < 1e-5 and mx < 1e-3
                   and share <= 2 * share_plain + 1e-4)}


def fused_window_photometry_reference(sfzh, s_rel, tau_v, scale, sed_w,
                                      curve_w, knot_w, den_w, kc: int,
                                      delta: int, f8: int, order: int = 3,
                                      fesc: float = 0.0,
                                      first_product=torch.matmul,
                                      tau_bc=None, n_young: int = 0,
                                      fesc_row=None, sed_inc=None):
    """Plain PyTorch K1 (same arguments as `fused_window_photometry`).
    On a card, fp32 matrix products must not use TF32
    (`torch.backends.cuda.matmul.allow_tf32` False, PyTorch's default).
    `first_product(sfzh, sed_w)` computes lnu (tests and the card checks
    pass `exact_first_product` or an emulation); with `tau_bc` it computes
    each population's part, the young cells' then screened by the birth
    cloud; with `fesc_row` the reprocessed and the incident (`sed_inc`)
    parts, mixed by the row's escape fraction."""
    _require(tau_bc is None or fesc_row is None,
             "a birth cloud and a per-row fesc together are not a model "
             "the kernels run")
    _require((fesc_row is None) == (sed_inc is None),
             "fesc_row and sed_inc go together")
    if fesc_row is not None:
        f = fesc_row[:, None]
        att = torch.exp(-tau_v[:, None] * curve_w[None, :])
        fw = (f * first_product(sfzh, sed_inc)
              + (1.0 - f) * first_product(sfzh, sed_w) * att)
        return window_ratio(knot_product(fw, knot_w), den_w[:, :f8], s_rel,
                            scale, kc, delta, order)
    if tau_bc is None:
        lnu = first_product(sfzh, sed_w)
    else:
        bc = torch.exp(-tau_bc[:, None] * curve_w[None, :])
        lnu = (first_product(sfzh[:, :n_young], sed_w[:n_young]) * bc
               + first_product(sfzh[:, n_young:], sed_w[n_young:]))
    att = torch.exp(-tau_v[:, None] * curve_w[None, :])
    if fesc:
        att = fesc + (1.0 - fesc) * att
    acc = knot_product(lnu * att, knot_w)
    return window_ratio(acc, den_w[:, :f8], s_rel, scale, kc, delta, order)


def fused_window_photometry_exact(*args, **kwargs):
    """`fused_window_photometry_reference` with the exact first product
    (`exact_first_product`): what K1 and K2 are held to (`exact_gate`).
    For tests and card checks only."""
    return fused_window_photometry_reference(
        *args, first_product=exact_first_product, **kwargs)


def _require(cond: bool, msg: str,
             who: str = "fused_window_photometry") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _check_cuda_inputs(sfzh, s_rel, tau_v, scale, sed_w, curve_w, knot_w,
                       den_w, kc, delta, f8, order,
                       who: str = "fused_window_photometry", tau_bc=None,
                       n_young: int = 0, fesc_row=None, sed_inc=None):
    req = functools.partial(_require, who=who)
    dev = sfzh.device
    named = dict(sfzh=sfzh, s_rel=s_rel, tau_v=tau_v, scale=scale,
                 sed_w=sed_w, curve_w=curve_w, knot_w=knot_w, den_w=den_w)
    req(tau_bc is None or fesc_row is None,
        "tau_bc and fesc_row together: no kernel runs both")
    req((fesc_row is None) == (sed_inc is None),
        "fesc_row needs the incident table, and only it")
    for name, t in (("tau_bc", tau_bc), ("fesc_row", fesc_row),
                    ("sed_inc", sed_inc)):
        if t is not None:
            named[name] = t
    for name, t in named.items():
        req(t.device == dev, f"{name} is on {t.device}, sfzh on {dev}")
        want = torch.bfloat16 if name == "knot_w" else torch.float32
        req(t.dtype == want, f"{name} must be {want}, got {t.dtype}")
    req(sfzh.ndim == 2, "sfzh must be (B, C)")
    b, c = sfzh.shape
    w = sed_w.shape[-1]
    req(b >= 1 and c >= 1 and w >= 1, "empty batch, cells or window")
    req(kc >= 2 and delta >= 1 and 8 <= f8 <= 128 and f8 % 8 == 0,
        f"need kc >= 2, delta >= 1, f8 a multiple of 8 with f8 <= 128 "
        f"(kc={kc}, delta={delta}, f8={f8})")
    # the kernels copy knot rows in 16-byte groups of 8 bands
    req(knot_w.stride(0) % 8 == 0 and knot_w.data_ptr() % 16 == 0,
        "knot_w rows must start 16-byte aligned")
    req(order in (1, 3), f"order must be 1 or 3, not {order}")
    req(0 <= n_young <= c, f"n_young must lie in [0, {c}], not {n_young}")
    shapes = dict(s_rel=(b,), tau_v=(b,), tau_bc=(b,), fesc_row=(b,),
                  scale=(b,), sed_w=(c, w), sed_inc=(c, w), curve_w=(w,),
                  knot_w=(w, kc * f8),
                  den_w=(kc, f8))
    for name, shape in ((k, v) for k, v in shapes.items() if k in named):
        req(tuple(named[name].shape) == shape,
            f"{name} has shape {tuple(named[name].shape)}, expected {shape}")
    # 1-D inputs contiguous; 2-D inputs unit column stride with any row
    # stride (window views of the simulator's tables are passed as is)
    for name, t in named.items():
        if t.ndim == 1:
            req(t.is_contiguous(), f"{name} must be contiguous")
        else:
            req(t.stride(1) == 1 and t.stride(0) >= t.shape[1],
                f"{name} needs unit column stride, got {t.stride()}")
    req(b * max(f8, kc * f8) < 2**31, "batch too large")


# id(sed) -> (weak reference to sed, its version, k_major(sed.t())): the
# kernels' B operand of each live spectra table, made on its first launch
_SED_K: dict = {}


def _b_operand(sed):
    """The kernels' B operand, `k_major(sed.t())`: made once per spectra
    table (the simulator's, on its first launch) and made anew when the
    table is written in place; "sed" stays the one copy of the spectra.
    Inference tensors, which keep no version, get one per call, as does a
    table already K-major (its operand is a view that would keep it
    alive)."""
    key = id(sed)
    hit = _SED_K.get(key)
    if hit is not None and hit[0]() is sed and hit[1] == sed._version:
        return hit[2]
    sed_k = k_major(sed.t())
    if not sed.is_inference() and sed_k.data_ptr() != sed.data_ptr():
        _SED_K[key] = (weakref.ref(sed, lambda _, k=key: _SED_K.pop(k, None)),
                       sed._version, sed_k)
    return sed_k


def _launch_k1(sfzh, s, tau_v, scale, sed_k, curve, knot, den, win, w: int,
               kc: int, delta: int, f8: int, order: int, fesc: float,
               sub: int, tau_bc=None, n_young: int = 0, fesc_row=None,
               inc_k=None):
    """One K1 launch over ceil(B/sub) sub-chunks (`win` their (k0, l0)
    int32 starts on the card, None for one window at (0, 0)); `sed_k` the
    (L, C) K-major spectra (`k_major`); `tau_bc` None for one screen;
    `fesc_row` with `inc_k`, the K-major incident spectra, for the escape
    kernels."""
    from ._cuda import load_library

    lib = load_library()
    b, c = sfzh.shape
    # block x of a window group reads its 128 galaxies as one TMA box of
    # rows; rows of a box past its group are the next group's (or zeros past
    # the end), and the kernel drops them
    a = k_major(sfzh)
    out = torch.empty((b, f8), dtype=torch.float32, device=sfzh.device)
    stream = torch.cuda.current_stream(sfzh.device).cuda_stream
    err = lib.k1_fused_window(
        a.data_ptr(), a.shape[0], a.stride(0), s.data_ptr(), tau_v.data_ptr(),
        None if tau_bc is None else tau_bc.data_ptr(), n_young,
        None if fesc_row is None else fesc_row.data_ptr(),
        scale.data_ptr(), sed_k.data_ptr(), sed_k.shape[0], sed_k.stride(0),
        None if inc_k is None else inc_k.data_ptr(),
        0 if inc_k is None else inc_k.stride(0), curve.data_ptr(),
        knot.data_ptr(), knot.stride(0), den.data_ptr(),
        den.stride(0), None if win is None else win.data_ptr(),
        out.data_ptr(), b, c, w, kc, f8, delta, order, float(fesc), sub,
        cluster_size(f8), stream)
    if err:
        raise RuntimeError(
            f"K1 launch failed: {lib.k1_error_string(err).decode()}")
    fused_window_photometry.launches += 1
    return out


def fused_window_photometry(sfzh, s_rel, tau_v, scale, sed_w, curve_w,
                            knot_w, den_w, kc: int, delta: int, f8: int,
                            order: int = 3, fesc: float = 0.0, tau_bc=None,
                            n_young: int = 0, fesc_row=None, sed_inc=None):
    """Windowed SED → (B, F8) band fluxes for one sub-chunk, one kernel per
    call (the grouped kernel over a single window).

    Args:
        sfzh: (B, C) SFZH mass weights [Msun], float32.
        s_rel: (B,) column shifts relative to the window (s − k0·δ).
        tau_v, scale: (B,) dust depth / observed-frame scalar
            (1+z)·1e-6/(4π d19²).
        sed_w: (C, W) window spectra with dλ/λ folded in, float32.
        curve_w: (W,) dust curve k_λ/R_V on the window.
        knot_w: (W, kc·F8) IGM-baked knot-matrix window; bfloat16 on a card.
        den_w: (kc, F8) exact denominator knots of the window.
        tau_bc: (B,) birth-cloud depth of the young cells, the first
            `n_young` of C; None (the default) for the ISM screen alone.
        fesc_row: (B,) escape fraction (Pacman emission): `sed_inc`, the
            (C, W) window of the incident spectra with dλ/λ, escapes
            unscreened and `sed_w`, the reprocessed light, sits behind the
            ISM screen; `fesc` is then 0. None (the default) for neither.
            Not with `tau_bc`.

    CPU tensors go through `fused_window_photometry_reference`. CUDA tensors
    launch the kernel on the current stream; inputs the kernel does not take
    raise ValueError, a failed launch raises RuntimeError, and so does an
    input that needs a gradient (`_cuda.refuse_autodiff`). Each launch adds
    one to `fused_window_photometry.launches`.
    """
    if sfzh.device.type == "cpu":
        return fused_window_photometry_reference(
            sfzh, s_rel, tau_v, scale, sed_w, curve_w, knot_w, den_w, kc,
            delta, f8, order=order, fesc=fesc, tau_bc=tau_bc,
            n_young=n_young, fesc_row=fesc_row, sed_inc=sed_inc)
    _require(sfzh.device.type == "cuda",
             f"tensors on {sfzh.device} are neither CPU nor CUDA")
    refuse_autodiff("fused_window_photometry", sfzh, s_rel, tau_v, scale,
                    sed_w, curve_w, knot_w, den_w, tau_bc, fesc_row, sed_inc)
    _check_cuda_inputs(sfzh, s_rel, tau_v, scale, sed_w, curve_w, knot_w,
                       den_w, kc, delta, f8, order, tau_bc=tau_bc,
                       n_young=n_young, fesc_row=fesc_row, sed_inc=sed_inc)
    return _launch_k1(sfzh, s_rel, tau_v, scale, k_major(sed_w.t()), curve_w,
                      knot_w, den_w, None, sed_w.shape[1], kc, delta, f8,
                      order, fesc, sfzh.shape[0], tau_bc, n_young, fesc_row,
                      None if sed_inc is None else k_major(sed_inc.t()))


fused_window_photometry.launches = 0


def _window_starts(k0, l0, n_rows: int, sub: int, w_cols: int, kc: int,
                   n_knots: int, n_l: int) -> np.ndarray:
    """Host-checked (n_sub, 2) int32 window starts (k0, l0), one per
    sub-chunk of `sub` rows; raises ValueError on a bad array."""
    who = "fused_window_photometry_grouped"
    k0, l0 = np.asarray(k0), np.asarray(l0)
    n_sub = -(-n_rows // sub) if sub >= 1 else 0
    _require(sub >= 1 and n_rows >= 1, f"need rows and sub >= 1 (rows "
             f"{n_rows}, sub {sub})", who)
    _require(k0.shape == (n_sub,) and l0.shape == (n_sub,),
             f"window starts need shape ({n_sub},) for {n_rows} rows in "
             f"sub-chunks of {sub}, got {k0.shape} and {l0.shape}", who)
    _require(np.issubdtype(k0.dtype, np.integer)
             and np.issubdtype(l0.dtype, np.integer),
             f"window starts must be integers, got {k0.dtype}, {l0.dtype}",
             who)
    _require(2 <= kc <= n_knots and 1 <= w_cols <= n_l,
             f"window of {kc} knots x {w_cols} columns does not fit the "
             f"{n_knots} x {n_l} tables", who)
    _require(bool(np.all((k0 >= 0) & (k0 <= n_knots - kc))),
             f"knot starts must lie in [0, {n_knots - kc}]", who)
    _require(bool(np.all((l0 >= 0) & (l0 <= n_l - w_cols))),
             f"column starts must lie in [0, {n_l - w_cols}]", who)
    return np.stack([k0, l0], axis=1).astype(np.int32)


def fused_window_photometry_grouped_reference(sfzh, s, tau_v, scale,
                                              tables: dict, k0, l0,
                                              sub: int, w_cols: int,
                                              kc: int, delta: int, f8: int,
                                              order: int = 3,
                                              fesc: float = 0.0,
                                              first_product=torch.matmul,
                                              tau_bc=None,
                                              n_young: int = 0,
                                              fesc_row=None):
    """Plain PyTorch grouped K1: `fused_window_photometry_reference` per
    sub-chunk, each on its own window of the tables (`first_product`,
    `tau_bc`, `n_young` and `fesc_row`, with tables["inc"], as there)."""
    out = torch.empty((sfzh.shape[0], f8), dtype=torch.float32,
                      device=sfzh.device)
    for i, (k, l) in enumerate(zip(np.asarray(k0).tolist(),
                                   np.asarray(l0).tolist())):
        r = slice(i * sub, (i + 1) * sub)
        cols = slice(l, l + w_cols)
        out[r] = fused_window_photometry_reference(
            sfzh[r], s[r] - float(k * delta), tau_v[r], scale[r],
            tables["sed"][:, cols], tables["curve"][cols],
            tables["knot"][cols, k * f8:(k + kc) * f8],
            tables["den"][k:k + kc], kc, delta, f8, order=order, fesc=fesc,
            first_product=first_product,
            tau_bc=None if tau_bc is None else tau_bc[r], n_young=n_young,
            fesc_row=None if fesc_row is None else fesc_row[r],
            sed_inc=None if fesc_row is None else tables["inc"][:, cols])
    return out


def fused_window_photometry_grouped(sfzh, s, tau_v, scale, tables: dict, k0,
                                    l0, sub: int, w_cols: int, kc: int,
                                    delta: int, f8: int, order: int = 3,
                                    fesc: float = 0.0, tau_bc=None,
                                    n_young: int = 0, fesc_row=None):
    """Windowed SED → (B, F8) band fluxes for a batch of z-sorted
    sub-chunks, one kernel launch for all of them.

    Rows [i·sub, (i+1)·sub) are sub-chunk i; it reads λ columns
    l0[i] .. l0[i]+w_cols and knots k0[i] .. k0[i]+kc of `tables`
    (`prepare_megakernel_tables`). `s` (B,) holds the absolute column
    shifts log10(1+z)/Δ; `k0`, `l0` are host integer sequences (the
    planner's), checked here and copied to the card as one int32 array.
    Other arguments (`tau_bc`, `n_young`, `fesc_row` too) as
    `fused_window_photometry`, whose `sed_inc` is tables["inc"] here.

    CPU tensors go through `fused_window_photometry_grouped_reference`.
    CUDA tensors launch K1 once on the current stream (one more on
    `fused_window_photometry.launches`); bad inputs raise ValueError, a
    failed launch or an input that needs a gradient RuntimeError.
    """
    sed, curve, knot, den = (tables[k] for k in ("sed", "curve", "knot",
                                                 "den"))
    n_knots, n_l = den.shape[0], sed.shape[1]
    win = _window_starts(k0, l0, sfzh.shape[0], sub, w_cols, kc, n_knots,
                         n_l)
    if sfzh.device.type == "cpu":
        return fused_window_photometry_grouped_reference(
            sfzh, s, tau_v, scale, tables, win[:, 0], win[:, 1], sub,
            w_cols, kc, delta, f8, order=order, fesc=fesc, tau_bc=tau_bc,
            n_young=n_young, fesc_row=fesc_row)
    who = "fused_window_photometry_grouped"
    _require(sfzh.device.type == "cuda",
             f"tensors on {sfzh.device} are neither CPU nor CUDA", who)
    inc = None if fesc_row is None else tables.get("inc")
    refuse_autodiff(who, sfzh, s, tau_v, scale, sed, curve, knot, den,
                    tau_bc, fesc_row, inc)
    _check_cuda_inputs(sfzh, s, tau_v, scale, sed, curve, knot, den,
                       n_knots, delta, f8, order, who=who, tau_bc=tau_bc,
                       n_young=n_young, fesc_row=fesc_row, sed_inc=inc)
    win = torch.as_tensor(win).to(sfzh.device, non_blocking=True)
    return _launch_k1(sfzh, s, tau_v, scale, _b_operand(sed), curve, knot,
                      den, win, w_cols, kc, delta, f8, order, fesc, sub,
                      tau_bc, n_young, fesc_row,
                      None if inc is None else _b_operand(inc))


def fused_sed_photometry_reference(sfzh, s, tau_v, scale, tables: dict,
                                   n_knots: int, delta: int, f8: int,
                                   order: int = 3, fesc: float = 0.0,
                                   first_product=torch.matmul, tau_bc=None,
                                   n_young: int = 0, fesc_row=None):
    """Plain PyTorch K2: K1's plain version over the whole tables
    (kc = n_knots, shifts relative to knot 0; `first_product`, `tau_bc`,
    `n_young` and `fesc_row`, with tables["inc"], as there)."""
    return fused_window_photometry_reference(
        sfzh, s, tau_v, scale, tables["sed"], tables["curve"],
        tables["knot"], tables["den"], n_knots, delta, f8, order=order,
        fesc=fesc, first_product=first_product, tau_bc=tau_bc,
        n_young=n_young, fesc_row=fesc_row,
        sed_inc=None if fesc_row is None else tables["inc"])


def k2_row_order(s, n_knots: int, delta: int) -> torch.Tensor:
    """(B,) int32 permutation of the rows, sorted (stably) by the first knot
    row each galaxy reads, max(k − 1, 0) with k its clipped knot interval:
    K2 visits rows in this order, so each block of `TILE_ROWS` consecutive
    galaxies spans a narrow band of knots. One argsort on `s`'s device."""
    c = torch.clamp(s, 0.0, (n_knots - 1) * delta - 1.0e-3) / delta
    first = torch.clamp(torch.floor(c).to(torch.int32) - 1, min=0)
    return torch.argsort(first, stable=True).to(torch.int32)


def _check_rows(rows, b: int, device) -> None:
    """A caller's row order: int32 (B,) contiguous on the batch's device
    and a permutation of 0..B−1 (checked with one sort)."""
    who = "fused_sed_photometry"
    _require(torch.is_tensor(rows) and rows.dtype == torch.int32,
             "rows must be an int32 tensor", who)
    _require(rows.device == device and tuple(rows.shape) == (b,)
             and rows.is_contiguous(),
             f"rows must be a contiguous ({b},) tensor on {device}, got "
             f"{tuple(rows.shape)} on {rows.device}", who)
    _require(torch.equal(torch.sort(rows).values,
                         torch.arange(b, dtype=torch.int32, device=device)),
             "rows must be a permutation of the batch's rows", who)


def fused_sed_photometry(sfzh, s, tau_v, scale, tables: dict, n_knots: int,
                         delta: int, f8: int, order: int = 3,
                         fesc: float = 0.0, rows=None, tau_bc=None,
                         n_young: int = 0, fesc_row=None):
    """SED → (B, F8) band fluxes over the whole λ support and knot table,
    one kernel per call, for galaxies in any redshift order.

    Args:
        sfzh: (B, C) SFZH mass weights [Msun], float32.
        s: (B,) real column shifts log10(1+z)/Δ.
        tau_v, scale: (B,) dust depth / observed-frame scalar
            (1+z)·1e-6/(4π d19²).
        tables: `prepare_megakernel_tables` output: "sed" (C, L), "curve"
            (L,), "knot" (L, n_knots·F8) bfloat16, "den" (n_knots, F8).
        rows: the order the kernel visits the rows in; None (the default)
            computes `k2_row_order`. The output is in input order either way.
        tau_bc, n_young: the birth-cloud screen, as
            `fused_window_photometry`.
        fesc_row: (B,) escape fraction, as `fused_window_photometry`, the
            incident table tables["inc"] (C, L).

    CPU tensors go through `fused_sed_photometry_reference`. CUDA tensors
    launch the kernel (`csrc/fused_sed.cu`) on the current stream; inputs it
    does not take raise ValueError, a failed launch or an input that needs
    a gradient RuntimeError. Each launch adds one to
    `fused_sed_photometry.launches`.
    """
    if rows is not None:
        _check_rows(rows, sfzh.shape[0], sfzh.device)
    if sfzh.device.type == "cpu":
        return fused_sed_photometry_reference(
            sfzh, s, tau_v, scale, tables, n_knots, delta, f8, order=order,
            fesc=fesc, tau_bc=tau_bc, n_young=n_young, fesc_row=fesc_row)
    who = "fused_sed_photometry"
    _require(sfzh.device.type == "cuda",
             f"tensors on {sfzh.device} are neither CPU nor CUDA", who)
    sed, curve, knot, den = (tables[k] for k in ("sed", "curve", "knot",
                                                 "den"))
    inc = None if fesc_row is None else tables.get("inc")
    refuse_autodiff(who, sfzh, s, tau_v, scale, sed, curve, knot, den,
                    tau_bc, fesc_row, inc)
    _check_cuda_inputs(sfzh, s, tau_v, scale, sed, curve, knot, den,
                       n_knots, delta, f8, order, who=who, tau_bc=tau_bc,
                       n_young=n_young, fesc_row=fesc_row, sed_inc=inc)
    if rows is None:
        rows = k2_row_order(s, n_knots, delta)
    from ._cuda import load_library

    lib = load_library()
    b, c = sfzh.shape
    a = k_major(sfzh.index_select(0, rows))
    b_op = _b_operand(sed)
    inc_op = None if inc is None else _b_operand(inc)
    out = torch.empty((b, f8), dtype=torch.float32, device=sfzh.device)
    stream = torch.cuda.current_stream(sfzh.device).cuda_stream
    err = lib.k2_fused_sed(
        a.data_ptr(), a.shape[0], a.stride(0), rows.data_ptr(), s.data_ptr(),
        tau_v.data_ptr(), None if tau_bc is None else tau_bc.data_ptr(),
        n_young, None if fesc_row is None else fesc_row.data_ptr(),
        scale.data_ptr(), b_op.data_ptr(), b_op.stride(0),
        None if inc_op is None else inc_op.data_ptr(),
        0 if inc_op is None else inc_op.stride(0), curve.data_ptr(),
        knot.data_ptr(), knot.stride(0), den.data_ptr(),
        den.stride(0), out.data_ptr(), b, c, sed.shape[1], n_knots, f8,
        delta, order, float(fesc), cluster_size(f8), stream)
    if err:
        raise RuntimeError(
            f"K2 launch failed: {lib.k1_error_string(err).decode()}")
    fused_sed_photometry.launches += 1
    return out


fused_sed_photometry.launches = 0
