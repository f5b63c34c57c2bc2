"""K1 and K2: the SED → photometry megakernels and their plain versions.

Counterpart of `synference_tpu/ops/fused_sed.py` (the TPU Pallas
`_mega_kernel`, reached through `fused_window_photometry` and
`fused_sed_photometry`). Per galaxy, over W rest-frame λ columns and kc
knots of the IGM-baked knot matrix:

    lnu  = sfzh @ sed_w                 (fp32; sed_w carries dλ/λ)
    fw   = lnu · (fesc + (1−fesc)·exp(−τ_V·k_λ))
    acc  = bf16(fw) @ bf16(knot_w)      (fp32 accumulation)
    out  = interp(acc; s) / max(interp(den_w; s), 1e-30) · scale

K1 (`fused_window_photometry`, `csrc/fused_window.cu`) runs it over one
z-sorted sub-chunk's window; K2 (`fused_sed_photometry`,
`csrc/fused_sed.cu`) over the whole λ support and knot table for θ in any
order, contracting only the 4 knot rows each galaxy interpolates. Both
launch their CUDA kernel for tensors on a card and take the plain version
only for CPU tensors. `fused_window_photometry_reference` is the one plain
version (K2's is K1's over the full tables); `window_ratio` is the one
num/den/interpolation definition the kernels' plain versions and the
simulator's plain bodies use.
"""

from __future__ import annotations

import functools
import math

import torch

from .photometry_kernel import _knot_interp

__all__ = ["fused_window_photometry", "fused_window_photometry_reference",
           "fused_sed_photometry", "fused_sed_photometry_reference",
           "prepare_megakernel_tables", "knot_product", "window_ratio",
           "FUSED_SED_MIN_KNOTS"]

# shared memory one block can opt into on Hopper (227 KB)
_MAX_SMEM = 232448
# K2 reads 4 consecutive knot rows per galaxy (k−1..k+2, clamped to the table)
FUSED_SED_MIN_KNOTS = 4


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
                              den_knots, f8: int) -> dict:
    """The kernels' tables, built once per simulator: "sed" (C, L) spectra
    with dλ/λ folded in, "curve" (L,) dust curve, "knot" (L, K·F8) IGM-baked
    knot matrix in bf16 (the second product's input type) and "den" (K, F8)
    den knots zero-padded to F8 bands. K1 reads windows of them, K2 the
    whole. No TPU padding: no 128-lane or power-of-two knot slots, no lane
    maps, no precomputed den slopes (the kernels take `_knot_interp`'s)."""
    den = torch.zeros(den_knots.shape[0], f8, dtype=torch.float32,
                      device=den_knots.device)
    den[:, :den_knots.shape[1]] = den_knots
    return {
        "sed": (sed_table * wlam[None, :]).contiguous(),
        "curve": dust_curve.contiguous(),
        "knot": knot_matrix.to(torch.bfloat16).contiguous(),
        "den": den,
    }


def fused_window_photometry_reference(sfzh, s_rel, tau_v, scale, sed_w,
                                      curve_w, knot_w, den_w, kc: int,
                                      delta: int, f8: int, order: int = 3,
                                      fesc: float = 0.0):
    """Plain PyTorch K1 (same arguments as `fused_window_photometry`).
    On a card, fp32 matrix products must not use TF32
    (`torch.backends.cuda.matmul.allow_tf32` False, PyTorch's default)."""
    lnu = sfzh @ sed_w
    att = torch.exp(-tau_v[:, None] * curve_w[None, :])
    if fesc:
        att = fesc + (1.0 - fesc) * att
    acc = knot_product(lnu * att, knot_w)
    return window_ratio(acc, den_w[:, :f8], s_rel, scale, kc, delta, order)


def _require(cond: bool, msg: str,
             who: str = "fused_window_photometry") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _check_cuda_inputs(sfzh, s_rel, tau_v, scale, sed_w, curve_w, knot_w,
                       den_w, kc, delta, f8, order,
                       who: str = "fused_window_photometry"):
    req = functools.partial(_require, who=who)
    dev = sfzh.device
    named = dict(sfzh=sfzh, s_rel=s_rel, tau_v=tau_v, scale=scale,
                 sed_w=sed_w, curve_w=curve_w, knot_w=knot_w, den_w=den_w)
    for name, t in named.items():
        req(t.device == dev, f"{name} is on {t.device}, sfzh on {dev}")
        want = torch.bfloat16 if name == "knot_w" else torch.float32
        req(t.dtype == want, f"{name} must be {want}, got {t.dtype}")
    req(sfzh.ndim == 2, "sfzh must be (B, C)")
    b, c = sfzh.shape
    w = sed_w.shape[-1]
    req(b >= 1 and c >= 1 and w >= 1, "empty batch, cells or window")
    req(kc >= 2 and delta >= 1 and 1 <= f8 <= 128,
        f"need kc >= 2, delta >= 1, 1 <= f8 <= 128 (kc={kc}, "
        f"delta={delta}, f8={f8})")
    req(order in (1, 3), f"order must be 1 or 3, not {order}")
    shapes = dict(s_rel=(b,), tau_v=(b,), scale=(b,), sed_w=(c, w),
                  curve_w=(w,), knot_w=(w, kc * f8), den_w=(kc, f8))
    for name, shape in shapes.items():
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


def fused_window_photometry(sfzh, s_rel, tau_v, scale, sed_w, curve_w,
                            knot_w, den_w, kc: int, delta: int, f8: int,
                            order: int = 3, fesc: float = 0.0):
    """Windowed SED → (B, F8) band fluxes, one kernel per call.

    Args:
        sfzh: (B, C) SFZH mass weights [Msun], float32.
        s_rel: (B,) column shifts relative to the window (s − k0·δ).
        tau_v, scale: (B,) dust depth / observed-frame scalar
            (1+z)·1e-6/(4π d19²).
        sed_w: (C, W) window spectra with dλ/λ folded in, float32.
        curve_w: (W,) dust curve k_λ/R_V on the window.
        knot_w: (W, kc·F8) IGM-baked knot-matrix window; bfloat16 on a card.
        den_w: (kc, F8) exact denominator knots of the window.

    CPU tensors go through `fused_window_photometry_reference`. CUDA tensors
    launch the kernel on the current stream; inputs the kernel does not take
    raise ValueError, a failed launch raises RuntimeError. Each launch adds
    one to `fused_window_photometry.launches`.
    """
    if sfzh.device.type == "cpu":
        return fused_window_photometry_reference(
            sfzh, s_rel, tau_v, scale, sed_w, curve_w, knot_w, den_w, kc,
            delta, f8, order=order, fesc=fesc)
    _require(sfzh.device.type == "cuda",
             f"tensors on {sfzh.device} are neither CPU nor CUDA")
    _check_cuda_inputs(sfzh, s_rel, tau_v, scale, sed_w, curve_w, knot_w,
                       den_w, kc, delta, f8, order)
    from ._cuda import load_library

    lib = load_library()
    b, c = sfzh.shape
    w = sed_w.shape[1]
    kf = kc * f8
    _require(lib.k1_smem_bytes(kf) <= _MAX_SMEM,
             f"kc·F8 = {kf} knot columns exceed the kernel's shared memory")
    # split the window over blockIdx.y so a 1024-galaxy sub-chunk still puts
    # about two blocks on every SM
    n_tiles = math.ceil(b / lib.k1_tile_galaxies())
    n_chunks = math.ceil(w / lib.k1_chunk_columns())
    sms = torch.cuda.get_device_properties(sfzh.device).multi_processor_count
    n_split = max(1, min(n_chunks, math.ceil(2 * sms / n_tiles)))
    partial = torch.empty((n_split, b, kf), dtype=torch.float32,
                          device=sfzh.device)
    out = torch.empty((b, f8), dtype=torch.float32, device=sfzh.device)
    stream = torch.cuda.current_stream(sfzh.device).cuda_stream
    err = lib.k1_fused_window(
        sfzh.data_ptr(), sfzh.stride(0), s_rel.data_ptr(), tau_v.data_ptr(),
        scale.data_ptr(), sed_w.data_ptr(), sed_w.stride(0),
        curve_w.data_ptr(), knot_w.data_ptr(), knot_w.stride(0),
        den_w.data_ptr(), den_w.stride(0), partial.data_ptr(),
        out.data_ptr(), b, c, w, kc, f8, delta, order, float(fesc), n_split,
        stream)
    if err:
        raise RuntimeError(
            f"K1 launch failed: {lib.k1_error_string(err).decode()}")
    fused_window_photometry.launches += 1
    return out


fused_window_photometry.launches = 0


def fused_sed_photometry_reference(sfzh, s, tau_v, scale, tables: dict,
                                   n_knots: int, delta: int, f8: int,
                                   order: int = 3, fesc: float = 0.0):
    """Plain PyTorch K2: K1's plain version over the whole tables
    (kc = n_knots, shifts relative to knot 0)."""
    return fused_window_photometry_reference(
        sfzh, s, tau_v, scale, tables["sed"], tables["curve"],
        tables["knot"], tables["den"], n_knots, delta, f8, order=order,
        fesc=fesc)


def fused_sed_photometry(sfzh, s, tau_v, scale, tables: dict, n_knots: int,
                         delta: int, f8: int, order: int = 3,
                         fesc: float = 0.0):
    """SED → (B, F8) band fluxes over the whole λ support and knot table,
    one kernel per call, for galaxies in any redshift order.

    Args:
        sfzh: (B, C) SFZH mass weights [Msun], float32.
        s: (B,) real column shifts log10(1+z)/Δ.
        tau_v, scale: (B,) dust depth / observed-frame scalar
            (1+z)·1e-6/(4π d19²).
        tables: `prepare_megakernel_tables` output: "sed" (C, L), "curve"
            (L,), "knot" (L, n_knots·F8) bfloat16, "den" (n_knots, F8).

    CPU tensors go through `fused_sed_photometry_reference`. CUDA tensors
    launch the kernel (`csrc/fused_sed.cu`) on the current stream; inputs it
    does not take raise ValueError, a failed launch RuntimeError. Each
    launch adds one to `fused_sed_photometry.launches`.
    """
    if sfzh.device.type == "cpu":
        return fused_sed_photometry_reference(
            sfzh, s, tau_v, scale, tables, n_knots, delta, f8, order=order,
            fesc=fesc)
    who = "fused_sed_photometry"
    _require(sfzh.device.type == "cuda",
             f"tensors on {sfzh.device} are neither CPU nor CUDA", who)
    sed, curve, knot, den = (tables[k] for k in ("sed", "curve", "knot",
                                                 "den"))
    _check_cuda_inputs(sfzh, s, tau_v, scale, sed, curve, knot, den,
                       n_knots, delta, f8, order, who=who)
    _require(n_knots >= FUSED_SED_MIN_KNOTS,
             f"needs at least {FUSED_SED_MIN_KNOTS} knots, got {n_knots}",
             who)
    # the kernel loads knot columns in aligned bf16 pairs
    _require(f8 % 2 == 0 and knot.stride(0) % 2 == 0
             and knot.data_ptr() % 4 == 0,
             "needs an even f8 and an even, 4-byte-aligned knot row", who)
    from ._cuda import load_library

    lib = load_library()
    _require(lib.k2_smem_bytes(f8) <= _MAX_SMEM,
             f"F8 = {f8} bands exceed the kernel's shared memory", who)
    b, c = sfzh.shape
    out = torch.empty((b, f8), dtype=torch.float32, device=sfzh.device)
    stream = torch.cuda.current_stream(sfzh.device).cuda_stream
    err = lib.k2_fused_sed(
        sfzh.data_ptr(), sfzh.stride(0), s.data_ptr(), tau_v.data_ptr(),
        scale.data_ptr(), sed.data_ptr(), sed.stride(0), curve.data_ptr(),
        knot.data_ptr(), knot.stride(0), den.data_ptr(), den.stride(0),
        out.data_ptr(), b, c, sed.shape[1], n_knots, f8, delta, order,
        float(fesc), stream)
    if err:
        raise RuntimeError(
            f"K2 launch failed: {lib.k1_error_string(err).decode()}")
    fused_sed_photometry.launches += 1
    return out


fused_sed_photometry.launches = 0
