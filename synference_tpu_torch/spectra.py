"""Spectral feature path: redshift, LSF matching and resampling, batched.

Counterpart of `synference_tpu/spectra.py`. Spectra live on log-uniform
(constant-R) wavelength grids, where a redshift is a constant shift and
matching a constant-R instrument LSF is one shift-invariant Gaussian
convolution in log-λ. For a wavelength-dependent resolution curve R(λ) a
bank of fixed-width Gaussians is applied and each pixel mixes the two bank
members around its target width.

Everything is batched on the tensors' device: where the JAX package vmaps
`jnp.interp` over galaxies, `_interp_rows` does one batched searchsorted and
gather with `jnp.interp`'s bracketing and arithmetic. The Gaussian
convolutions are `conv1d` with TF32 off (cuDNN would otherwise round fp32
inputs to TF32 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .runtime import span, traced

__all__ = [
    "generate_constant_r_grid",
    "resample_spectrum",
    "resample_spectrum_conserve",
    "match_resolution_constant_r",
    "match_resolution_curve",
    "SpectralFeaturePipeline",
]

_FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))


def generate_constant_r_grid(r: float = 300.0, start: float = 3000.0,
                             end: float = 55000.0) -> np.ndarray:
    """Constant-R wavelength grid [Å]: λ_{i+1} = λ_i (1 + 0.5/R)."""
    n = int(np.ceil(np.log(end / start) / np.log(1.0 + 0.5 / r))) + 1
    return start * (1.0 + 0.5 / r) ** np.arange(n)


def _interp_rows(x, xp, fp, left=0.0, right=0.0):
    """`jnp.interp(x, xp_b, fp_b, left, right)` for every row b: x (B, M)
    or (M,) queries, xp (B, N) increasing knots or (N,) shared, fp (B, N);
    `left`/`right` a number or None (clamp to fp's end value)."""
    b = fp.shape[0]
    xp = xp.expand(b, -1) if xp.ndim == 1 else xp
    x = x.expand(b, -1) if x.ndim == 1 else x
    n = xp.shape[1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, n - 1)
    x_lo, x_hi = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    f_lo, f_hi = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    dx = x_hi - x_lo
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f_lo,
                    f_lo + ((x - x_lo) / torch.where(dx0, 1.0, dx))
                    * (f_hi - f_lo))
    f = torch.where(x < xp[:, :1], fp[:, :1] if left is None else left, f)
    return torch.where(x > xp[:, -1:], fp[:, -1:] if right is None else right,
                       f)


def _rows(a):
    """float32 tensor of `a`, and whether it is one row (1-D)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    return a, a.ndim == 1


def resample_spectrum(new_lam, lam, flux):
    """Linear-interpolation resampling of flux (B, L) or (L,) on `lam` ((L,)
    or per row (B, L)) onto `new_lam`, zero outside `lam`."""
    flux, squeeze = _rows(flux)
    dev = flux.device
    out = _interp_rows(torch.as_tensor(new_lam, dtype=torch.float32,
                                       device=dev),
                       torch.as_tensor(lam, dtype=torch.float32, device=dev),
                       torch.atleast_2d(flux))
    return out[0] if squeeze else out


def _bin_edges(lam):
    """Pixel-midpoint bin edges of (..., L) grids (the spectres convention)."""
    mid = 0.5 * (lam[..., 1:] + lam[..., :-1])
    first = lam[..., :1] - (mid[..., :1] - lam[..., :1])
    last = lam[..., -1:] + (lam[..., -1:] - mid[..., -1:])
    return torch.cat([first, mid, last], dim=-1)


def resample_spectrum_conserve(new_lam, lam, flux):
    """Flux-conserving resampling (spectres semantics): both grids are pixel
    bins and each output bin averages the overlapping input flux. The
    cumulative integral C(λ) = ∫f dλ of a piecewise-constant f is piecewise
    linear, so interpolating C at the output edges is exact:
    out_j = (C(e_{j+1}) − C(e_j)) / w_j; bins outside the input get zero.

    The cumulative integral and its differences are taken in float64: in
    float32 (the JAX package's) a narrow output bin loses the digits of C
    that its flux lives in (≈3e-3 relative error on an R = 100 grid)."""
    flux, squeeze = _rows(flux)
    flux = torch.atleast_2d(flux)
    dev, f64 = flux.device, torch.float64
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev).to(f64)
    e_in = _bin_edges(lam)
    w_in = torch.diff(e_in, dim=-1)
    e_out = _bin_edges(torch.as_tensor(new_lam, dtype=torch.float32,
                                       device=dev).to(f64))
    c = torch.cat([torch.zeros_like(flux[:, :1], dtype=f64),
                   torch.cumsum(flux.to(f64) * w_in, dim=-1)], dim=-1)
    ce = _interp_rows(e_out, e_in, c, left=None, right=None)
    out = (torch.diff(ce, dim=-1) / torch.diff(e_out, dim=-1)).float()
    return out[0] if squeeze else out


def _gaussian_kernel(sigma_pix: float, trunc: float = 4.0,
                     max_half: int = 64) -> np.ndarray:
    half = int(min(max(np.ceil(trunc * sigma_pix), 1), max_half))
    x = np.arange(-half, half + 1)
    k = np.exp(-0.5 * (x / max(sigma_pix, 1e-6)) ** 2)
    return k / k.sum()


def _convolve_same(flux, kern: np.ndarray):
    """(B, L) rows convolved with a symmetric odd-length kernel, "same"
    size (`jnp.convolve(..., mode="same")`), in fp32 with TF32 off."""
    k = torch.as_tensor(kern, dtype=torch.float32, device=flux.device)
    half = (k.shape[0] - 1) // 2
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=False, deterministic=False,
                                    allow_tf32=False):
        out = torch.nn.functional.conv1d(flux[:, None, :],
                                         k.flip(0)[None, None, :],
                                         padding=half)
    return out[:, 0, :]


def match_resolution_constant_r(flux, r_in: float, r_out: float,
                                grid_r: float, trunc: float = 4.0):
    """Degrade (B, L) or (L,) spectra on a constant-`grid_r` log-λ grid from
    resolution r_in to r_out: one Gaussian of σ_pix = sqrt(1/r_out² −
    1/r_in²)·FWHM→σ / ln(1 + 0.5/grid_r)."""
    flux, squeeze = _rows(flux)
    if r_out >= r_in:
        return flux
    dv = np.sqrt(1.0 / r_out**2 - 1.0 / r_in**2) * _FWHM_TO_SIGMA
    sigma_pix = dv / np.log(1.0 + 0.5 / grid_r)
    out = _convolve_same(torch.atleast_2d(flux),
                         _gaussian_kernel(sigma_pix, trunc))
    return out[0] if squeeze else out


def match_resolution_curve(flux, lam, r_in: float, r_curve_lam, r_curve_r,
                           grid_r: float, n_kernels: int = 8,
                           trunc: float = 4.0):
    """Degrade to a wavelength-dependent resolution curve R(λ): a bank of
    `n_kernels` Gaussians spanning the needed widths; each pixel mixes the
    two members bracketing its target σ linearly.

    flux (B, L) or (L,) on the constant-`grid_r` grid `lam` (L,); the
    instrument curve is sampled at `r_curve_lam` with values `r_curve_r`.
    """
    lam = np.asarray(lam)
    r_out = np.minimum(np.interp(lam, np.asarray(r_curve_lam),
                                 np.asarray(r_curve_r)), r_in * 0.999)
    dv = np.sqrt(1.0 / r_out**2 - 1.0 / r_in**2) * _FWHM_TO_SIGMA
    sigma_pix = dv / np.log(1.0 + 0.5 / grid_r)
    bank = np.linspace(max(float(sigma_pix.min()), 1e-3),
                       max(float(sigma_pix.max()), 2e-3), n_kernels)
    flux, squeeze = _rows(flux)
    flux2 = torch.atleast_2d(flux)
    convs = torch.stack([_convolve_same(flux2, _gaussian_kernel(s, trunc))
                         for s in bank])  # (K, B, L)
    idx = np.clip(np.searchsorted(bank, sigma_pix) - 1, 0, n_kernels - 2)
    frac = np.clip((sigma_pix - bank[idx])
                   / np.maximum(bank[idx + 1] - bank[idx], 1e-12), 0.0, 1.0)
    dev = flux.device
    cols = torch.arange(lam.shape[0], device=dev)
    idx_t = torch.as_tensor(idx, device=dev)
    frac_t = torch.as_tensor(frac, dtype=torch.float32, device=dev)
    lo = convs[idx_t, :, cols].T  # (B, L)
    hi = convs[idx_t + 1, :, cols].T
    out = lo * (1.0 - frac_t) + hi * frac_t
    return out[0] if squeeze else out


class SpectralFeaturePipeline:
    """Batched rest-frame f_ν spectra -> instrument-frame feature vectors:
    LSF match, redshift and resampling onto the instrument grid, optional
    normalisation.

    Args:
        rest_lam: (L,) log-uniform rest wavelengths of the input spectra.
        obs_lam: (L_out,) instrument wavelength grid [Å, observed frame].
        instrument_r: instrument resolving power (constant R).
        model_r: intrinsic resolution of the model spectra (default ten
            times the grid's).
        norm_window: optional (lo, hi) Å observed-frame window whose mean
            flux divides the spectrum; log10 |norm| is appended.
        flux_conserving: resample with `resample_spectrum_conserve` instead
            of linear interpolation.
        device: where the grids live and the batches run.
    """

    def __init__(self, rest_lam, obs_lam, instrument_r: float = 100.0,
                 model_r: float | None = None,
                 norm_window: tuple | None = None,
                 flux_conserving: bool = False, *, device):
        rest_lam = np.asarray(rest_lam)
        ratios = np.diff(np.log(rest_lam))
        if not np.allclose(ratios, ratios[0], rtol=1e-3):
            raise ValueError("rest_lam must be log-uniform")
        self.device = torch.device(device)
        self.rest_lam = torch.as_tensor(rest_lam.astype(np.float32),
                                        device=self.device)
        self.obs_lam = torch.as_tensor(np.asarray(obs_lam, np.float32),
                                       device=self.device)
        self.grid_r = float(0.5 / np.expm1(ratios[0]))
        self.instrument_r = float(instrument_r)
        self.model_r = float(model_r) if model_r else 10.0 * self.grid_r
        self.norm_window = norm_window
        self.flux_conserving = bool(flux_conserving)
        if norm_window is not None:
            lo, hi = norm_window
            self._norm_mask = ((self.obs_lam >= lo)
                               & (self.obs_lam <= hi)).float()

    @traced("spectra.pipeline")
    def __call__(self, fnu, z):
        """(B, L) rest-frame f_ν + (B,) redshifts -> (B, L_out [+1])."""
        fnu = torch.atleast_2d(torch.as_tensor(fnu, dtype=torch.float32,
                                               device=self.device))
        z = torch.atleast_1d(torch.as_tensor(z, dtype=torch.float32,
                                             device=self.device))
        with span("spectra.lsf"):
            smoothed = match_resolution_constant_r(
                fnu, self.model_r, self.instrument_r, self.grid_r)
        with span("spectra.resample"):
            lam_obs = self.rest_lam[None, :] * (1.0 + z[:, None])  # (B, L)
            if self.flux_conserving:
                out = resample_spectrum_conserve(self.obs_lam, lam_obs,
                                                 smoothed)
            else:
                out = _interp_rows(self.obs_lam, lam_obs, smoothed)
        if self.norm_window is not None:
            m = self._norm_mask
            norm = (out * m).sum(-1) / torch.clamp(m.sum(), min=1.0)
            norm = torch.where(norm == 0, 1.0, norm)
            out = torch.cat([out / norm[:, None],
                             torch.log10(torch.abs(norm))[:, None]], dim=1)
        return out
