"""Plain spectroscopic reference: θ → instrument-grid spectral features and
band photometry [nJy], for the spectroscopic library cell.

A frozen, plain-PyTorch statement of what a spectroscopic library row is
(upstream synference `sbi_runner.py:1180-1428`, `utils.py:185-289`):

1. the SFZH of `forward.ForwardModel.sfzh` (lognormal SFH, delta Z);
2. two full-grid contractions, SFZH × incident and SFZH × total spectra,
   taken by `first_product` (exact: float64, rounded once to float32);
3. L_ν = fesc·incident + (1 − fesc)·total·exp(−τ_V k(λ)), Calzetti 2000;
4. the Inoue 2014 IGM at the galaxy's own redshift and the flat-ΛCDM
   distance: f_ν [nJy] = L_ν·T_IGM(λ_rest(1+z), z)·(1+z)·1e-6 / (4π d²)
   with d in 1e19 cm, on the rest grid;
5. a Gaussian LSF from the model's resolution to the instrument's:
   σ_pix = √(1/R² − 1/R_model²)·FWHM→σ / ln(1 + 0.5/R_grid), taps to
   ±ceil(4σ), normalised, zero-padded "same" convolution along the rest
   grid (a constant shift in log λ: one kernel for every row);
6. linear interpolation at the instrument grid (constant R from the
   configuration's start to end, λ_{i+1} = λ_i(1 + 0.5/R)) of the smoothed
   row placed at λ_rest(1+z), zero outside it;
7. division by the mean over the norm window's pixels, with log10 |norm|
   appended.

Band fluxes follow the definition of the spectra path: the observed f_ν
(step 4, IGM at the galaxy's redshift already in it) times dλ/λ and the
plain band curves at integer-column knot shifts (no IGM in them), both
operands rounded to bfloat16 and summed exactly, numerator and
denominator interpolated between knots by `forward._cubic`.
`forward.ForwardModel.photometry` instead folds the IGM of each knot's
redshift into the knot matrix and rounds the rest-frame L_ν·dust·dλ/λ.
Measured at the north-star bands and prior (2048 rows, float64 knot
products in both definitions): the IGM placement changes F090W's fluxes
by up to 8.0e-5 (p99 5.7e-5) where Lyα(1+z) falls blue of the band's red
edge (z > 5.6), and every other flux by less than 3.5e-7 (float32
rounding). With the bf16 operands of each definition the two differ by a
median of 9.6e-5 and a p99 of 4.4e-4 (512 rows): the rounding of two
operands that differ by a per-row scale. Both packages share the spectra
path's definition; this reference follows it.

Tables the model defines (built here from the published formulas; nothing
is read from the program under test, nothing of it is imported):
- the IGM as 512 rows of T(λ_rest, z_k) at 1 + z_k = 10^(k·Δ), Δ =
  log10(1 + z_max)/510, float32, lerped in log10(1+z) (the rows from
  `forward._igm_inoue14`, Inoue et al. 2014);
- the distance and age tables of `forward.ForwardModel` (2048-knot lerps
  over log(1+z) of a Gauss-Legendre quadrature).

Precision: the contractions as `first_product` gives them (float32
results), every later step in float64. Departures from the published
description: the knots of the band integral are the model's, as above;
the instrument's resolution is a constant R (NIRSpec PRISM's R(λ) runs
~30-300); the model's own resolution is taken as ten times the grid's
when the configuration gives none, as the model's pipeline does; the taps
are not capped at 64 a side (the model's cap does not bind at these
widths). `lsf_scale` and `dz` plant faults: a wider LSF, and a redshift
off by `dz` where the smoothed row is placed on the instrument grid.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.forward import (FOUR_PI, ForwardModel, _calzetti,
                                         _cubic, _igm_inoue14, _interp_f32,
                                         _uniform_lerp, exact_first_product)

FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))
IGM_ROWS = 512


def constant_r_grid(r: float, start: float, end: float) -> np.ndarray:
    """Instrument wavelengths [Å], float64: λ_{i+1} = λ_i (1 + 0.5/R) from
    `start` until `end` is passed."""
    n = int(np.ceil(np.log(end / start) / np.log(1.0 + 0.5 / r))) + 1
    return start * (1.0 + 0.5 / r) ** np.arange(n)


def lsf_taps(r_inst: float, r_model: float, grid_r: float,
             trunc: float = 4.0, scale: float = 1.0) -> np.ndarray:
    """The normalised Gaussian taps (float64) that degrade a constant-
    `grid_r` log-λ grid from `r_model` to `r_inst`; `scale` widens σ."""
    sigma = (np.sqrt(1.0 / r_inst ** 2 - 1.0 / r_model ** 2) * FWHM_TO_SIGMA
             / np.log(1.0 + 0.5 / grid_r)) * scale
    half = max(int(np.ceil(trunc * sigma)), 1)
    x = np.arange(-half, half + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def convolve_same(rows, taps):
    """(B, L) rows convolved with odd-length taps, zero-padded, "same"
    size, in the rows' dtype."""
    half = (taps.shape[0] - 1) // 2
    pad = torch.nn.functional.pad(rows, (half, half))
    n = rows.shape[1]
    out = torch.zeros_like(rows)
    for j in range(taps.shape[0]):
        out += taps[j] * pad[:, 2 * half - j:2 * half - j + n]
    return out


def interp_rows(x, xp, fp):
    """Row-wise linear interpolation: x (M,) queries, xp (B, N) increasing,
    fp (B, N); zero outside each row's [xp0, xp-1]."""
    b, n = xp.shape
    xq = x.expand(b, -1).contiguous()
    i = torch.clamp(torch.searchsorted(xp, xq, right=True), 1, n - 1)
    x0, x1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    f0, f1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    f = f0 + (xq - x0) / (x1 - x0) * (f1 - f0)
    return torch.where((xq < xp[:, :1]) | (xq > xp[:, -1:]), 0.0, f)


class SpectraModel:
    """The model's tables on `device` from the benchmark's grid arrays
    (`inputs.make_grid`), filter curves (`inputs.make_filters`), the
    configuration's "model" and "spectra" blocks; `spectra(θ)`.

    `spectra` holds "instrument_r", "lam_min", "lam_max" (the instrument
    grid, Å), "norm_window" [lo, hi] (Å, observed) and "model_r" (None:
    ten times the grid's R)."""

    def __init__(self, grid: dict, filters: list, model: dict,
                 spectra: dict, device):
        dev = self.device = torch.device(device)
        f32, f64 = torch.float32, torch.float64
        fwd = self.fwd = ForwardModel(grid, filters, model, device)
        self.param_names = fwd.param_names
        self.n_f = fwd.n_f
        self.fesc = float(model.get("fesc", 0.0))
        lam = np.asarray(grid["lam"], np.float64)
        n_wav = lam.shape[0]
        self.lam = torch.as_tensor(lam, device=dev)
        lam32 = torch.as_tensor(lam.astype(np.float32), device=dev)
        self.incident = torch.as_tensor(grid["incident"],
                                        device=dev).reshape(-1, n_wav)
        self.total = torch.as_tensor(grid["total"],
                                     device=dev).reshape(-1, n_wav)
        self.curve = _calzetti(lam32).to(f64)
        self.wlam = torch.as_tensor((np.gradient(lam) / lam).astype(
            np.float32), device=dev).to(f64)

        # IGM: T(λ_rest, z_k) rows over log10(1+z), float32
        z_max = float(model["z_max"])
        self.igm_dlog = float(np.log10(1.0 + z_max) / (IGM_ROWS - 2))
        z_rows = 10.0 ** (self.igm_dlog * torch.arange(
            IGM_ROWS, dtype=f32, device=dev)) - 1.0
        step = max(1, (1 << 24) // (39 * n_wav))
        self.igm = torch.cat([
            _igm_inoue14(lam32[None, :] * (1.0 + z_rows[i:i + step, None]),
                         z_rows[i:i + step, None])
            for i in range(0, IGM_ROWS, step)])

        # the plain knot matrix (L_sup, K, F8): band curves at the knots'
        # shifted float32 wavelengths, no IGM, rounded to bf16
        l0, l1 = fwd.support
        lam0 = torch.tensor(float(lam[0]), dtype=f32, device=dev)
        dlog32 = torch.tensor(fwd.dlog, dtype=f32, device=dev)
        l_idx = torch.arange(l0, l1, dtype=f32, device=dev)
        shifts = torch.arange(fwd.n_knots, dtype=f32, device=dev) * fwd.delta
        lam_eval = (lam0 * 10.0 ** ((l_idx[None, :] + shifts[:, None])
                                    * dlog32)).reshape(-1)
        knot = torch.zeros(fwd.n_knots, fwd.f8, l1 - l0, dtype=f32,
                           device=dev)
        for i, (_, fl, ft) in enumerate(filters):
            xp = torch.as_tensor(np.asarray(fl, np.float32), device=dev)
            fp = torch.as_tensor(np.asarray(ft, np.float32), device=dev)
            knot[:, i] = _interp_f32(lam_eval, xp, fp).reshape(
                fwd.n_knots, -1)
        self.knot = knot.permute(2, 0, 1).to(torch.bfloat16).contiguous()

        # the instrument: LSF taps, grid and norm window
        self.grid_r = float(0.5 / np.expm1(np.mean(np.diff(np.log(lam)))))
        model_r = spectra.get("model_r") or 10.0 * self.grid_r
        self.r_inst, self.r_model = float(spectra["instrument_r"]), model_r
        self.obs_lam = torch.as_tensor(constant_r_grid(
            self.r_inst, spectra["lam_min"], spectra["lam_max"]), device=dev)
        lo, hi = spectra["norm_window"]
        self.norm_mask = (self.obs_lam >= lo) & (self.obs_lam <= hi)

    def _col(self, theta, name):
        return theta[:, self.param_names.index(name)].contiguous()

    def observed_fnu(self, theta, first_product=exact_first_product):
        """(B, L) float64 observed f_ν [nJy] on the rest grid."""
        fwd = self.fwd
        z = self._col(theta, "redshift")
        sfzh = fwd.sfzh(theta)
        inc = first_product(sfzh, self.incident).double()
        tot = first_product(sfzh, self.total).double()
        tau_v = self._col(theta, "tau_v").double()[:, None]
        lnu = (self.fesc * inc
               + (1.0 - self.fesc) * tot * torch.exp(-tau_v * self.curve))
        s = torch.log10(torch.clamp(1.0 + z, min=1.0)) / self.igm_dlog
        k = torch.clamp(torch.floor(s).to(torch.int64), 0, IGM_ROWS - 2)
        frac = (s - k.to(s.dtype)).double()[:, None]
        t_igm = (self.igm[k].double() * (1.0 - frac)
                 + self.igm[k + 1].double() * frac)
        d19 = _uniform_lerp(fwd.d19_table, fwd.d19_x0, fwd.d19_dx,
                            torch.log1p(torch.clamp(z, min=1.0e-4))).double()
        scale = (1.0 + z.double()) * (1.0e-6 / FOUR_PI) / (d19 * d19)
        return lnu * t_igm * scale[:, None]

    def features(self, fnu, z, lsf_scale: float = 1.0, dz: float = 0.0):
        """(B, L) observed f_ν + (B,) z -> (B, M + 1) float64: the
        normalised instrument pixels and log10 |norm|."""
        taps = torch.as_tensor(lsf_taps(self.r_inst, self.r_model,
                                        self.grid_r, scale=lsf_scale),
                               device=fnu.device)
        smoothed = convolve_same(fnu, taps)
        lam_obs = self.lam[None, :] * (1.0 + z.double() + dz)[:, None]
        out = interp_rows(self.obs_lam, lam_obs, smoothed)
        norm = out[:, self.norm_mask].mean(dim=1)
        norm = torch.where(norm == 0, 1.0, norm)
        return torch.cat([out / norm[:, None],
                          torch.log10(torch.abs(norm))[:, None]], dim=1)

    def band_fluxes(self, fnu, z):
        """(B, L) observed f_ν + (B,) z -> (B, F) [nJy] by the spectra
        path's definition (module docstring)."""
        fwd = self.fwd
        l0, l1 = fwd.support
        fw = (fnu[:, l0:l1] * self.wlam[l0:l1]).to(torch.bfloat16).double()
        s = torch.log10(1.0 + torch.clamp(z, min=0.0)) / fwd.dlog
        n_k, d = fwd.n_knots, fwd.delta
        c = torch.clamp(s, 0.0, (n_k - 1) * d - 1.0e-3) / d
        k = torch.clamp(torch.floor(c).to(torch.int64), 0, n_k - 2)
        t = (c - k.to(c.dtype))[:, None]
        knots = torch.stack([torch.clamp(k - 1, min=0), k, k + 1,
                             torch.clamp(k + 2, max=n_k - 1)], dim=1)
        num = torch.empty(fnu.shape[0], 4, fwd.f8, dtype=torch.float32,
                          device=fnu.device)
        for kk in torch.unique(k).tolist():
            rows = torch.nonzero(k == kk)[:, 0]
            cols = self.knot[:, knots[rows[0]]].reshape(self.knot.shape[0],
                                                        -1)
            num[rows] = (fw[rows] @ cols.double()).float().reshape(
                -1, 4, fwd.f8)
        den = fwd.den[knots]
        ratio = (_cubic(*num.unbind(1), k, t, n_k)
                 / torch.clamp(_cubic(*den.unbind(1), k, t, n_k), min=1e-30))
        return ratio[:, :self.n_f]

    def spectra(self, theta, first_product=exact_first_product,
                block: int = 512, lsf_scale: float = 1.0, dz: float = 0.0):
        """(B, P) float32 θ on the model's device -> ((B, M + 1) features,
        (B, F) band fluxes), float64 on the host, in blocks of `block`
        rows."""
        feats, fluxes = [], []
        for i in range(0, theta.shape[0], block):
            th = theta[i:i + block]
            z = self._col(th, "redshift")
            fnu = self.observed_fnu(th, first_product)
            feats.append(self.features(fnu, z, lsf_scale, dz).cpu())
            fluxes.append(self.band_fluxes(fnu, z).double().cpu())
        return torch.cat(feats), torch.cat(fluxes)
