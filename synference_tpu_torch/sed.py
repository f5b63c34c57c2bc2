"""The batched SED simulator — θ → band photometry through the window engine.

Counterpart of `synference_tpu/sed.py` for the mock-library path:

    θ (B, P) ──SFH/ZDist weights──► SFZH (B, A·Z)
             ──z-sorted window engine──► photometry (B, F)

The window engine (`photometry_zsorted_device`) takes θ rows sorted by
redshift. Each sub-chunk of consecutive rows spans a narrow redshift range,
so it needs only a window of W rest-frame λ columns and kc knots of the
IGM-baked knot matrix: the contraction SFZH ⊗ spectra, the dust screen, the
bf16 knot product, the monotone-cubic shift interpolation and the num/den
ratio run over that window. Two bodies compute it: the fused body, one K1
kernel per sub-chunk (`ops/fused_sed.py`), and the staged body in plain
torch.

This is the only photometry engine the package has. What the JAX simulator
does besides — the dense `photometry()`, spectra, the `conv`/`bank`/`roll`
variants, particle SFZHs, dust emission, birth-cloud dust — raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cosmology import PLANCK18, Cosmology
from .dust import attenuation_curve
from .filters import FilterSet
from .grids import SPSGrid
from .igm import igm_transmission
from .ops.fused_sed import fused_window_photometry, knot_product, window_ratio
from .ops.photometry_kernel import (KNOT_INTERP_ORDER, N_SUB, build_den_table,
                                    build_knot_matrix_device)
from .sfh import make_age_sampling, sfh_weights, zdist_weights

__all__ = ["EmissionConfig", "BatchSEDSimulator"]

_FOUR_PI = 4.0 * np.pi
_IGM_CHUNK = 16  # redshift rows per IGM evaluation (bounds the (K, L, 39) temporaries)


@dataclass(frozen=True)
class EmissionConfig:
    """Static emission-model configuration: the JAX package's fields that
    the window engine reads (the birth-cloud and dust-emission ones only to
    refuse them).

    lnu = fesc · incident + (1 − fesc) · Σ reprocessed, the reprocessed part
    behind one dust screen exp(−τ_V k_λ); `igm` names the IGM model.
    """

    incident_type: str = "incident"
    reprocessed_types: tuple = ()
    fesc: float | str = 0.0
    dust_law: str = "calzetti2000"
    dust_params: tuple = ()  # tuple of (key, value) pairs; hashability
    tau_v_param: str | None = "tau_v"
    tau_v_bc_param: str | None = None
    dust_emission: bool = False
    igm: str = "inoue14"

    def dust_params_dict(self) -> dict:
        return dict(self.dust_params)


class BatchSEDSimulator:
    """θ → photometry forward model over z-sorted galaxy batches.

    Args:
        grid, filters, param_names, sfh, zdist, emission, cosmology,
        fixed_params, n_age_sub, z_max: as in the JAX package.
        photometry_variant: "interp" (the knot engine; the others are not
            ported yet).
        photometry_knot_delta: knot spacing in λ columns; None = constant
            ~0.009 dex physical spacing.
        photometry_interp_order: 1 (lerp) or 3 (monotone cubic, default).
        device: where every table lives and every batch runs. Required.
    """

    STATE_KEYS = ("t_mix", "m_igm", "den_knots", "dust_curve_sup",
                  "wlam_sup", "age_table", "d19_table")

    def __init__(
        self,
        grid: SPSGrid,
        filters: FilterSet,
        param_names: tuple,
        sfh: str = "lognormal",
        zdist: str = "delta",
        emission: EmissionConfig | None = None,
        cosmology: Cosmology = PLANCK18,
        fixed_params: dict | None = None,
        n_age_sub: int = 4,
        z_max: float = 25.0,
        photometry_variant: str = "interp",
        photometry_knot_delta: int | None = None,
        photometry_interp_order: int | None = None,
        *,
        device,
    ):
        if photometry_variant != "interp":
            raise NotImplementedError(
                f"photometry_variant={photometry_variant!r} is not ported yet "
                "(ROADMAP M9 and queue 2 K3/K4); the port runs the knot "
                "engine, 'interp'")
        if not grid.is_log_uniform:
            grid = grid.resampled_loglam()
        dev = torch.device(device)
        self.device = dev
        self.grid = grid
        self.filters = filters
        self.param_names = tuple(param_names)
        self.sfh_name = sfh
        self.zdist_name = zdist
        self.emission = emission or EmissionConfig()
        self.cosmology = cosmology
        self.fixed_params = dict(fixed_params or {})
        f32 = torch.float32

        self._sampling = make_age_sampling(grid.age_bin_edges_yr, dev, n_age_sub)
        # age(z) and d_L(z) as 2048-knot lerp tables over log(1+z); the d_L
        # grid starts at the z clamp (1e-4) so no knot sits below it
        zg = np.expm1(np.linspace(0.0, np.log1p(z_max), 2048))
        self._cosmo_dl1p = float(np.log1p(z_max) / 2047.0)
        self._age_table = cosmology.age_yr(
            torch.as_tensor(zg, dtype=f32, device=dev))
        zg_d = np.expm1(np.linspace(np.log1p(1.0e-4), np.log1p(z_max), 2048))
        self._d19_x0 = float(np.log1p(1.0e-4))
        self._d19_dl1p = float((np.log1p(z_max) - np.log1p(1.0e-4)) / 2047.0)
        # distances in 1e19 cm keep d² inside fp32 range
        self._d19_table = cosmology.luminosity_distance_cm(
            torch.as_tensor(zg_d, dtype=f32, device=dev)) * 1.0e-19
        self._log10_mets = torch.as_tensor(
            grid.log10_metallicities.astype(np.float32), device=dev)
        self._extra_axes = []
        for ax_name, ax_vals in grid.extra_axes.items():
            if (ax_name not in self.param_names
                    and ax_name not in self.fixed_params
                    and f"log10_{ax_name}" not in self.param_names
                    and f"log10_{ax_name}" not in self.fixed_params):
                raise ValueError(
                    f"grid axis {ax_name!r} has no θ or fixed parameter; "
                    "fix it at load with grid.fix_axes({...}) or add it to "
                    "param_names/fixed_params")
            self._extra_axes.append((ax_name, torch.as_tensor(
                np.asarray(ax_vals, np.float32), device=dev)))
        lam = grid.lam
        self._lam = torch.as_tensor(lam.astype(np.float32), device=dev)
        # integration weights dλ/λ on the rest grid (photon-count convention)
        wlam = (np.gradient(lam) / lam).astype(np.float32)
        em = self.emission
        dust_curve = attenuation_curve(em.dust_law, self._lam,
                                       em.dust_params_dict())

        _, dlog, max_shift = filters.shifted_table(lam, z_max=z_max)
        self._filter_dlog = float(dlog)
        self._max_shift = int(max_shift)
        self._igm_model = None if em.igm in (None, "none") else em.igm

        self._knot_delta = (max(1, round(0.009 / self._filter_dlog))
                            if photometry_knot_delta is None
                            else int(photometry_knot_delta))
        self._interp_order = (KNOT_INTERP_ORDER if photometry_interp_order
                              is None else int(photometry_interp_order))
        # λ-support trimming: rest columns no filter reaches at any knot
        # shift contribute nothing to any numerator
        lam0 = float(lam[0])
        n_knots_est = int(self._max_shift // self._knot_delta) + 2
        f_lo = min(float(np.min(f.lam)) for f in filters.filters)
        f_hi = max(float(np.max(f.lam)) for f in filters.filters)
        m0 = int(np.floor(np.log10(f_lo / lam0) / self._filter_dlog)) - 1
        m1 = int(np.ceil(np.log10(f_hi / lam0) / self._filter_dlog)) + 2
        l_lo = max(0, m0 - (n_knots_est - 1) * self._knot_delta)
        l_hi = int(np.clip(m1, l_lo + 1, grid.n_wav))
        self._lam_support = (None if (l_lo, l_hi) == (0, grid.n_wav)
                             else (l_lo, l_hi))
        # rest-column range the filters occupy at z=0: the window engine
        # places each sub-chunk's λ window from it
        self._filter_support_cols = (int(m0), int(m1))

        table, self._n_knots = build_knot_matrix_device(
            filters, lam, self._filter_dlog, self._max_shift, grid.n_wav, dev,
            delta=self._knot_delta, l_range=self._lam_support)
        m_igm = self._bake_igm_into_knots(table)
        # the den table must cover the top knot row, (n_knots−1)·δ
        ms_den = max(self._max_shift, (self._n_knots - 1) * self._knot_delta)
        den = build_den_table(filters, lam, wlam, self._filter_dlog, ms_den)
        rows = np.minimum(np.arange(self._n_knots) * self._knot_delta * N_SUB,
                          den.shape[0] - 1)
        l0, l1 = self._lam_support or (0, grid.n_wav)
        types = em.reprocessed_types or (em.incident_type,)
        self._t_mix = sum(grid.spectra_device(t, dev)[:, l0:l1]
                          for t in types).contiguous()
        self._m_igm = m_igm
        self._den_knots = torch.as_tensor(den[rows], device=dev)
        self._dust_curve_sup = dust_curve[l0:l1].contiguous()
        self._wlam_sup = torch.as_tensor(wlam[l0:l1], device=dev)
        self._derive_tables()

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------
    def _igm_rows(self, lam_rest, z):
        """(len(z), L) IGM transmission at λ_rest·(1+z) for each redshift."""
        rows = []
        for i in range(0, z.shape[0], _IGM_CHUNK):
            zz = z[i:i + _IGM_CHUNK, None]
            rows.append(igm_transmission(lam_rest[None, :] * (1.0 + zz), zz,
                                         self._igm_model))
        return torch.cat(rows, dim=0)

    def _bake_igm_into_knots(self, table):
        """Knot k is the definite redshift 1+z_k = 10^{kδΔ}, so T_igm(λ, z_k)
        folds into the knot matrix and no per-galaxy IGM row is needed."""
        if self._igm_model is None:
            return table
        zp1_k = 10.0 ** (self._knot_delta * self._filter_dlog * torch.arange(
            self._n_knots, dtype=torch.float32, device=self.device))
        lam = self._lam
        if self._lam_support is not None:
            lam = lam[self._lam_support[0]:self._lam_support[1]]
        igm = self._igm_rows(lam, zp1_k - 1.0)  # (K, L)
        n_rows = table.shape[0]
        f8 = table.shape[1] // self._n_knots
        return (table.reshape(n_rows, self._n_knots, f8)
                * igm.T[:, :, None]).reshape(n_rows, self._n_knots * f8)

    def _derive_tables(self) -> None:
        """The kernel's views of the window-engine tables: the spectra with
        dλ/λ folded in (the fused body's sed window), the knot matrix in bf16
        (the second product's input type) and the den knots padded to F8
        columns."""
        self._t_mix_w = (self._t_mix * self._wlam_sup[None, :]).contiguous()
        self._m_igm_bf16 = self._m_igm.to(torch.bfloat16)
        den = torch.zeros(self._n_knots, self._f8, dtype=torch.float32,
                          device=self.device)
        den[:, :self._den_knots.shape[1]] = self._den_knots
        self._den_knots_f8 = den

    def load_state(self, arrays: dict) -> None:
        """Overwrite derived tables with another simulator's (e.g. the JAX
        package's, as numpy arrays), so both compute on identical tables.

        Keys: any of `STATE_KEYS`; shapes must match this simulator's.
        """
        unknown = set(arrays) - set(self.STATE_KEYS)
        if unknown:
            raise KeyError(f"unknown state keys {sorted(unknown)}")
        for key, val in arrays.items():
            mine = getattr(self, f"_{key}")
            if tuple(np.shape(val)) != tuple(mine.shape):
                raise ValueError(
                    f"state {key!r} has shape {np.shape(val)}, simulator "
                    f"holds {tuple(mine.shape)}")
        for key, val in arrays.items():
            setattr(self, f"_{key}", torch.tensor(
                np.asarray(val, np.float32), device=self.device))
        self._derive_tables()

    # ------------------------------------------------------------------
    # cosmology table lookups
    # ------------------------------------------------------------------
    @staticmethod
    def _uniform_lerp(table, x0, dx, x):
        """Lerp on a uniform grid by direct index arithmetic."""
        s = (x - x0) / dx
        k = torch.clamp(torch.floor(s).to(torch.int64), 0, table.shape[0] - 2)
        frac = torch.clamp(s - k.to(s.dtype), 0.0, 1.0)
        return table[k] * (1.0 - frac) + table[k + 1] * frac

    def _age_of_z(self, z):
        """Age of the universe [yr] via the log(1+z) lerp table."""
        return self._uniform_lerp(self._age_table, 0.0, self._cosmo_dl1p,
                                  torch.log1p(torch.clamp(z, min=0.0)))

    def _d19_of_z(self, z):
        """Luminosity distance in 1e19 cm via the log(1+z) lerp table."""
        return self._uniform_lerp(self._d19_table, self._d19_x0,
                                  self._d19_dl1p,
                                  torch.log1p(torch.clamp(z, min=1.0e-4)))

    # ------------------------------------------------------------------
    # θ plumbing
    # ------------------------------------------------------------------
    def theta_dict(self, theta):
        """(B, P) θ -> {name: (B,) tensor}, merged with fixed params; names
        prefixed "log10_" also provide the unlogged alias."""
        b = theta.shape[0]
        d = {n: theta[:, i].contiguous()
             for i, n in enumerate(self.param_names)}
        for k, v in self.fixed_params.items():
            d.setdefault(k, torch.full((b,), float(v), dtype=torch.float32,
                                       device=theta.device))
        for k in list(d.keys()):
            if k.startswith("log10_"):
                d.setdefault(k[6:], 10.0 ** d[k])
        d["_theta"] = theta
        return d

    @staticmethod
    def _param(params, name, default):
        if name in params:
            return params[name]
        return torch.full_like(params["_theta"][:, 0], default)

    def _max_age(self, params):
        """Oldest-star age [yr]: explicit θ/fixed value, else the age of the
        universe at z."""
        age_univ = self._age_of_z(self._param(params, "redshift", 0.0))
        if "max_age" in params:
            return torch.minimum(params["max_age"], age_univ)
        if "log10_max_age" in params:
            return torch.minimum(10.0 ** params["log10_max_age"], age_univ)
        return age_univ

    @staticmethod
    def _axis_delta_weights(vals, p):
        """(B, n) lerp-delta weights placing unit mass at p on the axis grid
        `vals`, split between the two bracketing knots (clamped at the ends)."""
        n = vals.shape[0]
        idx = torch.clamp(torch.searchsorted(vals, p.contiguous()) - 1, 0, n - 2)
        frac = torch.clamp(
            (p - vals[idx]) / torch.clamp(vals[idx + 1] - vals[idx], min=1e-30),
            0.0, 1.0)
        w = torch.zeros(p.shape[0], n, dtype=p.dtype, device=p.device)
        w.scatter_(1, idx[:, None], (1.0 - frac)[:, None])
        w.scatter_add_(1, (idx + 1)[:, None], frac[:, None])
        return w

    def _sfzh(self, params):
        """(B, A·Z·extra) mass weights [Msun] and the (B, A) age marginal."""
        sfh_params = dict(params)
        sfh_params["max_age"] = self._max_age(params)
        w_age = sfh_weights(self.sfh_name, sfh_params, self._sampling)
        w_met = zdist_weights(self.zdist_name, params, self._log10_mets)
        mass = 10.0 ** self._param(params, "log10_mass", 8.0)
        sfzh = w_age[:, :, None] * w_met[:, None, :]
        for ax_name, ax_vals in self._extra_axes:
            w_ax = self._axis_delta_weights(ax_vals, params[ax_name])
            sfzh = sfzh[..., None] * w_ax.reshape(
                w_ax.shape[0], *([1] * (sfzh.ndim - 1)), -1)
        sfzh = sfzh * mass.reshape(-1, *([1] * (sfzh.ndim - 1)))
        b = sfzh.shape[0]
        sfh_mass = sfzh.reshape(b, sfzh.shape[1], -1).sum(dim=2)
        return sfzh.reshape(b, -1), sfh_mass

    # ------------------------------------------------------------------
    # z-sorted window engine
    # ------------------------------------------------------------------
    def _window_supported(self) -> bool:
        """The window bodies implement a static fesc and one dust screen."""
        em = self.emission
        return (not isinstance(em.fesc, str)
                and not (float(em.fesc) != 0.0 and em.reprocessed_types)
                and em.tau_v_bc_param is None
                and not em.dust_emission)

    def _window_mega_supported(self) -> bool:
        """Extra gate for the fused body (K1): interpolation order 1 or 3 and
        at most 128 bands (the knot product is bf16 in this package)."""
        return (self._window_supported()
                and self._interp_order in (1, 3)
                and self._f8 <= 128)

    @property
    def _f8(self) -> int:
        return int(np.ceil(len(self.filters) / 8) * 8)

    @property
    def _l_sup(self) -> int:
        return int(self._wlam_sup.shape[0])

    def _knot_interval_device(self, z):
        """Clamped knot-interval index per redshift,
        k = min(floor(s/δ), n_knots−2) with s = log10(1+z)/dlog, in float32;
        the +5 knot margin of `_zsorted_plan` absorbs boundary flips against
        the JAX package's float64 host plan."""
        s = torch.log10(1.0 + torch.clamp(z, min=0.0)) / self._filter_dlog
        return torch.clamp((s / self._knot_delta).to(torch.int32),
                           max=self._n_knots - 2)

    def _zsorted_plan(self, max_span_knots: int):
        """(kc, w_cols) window sizes for a max per-sub-chunk knot span: the
        cubic's knots k−1..k+2 stay inside the slice (+5, rounded up to 4),
        and the λ window covers the filter support plus the window's reach."""
        kc = min(int(np.ceil((max_span_knots + 5) / 4) * 4), self._n_knots)
        m0, m1 = self._filter_support_cols
        w_cols = (m1 - m0) + kc * self._knot_delta
        w_cols = min(int(np.ceil(w_cols / 256) * 256), self._l_sup)
        return kc, w_cols

    def _window_starts(self, k_first, kc: int, w_cols: int):
        """Knot and λ window starts (k0, l0) for sub-chunks whose first row
        lies in knot interval `k_first` (an int64 tensor)."""
        delta = self._knot_delta
        m0, _ = self._filter_support_cols
        l_lo = self._lam_support[0] if self._lam_support else 0
        k0 = (k_first - 1).clip(0, self._n_knots - kc)
        l0 = ((m0 - l_lo) - (k0 + kc - 1) * delta).clip(0, self._l_sup - w_cols)
        return k0, l0

    def _window_calls(self, theta, sub: int, w_cols: int, kc: int, k0, l0):
        """Per sub-chunk of `theta` (n_sub·sub z-sorted rows on the device),
        yield (row slice, λ-column slice, knot-column slice, K1 keyword
        arguments); k0/l0 are the host-int window starts."""
        em = self.emission
        delta, f8 = self._knot_delta, self._f8
        params = self.theta_dict(theta)
        sfzh, _ = self._sfzh(params)
        z = self._param(params, "redshift", 0.0)
        tau_v = (params[em.tau_v_param] if em.tau_v_param is not None
                 else torch.zeros_like(z))
        s_abs = torch.log10(1.0 + torch.clamp(z, min=0.0)) / self._filter_dlog
        inv_d = 1.0 / self._d19_of_z(z)  # two 1/d19 factors: no 1/d19² underflow
        scale = (1.0 + z) * (1.0e-6 / _FOUR_PI) * inv_d * inv_d
        fesc = 0.0 if em.reprocessed_types else float(em.fesc)
        for i, (k, l) in enumerate(zip(k0, l0)):
            r = slice(i * sub, (i + 1) * sub)
            cols = slice(l, l + w_cols)
            knots = slice(k * f8, (k + kc) * f8)
            yield r, cols, knots, dict(
                sfzh=sfzh[r], s_rel=s_abs[r] - float(k * delta),
                tau_v=tau_v[r], scale=scale[r], sed_w=self._t_mix_w[:, cols],
                curve_w=self._dust_curve_sup[cols],
                knot_w=self._m_igm_bf16[cols, knots],
                den_w=self._den_knots_f8[k:k + kc], kc=kc, delta=delta,
                f8=f8, order=self._interp_order, fesc=fesc)

    def _zsorted_run_raw(self, theta, sub: int, w_cols: int, kc: int, k0,
                         l0, fused: bool = False):
        """Run a window body over every sub-chunk -> (n_sub·sub, F).

        `fused=True` launches K1 per sub-chunk; `fused=False` runs the staged
        body: the two products and `_knot_interp` in plain torch, with dλ/λ
        applied after the dust screen as in the JAX package's staged body.
        """
        em = self.emission
        fesc = float(em.fesc)
        out = torch.empty(theta.shape[0], len(self.filters),
                          dtype=torch.float32, device=theta.device)
        for r, cols, knots, a in self._window_calls(theta, sub, w_cols, kc,
                                                    k0, l0):
            if fused:
                phot = fused_window_photometry(**a)
            else:
                lnu = a["sfzh"] @ self._t_mix[:, cols]
                att = torch.exp(-a["tau_v"][:, None] * a["curve_w"][None, :])
                if em.reprocessed_types:  # the gate makes fesc 0 here
                    lnu = lnu * att
                else:
                    lnu = lnu * (fesc + (1.0 - fesc) * att)
                fw = lnu * self._wlam_sup[None, cols]
                acc = knot_product(fw, self._m_igm[cols, knots])
                phot = window_ratio(acc, a["den_w"], a["s_rel"], a["scale"],
                                    kc, a["delta"], a["order"])
            out[r] = phot[:, :out.shape[1]]
        return out

    def photometry_zsorted_device(self, theta, sub_chunk: int = 1024,
                                  kc: int | None = None,
                                  w_cols: int | None = None,
                                  fused: bool = False,
                                  validate_plan: bool = False):
        """θ (B, P) on the device, rows sorted by ascending redshift (not
        checked) -> (B, F) photometry [nJy] on the device.

        When (kc, w_cols) are omitted they are planned from θ's redshifts.
        Caller-supplied plans are trusted unless `validate_plan=True`: a plan
        too small for the batch would clamp the windows and return wrong
        fluxes. The per-sub-chunk window starts are computed on the device
        and read back once per call (see `_plan_windows`).
        """
        if not self._window_supported():
            raise NotImplementedError(
                "this emission model needs the dense photometry path "
                "(ROADMAP M9); the window engine runs a static fesc and one "
                "dust screen (see _window_supported)")
        if fused and not self._window_mega_supported():
            raise ValueError(
                "model config unsupported by the FUSED window engine "
                "(see _window_mega_supported); call with fused=False")
        b = len(theta)
        theta, sub, kc, w_cols, k0, l0 = self._plan_windows(
            theta, sub_chunk, kc, w_cols, validate_plan)
        out = self._zsorted_run_raw(theta, sub, w_cols, kc, k0, l0,
                                    fused=fused)
        return out[:b]

    def _plan_windows(self, theta, sub_chunk: int, kc: int | None = None,
                      w_cols: int | None = None, validate_plan: bool = False):
        """Pad z-sorted θ to whole sub-chunks and plan their windows.

        Returns (padded θ, sub, kc, w_cols, k0, l0), k0/l0 as host int lists
        (one device readback, plus one for the span when the plan is not
        supplied or is validated)."""
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self.device)
        b = theta.shape[0]
        sub = int(min(sub_chunk, b))
        n_sub = int(np.ceil(b / sub))
        pad = n_sub * sub - b
        if pad:
            theta = torch.cat([theta, theta[-1:].expand(pad, -1)], dim=0)
        if "redshift" in self.param_names:
            z = theta[:, self.param_names.index("redshift")]
        else:
            z = torch.full((theta.shape[0],),
                           float(self.fixed_params.get("redshift", 0.0)),
                           dtype=torch.float32, device=self.device)
        k_flat = self._knot_interval_device(z)
        if kc is None or w_cols is None or validate_plan:
            span = int(torch.max(k_flat[sub - 1::sub] - k_flat[::sub]))
            kc_req, w_req = self._zsorted_plan(span)
            if validate_plan and kc is not None and w_cols is not None and (
                    int(kc) < kc_req or int(w_cols) < w_req):
                raise ValueError(
                    f"supplied window plan (kc={kc}, w_cols={w_cols}) is "
                    f"smaller than this batch needs (kc>={kc_req}, "
                    f"w_cols>={w_req}); the windows would clamp and return "
                    "wrong fluxes — replan or lower sub_chunk")
            kc = kc_req if kc is None else int(kc)
            w_cols = w_req if w_cols is None else int(w_cols)
        if kc >= self._n_knots or w_cols >= self._l_sup:
            raise NotImplementedError(
                f"the window (kc={kc}, w_cols={w_cols}) is the whole table; "
                "the dense photometry() path is ROADMAP M9 — lower sub_chunk")
        k0, l0 = self._window_starts(k_flat[::sub].to(torch.int64), kc, w_cols)
        k0, l0 = torch.stack([k0, l0]).tolist()
        return theta, sub, int(kc), int(w_cols), k0, l0

    def photometry(self, theta):
        raise NotImplementedError(
            "dense photometry() over unsorted θ is not ported yet (ROADMAP "
            "M9); sort θ by redshift and call photometry_zsorted_device")
