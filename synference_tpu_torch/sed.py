"""The batched SED simulator — θ → spectra and band photometry.

Counterpart of `synference_tpu/sed.py`:

    θ (B, P) ──SFH/ZDist weights──► SFZH (B, A·Z)
             ──dense path──► photometry (B, F), spectra on request
             ──z-sorted window engine──► photometry (B, F), θ sorted by z

The dense path (`simulate`, `photometry`, `__call__`) takes θ rows in any
order. Three photometry routes, picked by `photometry_backend` and
`photometry_variant` as in the JAX package:

- "xla": the exact per-galaxy filter integral over the lerped filter table
  (`_photometry_one`), plain torch;
- "pallas" + "interp": photometry-only calls run K2 (`ops/fused_sed.py`,
  the contraction, dust screen, knot product and shift interpolation over
  the whole λ support in one kernel) when `_mega_supported`, else the plain
  knot path (`_photometry_fused`); spectra calls integrate the observed
  f_ν against the plain knot matrix;
- "pallas" + "roll" / "bank": exact numerators at the 1/8-column snapped
  shift from K3 (`ops/photometry_kernel.py`), one kernel for both names.

The window engine (`photometry_zsorted_device`) takes θ rows sorted by
redshift: each sub-chunk reads only a window of λ columns and knots, through
K1 (`fused=True`) or the staged plain body. When a window would be the whole
table it takes the dense path.

Not ported (NotImplementedError names the ROADMAP item): the table-free
`conv` engine and particle SFZHs (M9).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cosmology import PLANCK18, Cosmology
from .dust import attenuation_curve, greybody_emission
from .filters import FilterSet
from .grids import SPSGrid
from .igm import igm_transmission
from .ops.fused_sed import (fused_sed_photometry,
                            fused_window_photometry_grouped, knot_product,
                            prepare_megakernel_tables, window_ratio)
from .ops.photometry_kernel import (KNOT_INTERP_ORDER, N_SUB,
                                    build_den_table, build_knot_matrix_device,
                                    build_subshift_table, shift_decompose,
                                    shift_photometry_num)
from .sfh import make_age_sampling, sfh_weights, zdist_weights
from .units import C_AA_S

__all__ = ["EmissionConfig", "BatchSEDSimulator"]

_FOUR_PI = 4.0 * np.pi
# elements per IGM evaluation: rows × λ × 39 Lyman-series terms, bounding
# the temporaries while keeping the number of calls small
_IGM_CHUNK_ELEMS = 1 << 24
_IGM_ROWS = 512  # rows of the T_igm(λ_rest, z) table over log10(1+z)
_XLA_CHUNK = 1024  # galaxies per exact-path step (bounds the (B, F, L) slices)
# knot-matrix size above which the JAX package's "auto" variant picks conv
_CONV_KNOT_BYTES = 64 * 1024 * 1024


@dataclass(frozen=True)
class EmissionConfig:
    """Static emission-model configuration (as in the JAX package).

    lnu = fesc · incident + (1 − fesc) · Σ reprocessed, the reprocessed part
    behind the ISM screen exp(−τ_V k_λ); with `tau_v_bc_param`, stars younger
    than 10^age_pivot_log10 yr sit behind an extra birth-cloud screen.
    `fesc` is a number or the name of a θ column. `dust_emission` re-emits
    the absorbed energy as a greybody at `dust_temperature` [K] with
    `dust_emissivity`. `igm` names the IGM model.
    """

    incident_type: str = "incident"
    reprocessed_types: tuple = ()
    fesc: float | str = 0.0
    dust_law: str = "calzetti2000"
    dust_params: tuple = ()  # tuple of (key, value) pairs; hashability
    tau_v_param: str | None = "tau_v"
    tau_v_bc_param: str | None = None
    age_pivot_log10: float = 7.0
    dust_emission: bool = False
    dust_temperature: float = 25.0
    dust_emissivity: float = 1.6
    igm: str = "inoue14"

    def dust_params_dict(self) -> dict:
        return dict(self.dust_params)

    def to_dict(self) -> dict:
        """The JSON record a library's Model group stores (the JAX
        package's keys)."""
        return {
            "incident_type": self.incident_type,
            "reprocessed_types": list(self.reprocessed_types),
            "fesc": self.fesc,
            "dust_law": self.dust_law,
            "dust_params": dict(self.dust_params),
            "tau_v_param": self.tau_v_param,
            "tau_v_bc_param": self.tau_v_bc_param,
            "age_pivot_log10": self.age_pivot_log10,
            "dust_emission": self.dust_emission,
            "dust_temperature": self.dust_temperature,
            "dust_emissivity": self.dust_emissivity,
            "igm": self.igm,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EmissionConfig":
        d = dict(d)
        d["reprocessed_types"] = tuple(d.get("reprocessed_types", ()))
        d["dust_params"] = tuple(dict(d.get("dust_params", {})).items())
        return cls(**d)


class BatchSEDSimulator:
    """θ → photometry / spectra forward model over galaxy batches.

    Args:
        grid, filters, param_names, sfh, zdist, emission, cosmology,
        fixed_params, n_age_sub, z_max: as in the JAX package.
        photometry_backend: "pallas" (the kernel routes), "xla" (the exact
            per-galaxy path) or "auto": "pallas" on a CUDA device, else
            "xla".
        photometry_variant: "interp" (knot product + shift interpolation),
            "roll" / "bank" (exact numerators, both K3) or "auto"
            ("interp"). "conv", and "auto" where the JAX package would pick
            conv (knot matrix above 64 MiB), raise NotImplementedError.
        photometry_knot_delta: knot spacing in λ columns; None = constant
            ~0.009 dex physical spacing.
        photometry_interp_order: 1 (lerp) or 3 (monotone cubic, default).
        n_particles: particle SFZHs; not ported, must be None.
        device: where every table lives and every batch runs. Required.

    The window engine needs the "interp" tables and runs whatever the
    backend; the backend picks the dense path's route.
    """

    # tables another simulator's arrays (the JAX package's, as numpy) can
    # overwrite; "components" is a {spectra type: (C, L)} dict
    STATE_KEYS = ("t_mix", "m_igm", "den_knots", "dust_curve_sup",
                  "wlam_sup", "age_table", "d19_table", "knot_matrix",
                  "den_table", "igm_table", "filter_table", "subshift_table",
                  "components", "dust_curve", "wlam")

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
        photometry_backend: str = "auto",
        photometry_variant: str = "auto",
        photometry_knot_delta: int | None = None,
        photometry_interp_order: int | None = None,
        n_particles: int | None = None,
        *,
        device,
    ):
        if n_particles is not None:
            raise NotImplementedError(
                "particle SFZHs (n_particles) are not ported yet (ROADMAP M9)")
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
        self._wlam = torch.as_tensor(wlam, device=dev)
        nu_phz = C_AA_S / lam * 1.0e-15
        self._dnu_phz = torch.as_tensor(
            (-np.gradient(nu_phz)).astype(np.float32), device=dev)
        em = self.emission
        self._components = {
            t: grid.spectra_device(t, dev)
            for t in (em.incident_type, *em.reprocessed_types)}
        self._dust_curve = attenuation_curve(em.dust_law, self._lam,
                                             em.dust_params_dict())
        self._young_mask = torch.as_tensor(
            (grid.log10_ages < em.age_pivot_log10).astype(np.float32),
            device=dev)
        self._grey = (greybody_emission(self._lam, em.dust_temperature,
                                        em.dust_emissivity)
                      if em.dust_emission else None)

        table, dlog, max_shift = filters.shifted_table(lam, z_max=z_max)
        self._filter_table = torch.as_tensor(table, device=dev)
        self._filter_dlog = float(dlog)
        self._max_shift = int(max_shift)
        self._igm_model = None if em.igm in (None, "none") else em.igm
        self._igm_table = None
        if self._igm_model is not None:
            # T_igm(λ_rest, z) on a log10(1+z) grid, lerped per galaxy
            self._igm_dlog = float(np.log10(1.0 + z_max) / (_IGM_ROWS - 2))
            z_rows = 10.0 ** (self._igm_dlog * torch.arange(
                _IGM_ROWS, dtype=f32, device=dev)) - 1.0
            self._igm_table = self._igm_rows(self._lam, z_rows)

        if photometry_backend == "auto":
            photometry_backend = "pallas" if dev.type == "cuda" else "xla"
        if photometry_backend not in ("pallas", "xla"):
            raise ValueError(
                f"unknown photometry_backend {photometry_backend!r}")
        self.photometry_backend = photometry_backend
        self._knot_delta = (max(1, round(0.009 / self._filter_dlog))
                            if photometry_knot_delta is None
                            else int(photometry_knot_delta))
        self._interp_order = (KNOT_INTERP_ORDER if photometry_interp_order
                              is None else int(photometry_interp_order))
        n_knots_est = int(self._max_shift // self._knot_delta) + 2
        self._variant = self._pick_variant(photometry_variant, n_knots_est)

        self._lam_support = None
        self._subshift_table = None
        self._knot_matrix = self._m_igm = None
        if self._variant == "interp":
            self._build_knot_tables(lam, wlam, n_knots_est)
            ms_den = max(self._max_shift,
                         (self._n_knots - 1) * self._knot_delta)
        else:
            self._subshift_table = build_subshift_table(
                filters, lam, self._filter_dlog, self._max_shift, grid.n_wav,
                dev)
            ms_den = self._max_shift
        self._den_table = torch.as_tensor(
            build_den_table(filters, lam, wlam, self._filter_dlog, ms_den),
            device=dev)
        if self._variant == "interp":
            rows = np.minimum(
                np.arange(self._n_knots) * self._knot_delta * N_SUB,
                self._den_table.shape[0] - 1)
            self._den_knots = self._den_table[torch.as_tensor(rows)].clone()
            self._derive_tables()

    def _pick_variant(self, requested: str, n_knots_est: int) -> str:
        """The photometry variant, without the JAX package's silent switches
        (auto → conv, bank → roll): conv is not ported, and roll and bank
        are one kernel here."""
        if requested == "auto":
            knot_bytes = self.grid.n_wav * n_knots_est * self._f8 * 4
            if knot_bytes > _CONV_KNOT_BYTES:
                raise NotImplementedError(
                    f"the knot matrix would take {knot_bytes} bytes, where "
                    "the JAX package switches to the table-free 'conv' "
                    "engine, which is not ported yet (ROADMAP M9); pass "
                    "photometry_variant='interp' or 'roll'")
            return "interp"
        if requested == "conv":
            raise NotImplementedError(
                "photometry_variant='conv' is not ported yet (ROADMAP M9)")
        if requested not in ("interp", "roll", "bank"):
            raise ValueError(f"unknown photometry_variant {requested!r}")
        return requested

    def _build_knot_tables(self, lam, wlam, n_knots_est: int) -> None:
        """The interp tables: λ-support trimming, the knot matrix (plain and
        IGM-baked) and the trimmed spectra, dust curve and dλ/λ."""
        grid, filters = self.grid, self.filters
        # λ-support trimming: rest columns no filter reaches at any knot
        # shift contribute nothing to any numerator
        lam0 = float(lam[0])
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
        self._knot_matrix, self._n_knots = build_knot_matrix_device(
            filters, lam, self._filter_dlog, self._max_shift, grid.n_wav,
            self.device, delta=self._knot_delta, l_range=self._lam_support)
        self._m_igm = self._bake_igm_into_knots(self._knot_matrix)
        l0, l1 = self._sup
        em = self.emission
        types = em.reprocessed_types or (em.incident_type,)
        self._t_mix = sum(self._components[t][:, l0:l1]
                          for t in types).contiguous()
        self._dust_curve_sup = self._dust_curve[l0:l1].contiguous()
        self._wlam_sup = torch.as_tensor(wlam[l0:l1], device=self.device)

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------
    @property
    def _sup(self) -> tuple:
        """The (l0, l1) rest columns of the λ support."""
        return self._lam_support or (0, self.grid.n_wav)

    def _igm_rows(self, lam_rest, z):
        """(len(z), L) IGM transmission at λ_rest·(1+z) for each redshift."""
        rows = []
        chunk = max(1, _IGM_CHUNK_ELEMS // (39 * lam_rest.shape[0]))
        for i in range(0, z.shape[0], chunk):
            zz = z[i:i + chunk, None]
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
        l0, l1 = self._sup
        igm = self._igm_rows(self._lam[l0:l1], zp1_k - 1.0)  # (K, L)
        n_rows = table.shape[0]
        f8 = table.shape[1] // self._n_knots
        return (table.reshape(n_rows, self._n_knots, f8)
                * igm.T[:, :, None]).reshape(n_rows, self._n_knots * f8)

    def _derive_tables(self) -> None:
        """The kernels' views of the interp tables, shared by K1's windows
        and K2: spectra with dλ/λ folded in, the IGM-baked knot matrix in
        bf16 and the den knots padded to F8 columns."""
        self._mega_tables = prepare_megakernel_tables(
            self._t_mix, self._wlam_sup, self._dust_curve_sup, self._m_igm,
            self._den_knots, self._f8)

    def load_state(self, arrays: dict) -> None:
        """Overwrite tables with another simulator's (e.g. the JAX package's,
        as numpy arrays), so both compute on identical tables.

        Keys: any of `STATE_KEYS` this simulator holds ("components" maps
        spectra types to arrays); shapes must match this simulator's.
        """
        unknown = set(arrays) - set(self.STATE_KEYS)
        if unknown:
            raise KeyError(f"unknown state keys {sorted(unknown)}")
        flat = {}
        for key, val in arrays.items():
            if key == "components":
                if set(val) != set(self._components):
                    raise ValueError(
                        f"state 'components' has types {sorted(val)}, "
                        f"simulator holds {sorted(self._components)}")
                flat.update({(key, t): (v, self._components[t])
                             for t, v in val.items()})
            else:
                mine = getattr(self, f"_{key}")
                if mine is None:
                    raise ValueError(f"this simulator holds no {key!r} table")
                flat[key] = (val, mine)
        for name, (val, mine) in flat.items():
            if tuple(np.shape(val)) != tuple(mine.shape):
                raise ValueError(
                    f"state {name!r} has shape {np.shape(val)}, simulator "
                    f"holds {tuple(mine.shape)}")
        for name, (val, mine) in flat.items():
            new = torch.tensor(np.asarray(val, np.float32), device=self.device)
            if isinstance(name, tuple):
                self._components[name[1]] = new
            else:
                setattr(self, f"_{name}", new)
        if self._variant == "interp":
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
    # emission and observation (the dense path's per-λ model)
    # ------------------------------------------------------------------
    def _intrinsic_lnu(self, sfzh, trimmed: bool = False):
        """(B, C) SFZH ⊗ grid spectra -> (incident, reprocessed) (B, L)
        luminosities; `trimmed` contracts over the λ support only (exact
        for photometry: the dropped columns never reach a filter)."""
        em = self.emission
        l0, l1 = self._sup if trimmed else (0, self.grid.n_wav)

        def contract(stype):
            return sfzh @ self._components[stype][:, l0:l1]

        incident = contract(em.incident_type)
        if em.reprocessed_types:
            return incident, sum(contract(t) for t in em.reprocessed_types)
        return incident, incident

    def _split_sfzh(self, sfzh):
        """Split weights into young/old parts for birth-cloud dust."""
        m = torch.repeat_interleave(self._young_mask, self.grid.cells_per_age)
        return sfzh * m, sfzh * (1.0 - m)

    def _apply_emission(self, params, sfzh, trimmed: bool = False):
        """Rest-frame L_ν with dust -> (lnu, intrinsic), both (B, L).

        `trimmed` restricts every per-λ table to the λ support (the
        photometry-only path; callers keep dust emission, whose energy
        balance integrates the whole grid, untrimmed)."""
        em = self.emission
        curve = self._dust_curve_sup if trimmed else self._dust_curve
        fesc = (params[em.fesc][:, None] if isinstance(em.fesc, str)
                else float(em.fesc))
        tau_v = (params[em.tau_v_param][:, None]
                 if em.tau_v_param is not None
                 else torch.zeros_like(sfzh[:, :1]))
        if em.tau_v_bc_param is not None:
            tau_bc = params[em.tau_v_bc_param][:, None]
            sf_young, sf_old = self._split_sfzh(sfzh)
            inc_y, rep_y = self._intrinsic_lnu(sf_young, trimmed)
            inc_o, rep_o = self._intrinsic_lnu(sf_old, trimmed)
            att_old = torch.exp(-tau_v * curve)
            att_young = torch.exp(-(tau_v + tau_bc) * curve)
            escaped = fesc * (inc_y + inc_o)
            attenuated = (1.0 - fesc) * (rep_y * att_young + rep_o * att_old)
            intrinsic = escaped + (1.0 - fesc) * (rep_y + rep_o)
        else:
            inc, rep = self._intrinsic_lnu(sfzh, trimmed)
            att = torch.exp(-tau_v * curve)
            escaped = fesc * inc
            attenuated = (1.0 - fesc) * rep * att
            intrinsic = escaped + (1.0 - fesc) * rep
        lnu = escaped + attenuated
        if em.dust_emission:
            lnu = self._add_dust_emission(lnu, intrinsic)
        return lnu, intrinsic

    def _add_dust_emission(self, lnu, intrinsic):
        """Energy balance: re-emit the absorbed luminosity as a greybody.

        L_ν in 1e30 erg/s/Hz and ν in PHz keep the energy integral inside
        fp32 range; the 1e45 that restores erg/s is split 1e23·1e22 (the
        literal 1e45 is inf in fp32)."""
        absorbed30 = torch.sum((intrinsic - lnu) * 1.0e-30 * self._dnu_phz,
                               dim=1, keepdim=True)
        return lnu + ((torch.clamp(absorbed30, min=0.0) * 1.0e23)
                      * (self._grey * 1.0e22))

    def _observe(self, params, lnu):
        """Rest L_ν (B, L) -> observed f_ν [nJy] on λ_obs = λ_rest(1+z)."""
        z = self._param(params, "redshift", 0.0)
        zp1 = 1.0 + z
        t_igm = self._igm_transmission(zp1)
        # two 1/d19 factors, not /d19²: the combined form underflows fp32
        inv_d = 1.0 / self._d19_of_z(z)
        return lnu * t_igm * (zp1 * (1.0e-6 / _FOUR_PI) * inv_d
                              * inv_d)[:, None]

    def _igm_transmission(self, zp1):
        """(B, L) IGM transmission over the rest grid at 1+z (two-row lerp of
        the T(λ_rest, z) table); 1.0 when the IGM is off."""
        if self._igm_table is None:
            return 1.0
        s = torch.log10(torch.clamp(zp1, min=1.0)) / self._igm_dlog
        k = torch.clamp(torch.floor(s).to(torch.int64), 0,
                        self._igm_table.shape[0] - 2)
        frac = (s - k.to(s.dtype))[:, None]
        return self._igm_table[k] * (1.0 - frac) + self._igm_table[k + 1] * frac

    # ------------------------------------------------------------------
    # photometry routes
    # ------------------------------------------------------------------
    def _shift_of_z(self, z):
        """Real column shift s = log10(1+z)/Δ of the filter table."""
        return torch.log10(1.0 + torch.clamp(z, min=0.0)) / self._filter_dlog

    def _scale_of_z(self, z):
        """Observed-frame scalar (1+z)·1e-6/(4π d19²), as two 1/d19."""
        inv_d = 1.0 / self._d19_of_z(z)
        return (1.0 + z) * (1.0e-6 / _FOUR_PI) * inv_d * inv_d

    def _photometry_one(self, fnu_njy, z):
        """(B, L) f_ν, (B,) z -> (B, F) band fluxes [nJy]: the photon-count
        mean over filters lerped between the two table columns around each
        galaxy's shift (the exact "xla" route)."""
        s = self._shift_of_z(z)
        k = torch.clamp(torch.floor(s).to(torch.int64), 0, self._max_shift - 1)
        frac = s - k.to(s.dtype)
        n_l = fnu_njy.shape[1]
        cols = torch.arange(n_l, device=fnu_njy.device)
        out = []
        for i in range(0, fnu_njy.shape[0], _XLA_CHUNK):
            r = slice(i, i + _XLA_CHUNK)
            idx = k[r, None] + cols  # (b, L)
            t0 = self._filter_table[:, idx].transpose(0, 1)  # (b, F, L)
            t1 = self._filter_table[:, idx + 1].transpose(0, 1)
            f = frac[r, None, None]
            tw = (t0 * (1.0 - f) + t1 * f) * self._wlam
            num = (tw * fnu_njy[r, None, :]).sum(dim=2)
            out.append(num / torch.clamp(tw.sum(dim=2), min=1.0e-30))
        return torch.cat(out, dim=0)

    def _photometry_batch(self, fnu_njy, z):
        """(B, L) f_ν, (B,) z -> (B, F): the spectra path's filter integral.

        "xla": `_photometry_one`. "pallas": interp integrates against the
        plain knot matrix with den knots interpolated at the same knots;
        roll and bank take K3's exact numerators at the 1/8-column snapped
        shift over the exact den of that shift."""
        if self.photometry_backend != "pallas":
            return self._photometry_one(fnu_njy, z)
        n_f = len(self.filters)
        s = self._shift_of_z(z)
        fnu_w = fnu_njy * self._wlam
        if self._variant == "interp":
            l0, l1 = self._sup
            acc = knot_product(fnu_w[:, l0:l1], self._knot_matrix)
            return window_ratio(acc, self._mega_tables["den"], s, None,
                                self._n_knots, self._knot_delta,
                                self._interp_order)[:, :n_f]
        s4 = shift_decompose(s, self._max_shift)
        num = shift_photometry_num(fnu_w, self._subshift_table, s4)[:, :n_f]
        return num / torch.clamp(self._den_table[s4.long()], min=1.0e-30)

    def _photometry_fused(self, lnu, z):
        """(B, L_sup) support-trimmed rest L_ν + (B,) z -> (B, F) nJy over
        the whole knot table (the plain route K2 replaces): the IGM rides
        the IGM-baked knot matrix, and the observed-frame scale is a scalar
        per galaxy because photometry is linear in f_ν."""
        acc = knot_product(lnu * self._wlam_sup, self._m_igm)
        return window_ratio(acc, self._mega_tables["den"], self._shift_of_z(z),
                            self._scale_of_z(z), self._n_knots,
                            self._knot_delta,
                            self._interp_order)[:, :len(self.filters)]

    def _mega_supported(self) -> bool:
        """Static gate for K2: the kernel route of the JAX megakernel's
        envelope (interp variant, order 1 or 3, a static fesc, one dust
        screen, no dust emission, F8 ≤ 128). Unlike the JAX package there
        is no λ-count gate: that crossover was measured on a TPU."""
        return (self.photometry_backend == "pallas"
                and self._window_mega_supported())

    def _photometry_mega(self, sfzh, z, tau_v):
        """(B, C) SFZH + (B,) z/τ_V -> (B, F) nJy through K2, one launch."""
        em = self.emission
        fesc = 0.0 if em.reprocessed_types else float(em.fesc)
        out = fused_sed_photometry(
            sfzh, self._shift_of_z(z), tau_v, self._scale_of_z(z),
            self._mega_tables, self._n_knots, self._knot_delta, self._f8,
            order=self._interp_order, fesc=fesc)
        return out[:, :len(self.filters)]

    # ------------------------------------------------------------------
    # z-sorted window engine
    # ------------------------------------------------------------------
    def _window_supported(self) -> bool:
        """The window bodies need the interp tables, a static fesc and one
        dust screen."""
        em = self.emission
        return (self._variant == "interp"
                and not isinstance(em.fesc, str)
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
        return torch.clamp((self._shift_of_z(z) / self._knot_delta).to(
            torch.int32), max=self._n_knots - 2)

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
        k0 = (k_first - 1).clip(0, self._n_knots - kc)
        l0 = ((m0 - self._sup[0]) - (k0 + kc - 1) * delta).clip(
            0, self._l_sup - w_cols)
        return k0, l0

    def _window_inputs(self, theta):
        """Per-row inputs of the fused window body for z-sorted θ: (sfzh,
        absolute shift s, τ_V, observed-frame scale, static fesc)."""
        em = self.emission
        params = self.theta_dict(theta)
        sfzh, _ = self._sfzh(params)
        z = self._param(params, "redshift", 0.0)
        tau_v = (params[em.tau_v_param] if em.tau_v_param is not None
                 else torch.zeros_like(z))
        fesc = 0.0 if em.reprocessed_types else float(em.fesc)
        return sfzh, self._shift_of_z(z), tau_v, self._scale_of_z(z), fesc

    def _window_calls(self, theta, sub: int, w_cols: int, kc: int, k0, l0):
        """Per sub-chunk of `theta` (n_sub·sub z-sorted rows on the device),
        yield (row slice, λ-column slice, knot-column slice, keyword
        arguments of `fused_window_photometry`, the one-sub-chunk K1);
        k0/l0 are the host-int window starts."""
        delta, f8 = self._knot_delta, self._f8
        tables = self._mega_tables
        sfzh, s_abs, tau_v, scale, fesc = self._window_inputs(theta)
        for i, (k, l) in enumerate(zip(k0, l0)):
            r = slice(i * sub, (i + 1) * sub)
            cols = slice(l, l + w_cols)
            knots = slice(k * f8, (k + kc) * f8)
            yield r, cols, knots, dict(
                sfzh=sfzh[r], s_rel=s_abs[r] - float(k * delta),
                tau_v=tau_v[r], scale=scale[r], sed_w=tables["sed"][:, cols],
                curve_w=tables["curve"][cols],
                knot_w=tables["knot"][cols, knots],
                den_w=tables["den"][k:k + kc], kc=kc, delta=delta,
                f8=f8, order=self._interp_order, fesc=fesc)

    def _window_grouped_args(self, theta, sub: int, w_cols: int, kc: int,
                             k0, l0) -> dict:
        """Keyword arguments of `fused_window_photometry_grouped` for every
        sub-chunk of `theta` at once (K1, one launch)."""
        sfzh, s_abs, tau_v, scale, fesc = self._window_inputs(theta)
        return dict(sfzh=sfzh, s=s_abs, tau_v=tau_v, scale=scale,
                    tables=self._mega_tables, k0=k0, l0=l0, sub=sub,
                    w_cols=w_cols, kc=kc, delta=self._knot_delta,
                    f8=self._f8, order=self._interp_order, fesc=fesc)

    def _zsorted_run_raw(self, theta, sub: int, w_cols: int, kc: int, k0,
                         l0, fused: bool = False):
        """Run a window body over every sub-chunk -> (n_sub·sub, F).

        `fused=True` launches K1 once for all sub-chunks; `fused=False` runs
        the staged body per sub-chunk: the two products and `_knot_interp`
        in plain torch, with dλ/λ applied after the dust screen as in the
        JAX package's staged body.
        """
        if fused:
            out = fused_window_photometry_grouped(
                **self._window_grouped_args(theta, sub, w_cols, kc, k0, l0))
            return out[:, :len(self.filters)]
        em = self.emission
        fesc = float(em.fesc)
        out = torch.empty(theta.shape[0], len(self.filters),
                          dtype=torch.float32, device=theta.device)
        for r, cols, knots, a in self._window_calls(theta, sub, w_cols, kc,
                                                    k0, l0):
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
        and read back once per call (see `_plan_windows`). When the window
        would be the whole table, the batch takes the dense `photometry`.
        """
        if not self._window_supported():
            raise ValueError(
                "model config unsupported by the z-sorted window engine; "
                "call .photometry() instead (see _window_supported)")
        if fused and not self._window_mega_supported():
            raise ValueError(
                "model config unsupported by the FUSED window engine "
                "(see _window_mega_supported); call with fused=False")
        b = len(theta)
        theta, sub, kc, w_cols, k0, l0 = self._plan_windows(
            theta, sub_chunk, kc, w_cols, validate_plan)
        if k0 is None:  # the window is the whole table
            return self.photometry(theta[:b])
        out = self._zsorted_run_raw(theta, sub, w_cols, kc, k0, l0,
                                    fused=fused)
        return out[:b]

    def _plan_windows(self, theta, sub_chunk: int, kc: int | None = None,
                      w_cols: int | None = None, validate_plan: bool = False):
        """Pad z-sorted θ to whole sub-chunks and plan their windows.

        Returns (padded θ, sub, kc, w_cols, k0, l0), k0/l0 as host int lists
        (one device readback, plus one for the span when the plan is not
        supplied or is validated), or None when the window is the whole
        table (kc = n_knots or w_cols = the λ support)."""
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
            return theta, sub, int(kc), int(w_cols), None, None
        k0, l0 = self._window_starts(k_flat[::sub].to(torch.int64), kc, w_cols)
        k0, l0 = torch.stack([k0, l0]).tolist()
        return theta, sub, int(kc), int(w_cols), k0, l0

    # ------------------------------------------------------------------
    # public batched API (the dense path)
    # ------------------------------------------------------------------
    def _core(self, theta, want_spectra: bool, fused: bool = False):
        """θ (B, P) -> dict of (B, ...) outputs before the filter integral.

        `fused`: photometry only; skip `_observe` and return the λ-support
        rest L_ν (the IGM rides the baked knot matrix, the distance scale is
        applied after the band ratio)."""
        params = self.theta_dict(theta)
        sfzh, sfh_mass = self._sfzh(params)
        z = self._param(params, "redshift", 0.0)
        if fused:
            trim = not self.emission.dust_emission
            lnu, _ = self._apply_emission(params, sfzh, trimmed=trim)
            if not trim:
                lnu = lnu[:, self._sup[0]:self._sup[1]]
            return {"_lnu": lnu, "_z": z}
        lnu, intrinsic = self._apply_emission(params, sfzh)
        out = {"fnu_njy": self._observe(params, lnu), "_z": z}
        if want_spectra:
            out.update(lnu=lnu, lnu_intrinsic=intrinsic, sfh_mass=sfh_mass,
                       sfzh=sfzh)
        return out

    def simulate(self, theta, want_spectra: bool = False):
        """θ (B, P) in any row order -> dict of (B, ...) tensors on the
        device: "photometry_njy" (B, F), and with `want_spectra` also
        "fnu_njy", "lnu", "lnu_intrinsic" (B, L), "sfh_mass" (B, A) and
        "sfzh" (B, C).

        Photometry-only calls on the pallas backend with the interp variant
        run K2 when `_mega_supported`, else `_photometry_fused`; every other
        call observes the full spectra and integrates them
        (`_photometry_batch`)."""
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self.device)
        theta = torch.atleast_2d(theta)
        fused = (not want_spectra and self.photometry_backend == "pallas"
                 and self._variant == "interp")
        if fused and self._mega_supported():
            em = self.emission
            params = self.theta_dict(theta)
            sfzh, _ = self._sfzh(params)
            z = self._param(params, "redshift", 0.0)
            tau_v = (params[em.tau_v_param] if em.tau_v_param is not None
                     else torch.zeros_like(z))
            return {"photometry_njy": self._photometry_mega(sfzh, z, tau_v)}
        res = self._core(theta, want_spectra, fused=fused)
        z = res.pop("_z")
        if fused:
            return {"photometry_njy": self._photometry_fused(res["_lnu"], z)}
        out = {"photometry_njy": self._photometry_batch(res["fnu_njy"], z)}
        if want_spectra:
            out.update(res)
        return out

    def photometry(self, theta):
        """θ (B, P) -> (B, F) photometry [nJy]."""
        return self.simulate(theta)["photometry_njy"]

    def __call__(self, theta):
        return self.photometry(theta)

    @property
    def n_filters(self) -> int:
        return len(self.filters)

    @property
    def n_params(self) -> int:
        return len(self.param_names)
