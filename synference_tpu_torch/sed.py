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
- "pallas" + "conv": the same knot numerators without a stored knot
  matrix (`conv_photometry_num`, plain torch), the IGM as a per-galaxy row
  lerp;
- "pallas" + "roll" / "bank": exact numerators at the 1/8-column snapped
  shift from K3 (`ops/photometry_kernel.py`), one kernel for both names.

The window engine (`photometry_zsorted_device`, and its host form
`photometry_zsorted`) takes θ rows sorted by redshift: each sub-chunk reads
only a window of λ columns and knots, through K1 (`fused=True`, interp
only) or the staged plain body (interp and conv; conv builds its knot
matrix when the engine first runs). When a window would be the whole table
it takes the dense path. K1, K2 and the staged body run the ISM screen and,
with `tau_v_bc_param` (Charlot & Fall 2000), the birth cloud over the young
cells too: the SFZH is age-major and the grid's ages ascend, so the young
cells are a prefix of C (`_n_young`, `_screens`). With `fesc` a θ column
(Pacman emission) they mix each row's unscreened incident light with its
screened reprocessed light by the row's escape fraction (`_screens`, the
incident table `_t_inc`).

"auto" keeps the interp knot matrix at any size on every device: the JAX
package switches to conv above 64 MiB only to stay under its TPU
compile-request cap. Particle SFZHs (`n_particles`) draw each row's star
particles from a counter-based hash of (particle_seed, the row's global
index, θ's bits, particle number), so a row's realization depends on the
seed, its index in the run and θ only, whatever the batching: the JAX
package's `jax.random` stream cannot be matched. `line_quantities` gives
per-line luminosities, fluxes and equivalent widths from the grid's line
tables.
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
from .ops.photometry_kernel import (KNOT_INTERP_ORDER, N_SUB, _knot_interp,
                                    build_den_table, build_knot_matrix_device,
                                    build_subshift_table, conv_photometry_num,
                                    shift_decompose, shift_photometry_num)
from .runtime import span, traced
from .ops.sfzh import MAX_AGES, lognormal_delta_sfzh, scan_chunk
from .sfh import (delta_cells, lognormal_shape, make_age_sampling,
                  sfh_weights, zdist_weights)
from .units import C_AA_S

__all__ = ["EmissionConfig", "BatchSEDSimulator", "SIMULATOR_REGISTRY",
           "register_simulator", "particle_uniforms", "particle_cells",
           "particle_counts_sfzh"]

# simulator classes by name: a library's Model group stores the class name,
# and `library.simulator_from_library` rebuilds the simulator through this
# registry (subclasses register on import, see agn.py)
SIMULATOR_REGISTRY: dict = {}


def register_simulator(cls):
    """Class decorator: make `cls` rebuildable by
    `library.simulator_from_library` from its stored class name."""
    SIMULATOR_REGISTRY[cls.__name__] = cls
    return cls

_FOUR_PI = 4.0 * np.pi
# elements per IGM evaluation: rows × λ × 39 Lyman-series terms, bounding
# the temporaries while keeping the number of calls small
_IGM_CHUNK_ELEMS = 1 << 24
_IGM_ROWS = 512  # rows of the T_igm(λ_rest, z) table over log10(1+z)
_XLA_CHUNK = 1024  # galaxies per exact-path step (bounds the (B, F, L) slices)
_MASK32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """(x · m) mod 2³² for int64 x in [0, 2³²) without int64 overflow: m is
    split into 16-bit halves."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x):
    """A 32-bit integer finaliser (lowbias32) on int64 tensors holding
    values in [0, 2³²): the counter-based generator of particle draws."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def particle_uniforms(seed: int, rows, theta, n: int):
    """(B, n) float64 uniforms in [0, 1) for rows with global indices `rows`
    (B,) int64 and parameters `theta` (B, P), whose float32 bit patterns are
    folded in: a pure function of (seed, row index, θ, particle number), 53
    bits each, the same on every device and for any batching."""
    dev = rows.device
    h_seed = int(_hash32(torch.tensor(int(seed) & _MASK32)))
    h_row = _hash32(_hash32((rows & _MASK32) ^ h_seed) ^ (rows >> 32))
    bits = theta.float().contiguous().view(torch.int32).to(
        torch.int64) & _MASK32
    for j in range(bits.shape[1]):
        h_row = _hash32(h_row ^ bits[:, j])
    j = _hash32(torch.arange(n, dtype=torch.int64, device=dev))
    a = _hash32(h_row[:, None] ^ j[None, :])
    b = _hash32(a ^ 0x9E3779B9)
    return ((a >> 5).double() * 67108864.0 + (b >> 6).double()) / 2.0**53


def particle_cells(weights, seed: int, rows, theta, n: int):
    """(B, n) int64 cell indices: n categorical draws per row over the
    (B, C) non-negative `weights`, by inverse CDF (float64 cumulative sum)
    at `particle_uniforms`. Rows with no weight draw uniformly."""
    w = weights.double()
    empty = w.sum(dim=1, keepdim=True) <= 0.0
    w = torch.where(empty, 1.0, w)
    cdf = torch.cumsum(w, dim=1)
    target = particle_uniforms(seed, rows, theta, n) * cdf[:, -1:]
    cells = torch.searchsorted(cdf, target.contiguous(), right=True)
    return torch.clamp(cells, max=w.shape[1] - 1)


def particle_counts_sfzh(cells, n_cells: int, n: int):
    """(B, n) cell draws -> (B, n_cells) float32 SFZH of unit mass: the
    count of draws in each cell over n (the JAX package's bookkeeping)."""
    counts = torch.zeros(cells.shape[0], n_cells, dtype=torch.float32,
                         device=cells.device)
    counts.scatter_add_(1, cells, torch.ones(cells.shape, dtype=torch.float32,
                                             device=cells.device))
    return counts / n


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


@register_simulator
class BatchSEDSimulator:
    """θ → photometry / spectra forward model over galaxy batches.

    Args:
        grid, filters, param_names, sfh, zdist, emission, cosmology,
        fixed_params, n_age_sub, z_max: as in the JAX package.
        photometry_backend: "pallas" (the kernel routes), "xla" (the exact
            per-galaxy path) or "auto": "pallas" on a CUDA device, else
            "xla".
        photometry_variant: "interp" (knot product + shift interpolation),
            "conv" (the same numerators without a stored knot matrix),
            "roll" / "bank" (exact numerators, both K3) or "auto"
            ("interp" at any knot-matrix size).
        photometry_knot_delta: knot spacing in λ columns; None = constant
            ~0.009 dex physical spacing.
        photometry_interp_order: 1 (lerp) or 3 (monotone cubic, default).
        n_particles: draw this many star particles per galaxy from its
            parametric SFZH (None: use the SFZH itself); `particle_seed`
            seeds the draws (see `particle_cells`).
        device: where every table lives and every batch runs. Required.

    The window engine needs the "interp" or "conv" tables and runs whatever
    the backend; the backend picks the dense path's route. Calls that take
    `row_offset` number their rows from it: particle draws follow each
    row's global index.

    `_mega_off = True` (the JAX package's name; the gradient fitters and
    user wrappers set it) keeps K1 and K2 out of every call: interp
    photometry then takes `_photometry_fused`, the plain route K2 replaces,
    which is differentiable end to end. The kernels have no gradient, and
    their wrappers raise on an input that needs one.

    A subclass that overrides `_core` or `_apply_emission` (the AGN
    simulators) has its own forward model, which K1, K2 and the window
    bodies do not compute: `_window_supported` and the gates built on it
    are False for it, so it takes the plain routes.
    """

    _mega_off = False

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
        particle_seed: int = 0,
        *,
        device,
    ):
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
        # on the device once: a copy per call would wait for the card
        self._fixed_tensors = {
            k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in self.fixed_params.items()}
        self.n_particles = None if n_particles is None else int(n_particles)
        self.particle_seed = int(particle_seed)
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
        self._n_young = None
        if em.tau_v_bc_param is not None:
            self._n_young = self._young_prefix(grid, em.age_pivot_log10)
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
        self._variant = self._pick_variant(photometry_variant)

        self._lam_support = None
        self._subshift_table = None
        self._knot_matrix = self._m_igm = None
        if self._variant in ("interp", "conv"):
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
        if self._variant in ("interp", "conv"):
            rows = np.minimum(
                np.arange(self._n_knots) * self._knot_delta * N_SUB,
                self._den_table.shape[0] - 1)
            self._den_knots = self._den_table[torch.as_tensor(rows)].clone()
            self._derive_tables()

    @staticmethod
    def _pick_variant(requested: str) -> str:
        """The photometry variant, without the JAX package's silent switches:
        "auto" is "interp" at any knot-matrix size (the JAX package picks
        conv above 64 MiB for its TPU compile-request cap), and roll and bank
        are one kernel here (no bank → roll switch)."""
        if requested == "auto":
            return "interp"
        if requested not in ("interp", "conv", "roll", "bank"):
            raise ValueError(f"unknown photometry_variant {requested!r}")
        return requested

    def _build_knot_tables(self, lam, wlam, n_knots_est: int) -> None:
        """The interp and conv tables: λ-support trimming, the trimmed
        spectra, dust curve and dλ/λ, each filter's support columns on the
        extended table, and for interp the knot matrix (plain and
        IGM-baked); conv builds its window knot matrix on first use
        (`_window_knot_matrix`)."""
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
        table = self._filter_table.cpu().numpy()
        self._filter_cols = tuple(
            (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 1)
            for nz in (np.nonzero(row > 0.0)[0] for row in table))
        if self._variant == "interp":
            self._knot_matrix, self._n_knots = build_knot_matrix_device(
                filters, lam, self._filter_dlog, self._max_shift, grid.n_wav,
                self.device, delta=self._knot_delta,
                l_range=self._lam_support)
            self._m_igm = self._bake_igm_into_knots(self._knot_matrix)
        else:
            self._n_knots = int(self._max_shift // self._knot_delta) + 2
        l0, l1 = self._sup
        em = self.emission
        types = em.reprocessed_types or (em.incident_type,)
        self._t_mix = sum(self._components[t][:, l0:l1]
                          for t in types).contiguous()
        # a θ-column fesc's escaped light, over the support (`_fesc_column`)
        self._t_inc = None
        if self._fesc_column():
            self._t_inc = (self._t_mix if not em.reprocessed_types else
                           self._components[em.incident_type][:, l0:l1]
                           .contiguous())
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
        """The den knots padded to F8 columns and, for interp, the kernels'
        views of its tables, shared by K1's windows and K2: spectra with
        dλ/λ folded in (and the incident spectra's, for a θ-column fesc) and
        the IGM-baked knot matrix in bf16."""
        den = torch.zeros(self._den_knots.shape[0], self._f8,
                          dtype=torch.float32, device=self.device)
        den[:, :self._den_knots.shape[1]] = self._den_knots
        self._den_f8 = den
        self._mega_tables = None
        if self._variant == "interp":
            self._mega_tables = prepare_megakernel_tables(
                self._t_mix, self._wlam_sup, self._dust_curve_sup,
                self._m_igm, self._den_knots, self._f8,
                inc_table=self._t_inc)

    def _window_knot_matrix(self):
        """The window engine's IGM-baked knot matrix: interp's own; conv
        builds it on first use and keeps it in bf16 (the knot product's
        input type; fp32 would double its memory)."""
        if self._variant == "interp":
            return self._m_igm
        if getattr(self, "_conv_m_igm", None) is None:
            table, n_knots = build_knot_matrix_device(
                self.filters, self.grid.lam, self._filter_dlog,
                self._max_shift, self.grid.n_wav, self.device,
                delta=self._knot_delta, l_range=self._lam_support)
            assert n_knots == self._n_knots
            self._conv_m_igm = self._bake_igm_into_knots(table).to(
                torch.bfloat16)
        return self._conv_m_igm

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
        if self._variant in ("interp", "conv"):
            self._conv_m_igm = None
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
    def theta_dict(self, theta, row_offset: int = 0):
        """(B, P) θ -> {name: (B,) tensor}, merged with fixed params (an
        array-valued one, such as dense-basis `fractions`, becomes (B, N));
        names prefixed "log10_" also provide the unlogged alias. "_row_idx"
        holds each row's global index, `row_offset` + its position."""
        b = theta.shape[0]
        d = {n: theta[:, i].contiguous()
             for i, n in enumerate(self.param_names)}
        for k, v in self._fixed_tensors.items():
            v = v.to(theta.device)
            d.setdefault(k, v.expand(b, *v.shape).contiguous())
        for k in list(d.keys()):
            if k.startswith("log10_"):
                d.setdefault(k[6:], 10.0 ** d[k])
        d["_theta"] = theta
        d["_row_idx"] = int(row_offset) + torch.arange(
            b, dtype=torch.int64, device=theta.device)
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
        return w.scatter(1, idx[:, None], (1.0 - frac)[:, None]).scatter_add(
            1, (idx + 1)[:, None], frac[:, None])

    def _sfzh_kernel_runs(self, rows: int, device) -> bool:
        """True where `_sfzh` takes the SFZH kernel (`ops.sfzh`) for `rows`
        rows on `device`: a card, not `_mega_off`, a lognormal SFH and a
        delta Z, no extra axes and no particles, at most 64 ages and at
        least 2 metallicities, and more than one row (`scan_chunk`). The
        kernel gives the plain ops' bits; everything else takes them."""
        return (torch.device(device).type == "cuda" and not self._mega_off
                and self.sfh_name == "lognormal"
                and self.zdist_name == "delta"
                and not self._extra_axes and self.n_particles is None
                and self._sampling.n_bins <= MAX_AGES
                and self._log10_mets.shape[0] >= 2
                and scan_chunk(rows, self._sampling.n_bins) is not None)

    def _sfzh_asking(self, params, marginal: bool):
        """`_sfzh`, asking for the age marginal only where `marginal`; a
        subclass's own `_sfzh` (the AGN grid's) takes θ alone and returns
        its marginal always."""
        if type(self)._sfzh is BatchSEDSimulator._sfzh:
            return self._sfzh(params, marginal=marginal)
        return self._sfzh(params)

    @traced("sed.sfzh")
    def _sfzh(self, params, marginal: bool = True):
        """(B, A·Z·extra) mass weights [Msun] and the (B, A) age marginal
        (None unless `marginal`); one kernel past the (B,) prologue where
        `_sfzh_kernel_runs`."""
        sfh_params = dict(params)
        sfh_params["max_age"] = self._max_age(params)
        mass = 10.0 ** self._param(params, "log10_mass", 8.0)
        if self._sfzh_kernel_runs(mass.shape[0], mass.device):
            mu, tau = lognormal_shape(sfh_params)
            return lognormal_delta_sfzh(
                sfh_params["max_age"], mu[:, 0], tau[:, 0], mass,
                *delta_cells(params, self._log10_mets), self._sampling.edges,
                self._log10_mets.shape[0], marginal)
        w_age = sfh_weights(self.sfh_name, sfh_params, self._sampling)
        w_met = zdist_weights(self.zdist_name, params, self._log10_mets)
        sfzh = w_age[:, :, None] * w_met[:, None, :]
        for ax_name, ax_vals in self._extra_axes:
            w_ax = self._axis_delta_weights(ax_vals, params[ax_name])
            sfzh = sfzh[..., None] * w_ax.reshape(
                w_ax.shape[0], *([1] * (sfzh.ndim - 1)), -1)
        if self.n_particles is not None:
            # multinomial particle realization over the cells
            flat = sfzh.reshape(sfzh.shape[0], -1)
            cells = particle_cells(flat, self.particle_seed,
                                   params["_row_idx"], params["_theta"],
                                   self.n_particles)
            sfzh = particle_counts_sfzh(cells, flat.shape[1],
                                        self.n_particles).reshape(sfzh.shape)
        sfzh = sfzh * mass.reshape(-1, *([1] * (sfzh.ndim - 1)))
        b = sfzh.shape[0]
        sfh_mass = (sfzh.reshape(b, sfzh.shape[1], -1).sum(dim=2)
                    if marginal else None)
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

    @staticmethod
    def _young_prefix(grid, age_pivot_log10: float) -> int:
        """The cells younger than the pivot as the length of a prefix of C:
        `_sfzh` lays the SFZH out age-major (ages outermost, each age's
        `cells_per_age` cells together), and the grid's ages must ascend,
        so the young ages' cells come first (asserted)."""
        ages = np.asarray(grid.log10_ages, np.float64)
        assert np.all(np.diff(ages) > 0), "the grid's ages must ascend"
        young = np.repeat(ages < age_pivot_log10, grid.cells_per_age)
        n = int(young.sum())
        assert young[:n].all(), "the young cells must lead the SFZH"
        return n

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

    @traced("sed.band_integral")
    def _photometry_batch(self, fnu_njy, z):
        """(B, L) f_ν, (B,) z -> (B, F): the spectra path's filter integral.

        "xla": `_photometry_one`. "pallas": interp integrates against the
        plain knot matrix, conv against the extended filter table, both with
        den knots interpolated at the same knots; roll and bank take K3's
        exact numerators at the 1/8-column snapped shift over the exact den
        of that shift."""
        if self.photometry_backend != "pallas":
            return self._photometry_one(fnu_njy, z)
        n_f = len(self.filters)
        s = self._shift_of_z(z)
        fnu_w = fnu_njy * self._wlam
        if self._variant == "interp":
            l0, l1 = self._sup
            acc = knot_product(fnu_w[:, l0:l1], self._knot_matrix)
            return window_ratio(acc, self._den_f8, s, None,
                                self._n_knots, self._knot_delta,
                                self._interp_order)[:, :n_f]
        if self._variant == "conv":
            l0, l1 = self._sup
            return self._conv_ratio(fnu_w[:, l0:l1], s)
        s4 = shift_decompose(s, self._max_shift)
        num = shift_photometry_num(fnu_w, self._subshift_table, s4)[:, :n_f]
        return num / torch.clamp(self._den_table[s4.long()], min=1.0e-30)

    def _conv_ratio(self, fw, s):
        """(B, L_sup) flux × dλ/λ over the λ support + (B,) shifts -> (B, F)
        num/den of the conv engine (windowed over each filter's support)."""
        num = conv_photometry_num(
            fw, self._filter_table, self._n_knots, s, delta=self._knot_delta,
            order=self._interp_order, l_offset=self._sup[0],
            filter_cols=self._filter_cols)
        den = _knot_interp(self._den_knots, s, self._n_knots,
                           self._knot_delta, self._interp_order)
        return num / torch.clamp(den, min=1.0e-30)

    def _photometry_fused(self, lnu, z):
        """(B, L_sup) support-trimmed rest L_ν + (B,) z -> (B, F) nJy over
        the whole knot table (the plain route K2 replaces): for interp the
        IGM rides the IGM-baked knot matrix, for conv it is a per-galaxy row
        lerp over the support; the observed-frame scale is a scalar per
        galaxy because photometry is linear in f_ν.

        The scale multiplies as two factors, 1/d19 and (1+z)·1e-6/(4π d19):
        against the ratio's ~1e31 the one combined factor would put the
        reverse-mode partial Σ_f g_f·ratio_f past float32's range once
        |∂ log L/∂f| reaches ~1e7 (a bright galaxy far from its data),
        and the gradient would be NaN; each factor's partial stays in
        range. The JAX package multiplies by the combined scale."""
        s = self._shift_of_z(z)
        if self._variant == "conv":
            l0, l1 = self._sup
            t_igm = self._igm_transmission(1.0 + z)
            if not isinstance(t_igm, float):
                t_igm = t_igm[:, l0:l1]
            ratio = self._conv_ratio(lnu * t_igm * self._wlam_sup, s)
        else:
            acc = knot_product(lnu * self._wlam_sup, self._m_igm)
            ratio = window_ratio(acc, self._den_f8, s, None, self._n_knots,
                                 self._knot_delta, self._interp_order
                                 )[:, :len(self.filters)]
        inv_d = 1.0 / self._d19_of_z(z)
        return ((ratio * inv_d[:, None])
                * ((1.0 + z) * (1.0e-6 / _FOUR_PI) * inv_d)[:, None])

    def _mega_supported(self) -> bool:
        """Static gate for K2: the kernel route of the JAX megakernel's
        envelope (interp variant, order 1 or 3, a static fesc, one dust
        screen, no dust emission, F8 ≤ 128), and not `_mega_off`. Unlike
        the JAX package there is no λ-count gate: that crossover was
        measured on a TPU."""
        return (self.photometry_backend == "pallas"
                and self._window_mega_supported())

    def _photometry_mega(self, sfzh, z, tau_v, tau_bc=None,
                         n_young: int = 0, fesc_row=None):
        """(B, C) SFZH + (B,) z/τ_V (and the birth cloud's τ_BC over the
        first `n_young` cells, or the rows' escape fractions) -> (B, F) nJy
        through K2, one launch."""
        out = fused_sed_photometry(
            sfzh, self._shift_of_z(z), tau_v, self._scale_of_z(z),
            self._mega_tables, self._n_knots, self._knot_delta, self._f8,
            order=self._interp_order, fesc=self._static_fesc(),
            tau_bc=tau_bc, n_young=n_young, fesc_row=fesc_row)
        return out[:, :len(self.filters)]

    # ------------------------------------------------------------------
    # z-sorted window engine
    # ------------------------------------------------------------------
    def _overrides_forward_model(self) -> bool:
        """True for a subclass with its own `_core` or `_apply_emission`:
        K1, K2 and the window bodies compute the stellar grid's forward
        model and would silently replace it."""
        cls = type(self)
        return (cls._core is not BatchSEDSimulator._core
                or cls._apply_emission is not BatchSEDSimulator._apply_emission)

    def _fesc_column(self) -> bool:
        """True when fesc is a θ column (Pacman emission: each row's
        escape fraction mixes its unscreened incident light with its
        screened reprocessed light)."""
        return isinstance(self.emission.fesc, str)

    def _static_fesc(self) -> float:
        """The kernels' static fesc: the emission's number with no
        reprocessed types, else 0 (a θ-column fesc rides `_screens`)."""
        em = self.emission
        if em.reprocessed_types or self._fesc_column():
            return 0.0
        return float(em.fesc)

    def _window_supported(self) -> bool:
        """The window bodies need the base class's forward model, the
        interp or conv tables, the ISM screen with either the birth cloud
        or a θ-column fesc or neither, a static fesc only where it is 0 or
        alone (no reprocessed types, no birth cloud), and no dust emission.
        K1 (`_window_mega_supported`) and K2 (`_mega_supported`) are gated
        on this too."""
        em = self.emission
        if self._fesc_column():
            fesc_ok = em.tau_v_bc_param is None
        else:
            fesc_ok = not (float(em.fesc) != 0.0
                           and (em.reprocessed_types
                                or em.tau_v_bc_param is not None))
        return (not self._overrides_forward_model()
                and self._variant in ("interp", "conv")
                and fesc_ok and not em.dust_emission)

    def _window_mega_supported(self) -> bool:
        """Extra gate for the fused body (K1): the interp variant,
        interpolation order 1 or 3, at most 128 bands (the knot product
        is bf16 in this package), and not `_mega_off` (the kernels have no
        gradient)."""
        return (self._window_supported() and self._variant == "interp"
                and self._interp_order in (1, 3)
                and self._f8 <= 128
                and not self._mega_off)

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

    def _screens(self, params, tau_v) -> dict:
        """The dust screens' per-row inputs of K1, K2 and the window
        bodies, as keyword arguments: {"tau_v": τ_V} for the ISM screen
        alone; with the birth cloud, τ_V and τ_BC side by side in one
        (2, B) tensor (rows "tau_v" and "tau_bc"; the second screen's one
        per-batch device step, span `sed.screens`) and "n_young", the young
        cells' prefix of C (`_young_prefix`); with a θ-column fesc, τ_V and
        the rows' escape fractions stacked the same way ("tau_v" and
        "fesc_row", the same span)."""
        em = self.emission
        if self._fesc_column():
            with span("sed.screens"):
                rows = torch.stack([tau_v, params[em.fesc]])
            return {"tau_v": rows[0], "fesc_row": rows[1]}
        if em.tau_v_bc_param is None:
            return {"tau_v": tau_v}
        with span("sed.screens"):
            depths = torch.stack([tau_v, params[em.tau_v_bc_param]])
        return {"tau_v": depths[0], "tau_bc": depths[1],
                "n_young": self._n_young}

    def _window_inputs(self, theta, row_offset: int = 0):
        """Per-row inputs of the window bodies for z-sorted θ: (sfzh,
        absolute shift s, observed-frame scale, static fesc, the screens'
        keyword arguments `_screens`)."""
        em = self.emission
        params = self.theta_dict(theta, row_offset)
        sfzh, _ = self._sfzh(params, marginal=False)
        z = self._param(params, "redshift", 0.0)
        tau_v = (params[em.tau_v_param] if em.tau_v_param is not None
                 else torch.zeros_like(z))
        return (sfzh, self._shift_of_z(z), self._scale_of_z(z),
                self._static_fesc(), self._screens(params, tau_v))

    def _window_calls(self, theta, sub: int, w_cols: int, kc: int, k0, l0):
        """Per sub-chunk of `theta` (n_sub·sub z-sorted rows on the device),
        yield (row slice, λ-column slice, knot-column slice, keyword
        arguments of `fused_window_photometry`, the one-sub-chunk K1);
        k0/l0 are the host-int window starts. Interp only."""
        delta, f8 = self._knot_delta, self._f8
        tables = self._mega_tables
        sfzh, s_abs, scale, fesc, screens = self._window_inputs(theta)
        for i, (k, l) in enumerate(zip(k0, l0)):
            r = slice(i * sub, (i + 1) * sub)
            cols = slice(l, l + w_cols)
            knots = slice(k * f8, (k + kc) * f8)
            rows = {key: v[r] if torch.is_tensor(v) else v
                    for key, v in screens.items()}
            if "fesc_row" in rows:
                rows["sed_inc"] = tables["inc"][:, cols]
            yield r, cols, knots, dict(
                sfzh=sfzh[r], s_rel=s_abs[r] - float(k * delta),
                scale=scale[r], sed_w=tables["sed"][:, cols],
                curve_w=tables["curve"][cols],
                knot_w=tables["knot"][cols, knots],
                den_w=tables["den"][k:k + kc], kc=kc, delta=delta,
                f8=f8, order=self._interp_order, fesc=fesc, **rows)

    def _window_grouped_args(self, theta, sub: int, w_cols: int, kc: int,
                             k0, l0, row_offset: int = 0) -> dict:
        """Keyword arguments of `fused_window_photometry_grouped` for every
        sub-chunk of `theta` at once (K1, one launch)."""
        sfzh, s_abs, scale, fesc, screens = self._window_inputs(theta,
                                                                row_offset)
        return dict(sfzh=sfzh, s=s_abs, scale=scale,
                    tables=self._mega_tables, k0=k0, l0=l0, sub=sub,
                    w_cols=w_cols, kc=kc, delta=self._knot_delta,
                    f8=self._f8, order=self._interp_order, fesc=fesc,
                    **screens)

    @traced("sed.window_body")
    def _zsorted_run_raw(self, theta, sub: int, w_cols: int, kc: int, k0,
                         l0, fused: bool = False, row_offset: int = 0):
        """Run a window body over every sub-chunk -> (n_sub·sub, F).

        `fused=True` launches K1 once for all sub-chunks; `fused=False` runs
        the staged body per sub-chunk: the two products and `_knot_interp`
        in plain torch, with dλ/λ applied after the dust screen as in the
        JAX package's staged body; with the birth cloud the young and the
        old cells are contracted apart, each behind its own screen, and with
        a θ-column fesc the incident and the reprocessed tables, each row's
        mix as in `_apply_emission`.
        """
        if fused:
            out = fused_window_photometry_grouped(
                **self._window_grouped_args(theta, sub, w_cols, kc, k0, l0,
                                            row_offset))
            return out[:, :len(self.filters)]
        em = self.emission
        delta, f8 = self._knot_delta, self._f8
        m_igm = self._window_knot_matrix()
        sfzh, s_abs, scale, fesc, screens = self._window_inputs(theta,
                                                                row_offset)
        tau_v, tau_bc = screens["tau_v"], screens.get("tau_bc")
        fesc_row = screens.get("fesc_row")
        out = torch.empty(theta.shape[0], len(self.filters),
                          dtype=torch.float32, device=theta.device)
        for i, (k, l) in enumerate(zip(k0, l0)):
            r = slice(i * sub, (i + 1) * sub)
            cols = slice(l, l + w_cols)
            curve = self._dust_curve_sup[None, cols]
            att = torch.exp(-tau_v[r, None] * curve)
            if tau_bc is not None:  # the gate makes fesc 0 here
                ny = screens["n_young"]
                att_young = torch.exp(-(tau_v[r, None] + tau_bc[r, None])
                                      * curve)
                lnu = (sfzh[r, :ny] @ self._t_mix[:ny, cols] * att_young
                       + sfzh[r, ny:] @ self._t_mix[ny:, cols] * att)
            elif fesc_row is not None:
                f = fesc_row[r, None]
                lnu = (f * (sfzh[r] @ self._t_inc[:, cols])
                       + (1.0 - f) * (sfzh[r] @ self._t_mix[:, cols]) * att)
            elif em.reprocessed_types:  # the gate makes fesc 0 here
                lnu = sfzh[r] @ self._t_mix[:, cols] * att
            else:
                lnu = (sfzh[r] @ self._t_mix[:, cols]) * (
                    fesc + (1.0 - fesc) * att)
            fw = lnu * self._wlam_sup[None, cols]
            acc = knot_product(fw, m_igm[cols, k * f8:(k + kc) * f8])
            phot = window_ratio(acc, self._den_f8[k:k + kc],
                                s_abs[r] - float(k * delta), scale[r], kc,
                                delta, self._interp_order)
            out[r] = phot[:, :out.shape[1]]
        return out

    def photometry_zsorted_device(self, theta, sub_chunk: int = 1024,
                                  row_offset: int = 0,
                                  kc: int | None = None,
                                  w_cols: int | None = None,
                                  fused: bool = False,
                                  validate_plan: bool = False,
                                  starts: tuple | None = None):
        """θ (B, P) on the device, rows sorted by ascending redshift (not
        checked) -> (B, F) photometry [nJy] on the device.

        When (kc, w_cols) are omitted they are planned from θ's redshifts.
        Caller-supplied plans are trusted unless `validate_plan=True`: a plan
        too small for the batch would clamp the windows and return wrong
        fluxes. The per-sub-chunk window starts are computed on the device
        and read back once per call (see `_plan_windows`), unless `starts`
        gives them: (k0, l0), host ints, one pair per sub-chunk, planned
        with the supplied (kc, w_cols), as a run's plan gives each of its
        batches its slice; the call then reads nothing back. When the
        window would be the whole table, the batch takes the dense
        `photometry`.
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
            theta, sub_chunk, kc, w_cols, validate_plan, starts)
        if k0 is None:  # the window is the whole table
            return self.photometry(theta[:b], row_offset=row_offset)
        out = self._zsorted_run_raw(theta, sub, w_cols, kc, k0, l0,
                                    fused=fused, row_offset=row_offset)
        return out[:b]

    def photometry_zsorted(self, theta, sub_chunk: int = 1024,
                           row_offset: int = 0, kc: int | None = None,
                           w_cols: int | None = None, fused: bool = False):
        """Host form of the window engine: θ (B, P) host array with rows
        sorted by ascending redshift (checked) -> (B, F) numpy photometry
        [nJy]. Planned on the device by `_plan_windows`; a supplied
        (kc, w_cols) is validated against the batch. Unsorted θ raises: call
        `photometry` for it."""
        theta = np.atleast_2d(np.asarray(theta, np.float32))
        if "redshift" in self.param_names:
            z = theta[:, self.param_names.index("redshift")]
            if np.any(np.diff(z) < 0.0):
                raise ValueError(
                    "photometry_zsorted needs rows sorted by ascending "
                    "redshift; sort θ (library row order is exchangeable) "
                    "or use .photometry()")
        out = self.photometry_zsorted_device(
            theta, sub_chunk=sub_chunk, row_offset=row_offset, kc=kc,
            w_cols=w_cols, fused=fused,
            validate_plan=kc is not None and w_cols is not None)
        return out.cpu().numpy()

    @traced("sed.plan_windows")
    def _plan_windows(self, theta, sub_chunk: int, kc: int | None = None,
                      w_cols: int | None = None, validate_plan: bool = False,
                      starts: tuple | None = None):
        """Pad z-sorted θ to whole sub-chunks and plan their windows.

        Returns (padded θ, sub, kc, w_cols, k0, l0), k0/l0 as host int lists
        (one device readback, plus one for the span when the plan is not
        supplied or is validated), or None when the window is the whole
        table (kc = n_knots or w_cols = the λ support). Supplied `starts`
        (k0, l0), one per sub-chunk and planned with the supplied
        (kc, w_cols), are taken as given: no starts are computed and none
        is read back. A supplied plan needs both sizes, and the starts one
        entry per sub-chunk (ValueError)."""
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self.device)
        b = theta.shape[0]
        sub = int(min(sub_chunk, b))
        n_sub = int(np.ceil(b / sub))
        pad = n_sub * sub - b
        if pad:
            theta = torch.cat([theta, theta[-1:].expand(pad, -1)], dim=0)
        if starts is not None:
            if kc is None or w_cols is None:
                raise ValueError("window starts need their plan's (kc, "
                                 "w_cols)")
            k0, l0 = starts
            if len(k0) != n_sub or len(l0) != n_sub:
                raise ValueError(
                    f"window starts need one entry per sub-chunk: {n_sub} "
                    f"for {b} rows in sub-chunks of {sub}, got {len(k0)} "
                    f"and {len(l0)}")
        if starts is None or validate_plan:
            if "redshift" in self.param_names:
                z = theta[:, self.param_names.index("redshift")]
            else:
                z = torch.full((theta.shape[0],),
                               float(self.fixed_params.get("redshift", 0.0)),
                               dtype=torch.float32, device=self.device)
            k_flat = self._knot_interval_device(z)
        if kc is None or w_cols is None or validate_plan:
            with span("readback.plan_span"):
                knots = int(torch.max(k_flat[sub - 1::sub] - k_flat[::sub]))
            kc_req, w_req = self._zsorted_plan(knots)
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
        if starts is None:
            k0, l0 = self._window_starts(k_flat[::sub].to(torch.int64), kc,
                                         w_cols)
            with span("readback.window_starts"):
                k0, l0 = torch.stack([k0, l0]).tolist()
        return theta, sub, int(kc), int(w_cols), k0, l0

    # ------------------------------------------------------------------
    # public batched API (the dense path)
    # ------------------------------------------------------------------
    def _core(self, theta, want_spectra: bool, fused: bool = False,
              row_offset: int = 0):
        """θ (B, P) -> dict of (B, ...) outputs before the filter integral.

        `fused`: photometry only; skip `_observe` and return the λ-support
        rest L_ν (the distance scale is applied after the band ratio)."""
        params = self.theta_dict(theta, row_offset)
        sfzh, sfh_mass = self._sfzh_asking(params, marginal=want_spectra)
        z = self._param(params, "redshift", 0.0)
        if fused:
            trim = not self.emission.dust_emission
            lnu, _ = self._apply_emission(params, sfzh, trimmed=trim)
            if not trim:
                lnu = lnu[:, self._sup[0]:self._sup[1]]
            return {"_lnu": lnu, "_z": z}
        with span("sed.dense"):
            lnu, intrinsic = self._apply_emission(params, sfzh)
            out = {"fnu_njy": self._observe(params, lnu), "_z": z}
        if want_spectra:
            out.update(lnu=lnu, lnu_intrinsic=intrinsic, sfh_mass=sfh_mass,
                       sfzh=sfzh)
        return out

    def simulate(self, theta, want_spectra: bool = False,
                 row_offset: int = 0):
        """θ (B, P) in any row order -> dict of (B, ...) tensors on the
        device: "photometry_njy" (B, F), and with `want_spectra` also
        "fnu_njy", "lnu", "lnu_intrinsic" (B, L), "sfh_mass" (B, A) and
        "sfzh" (B, C). Row i has global index `row_offset` + i.

        Photometry-only calls on the pallas backend with the interp or conv
        variant take the λ support's rest L_ν: interp runs K2 when
        `_mega_supported`, else `_photometry_fused`; every other call
        observes the full spectra and integrates them
        (`_photometry_batch`)."""
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self.device)
        theta = torch.atleast_2d(theta)
        fused = (not want_spectra and self.photometry_backend == "pallas"
                 and self._variant in ("interp", "conv"))
        if fused and self._mega_supported():
            em = self.emission
            params = self.theta_dict(theta, row_offset)
            sfzh, _ = self._sfzh(params, marginal=False)
            z = self._param(params, "redshift", 0.0)
            tau_v = (params[em.tau_v_param] if em.tau_v_param is not None
                     else torch.zeros_like(z))
            return {"photometry_njy": self._photometry_mega(
                sfzh, z, **self._screens(params, tau_v))}
        res = self._core(theta, want_spectra, fused=fused,
                         row_offset=row_offset)
        z = res.pop("_z")
        if fused:
            return {"photometry_njy": self._photometry_fused(res["_lnu"], z)}
        out = {"photometry_njy": self._photometry_batch(res["fnu_njy"], z)}
        if want_spectra:
            out.update(res)
        return out

    def photometry(self, theta, row_offset: int = 0):
        """θ (B, P) -> (B, F) photometry [nJy]."""
        return self.simulate(theta, row_offset=row_offset)["photometry_njy"]

    # ------------------------------------------------------------------
    # emission lines
    # ------------------------------------------------------------------
    def _line_tables(self, ids: tuple):
        """Per selection of line ids, cached: (λ_line, dust curve at the
        lines, line luminosity, continuum and incident-continuum tables
        (C, Nl) scaled by 1e-10, float32 on the device)."""
        cache = self.__dict__.setdefault("_line_cache", {})
        if ids in cache:
            return cache[ids]
        lines = self.grid.lines
        ids_all = list(lines["ids"])
        sel = np.asarray([ids_all.index(i) for i in ids], np.int64)
        n_all = len(ids_all)
        lam_l_np = np.asarray(lines["wavelength"])[sel]
        dev, f32 = self.device, torch.float32
        lam_l = torch.as_tensor(lam_l_np.astype(np.float32), device=dev)
        # 1e-10: L up to ~1e33/Msun × 1e11 Msun overflows fp32 otherwise
        lum10 = torch.as_tensor(
            lines["luminosity"].reshape(-1, n_all)[:, sel] * 1e-10,
            dtype=f32, device=dev)
        cont10 = torch.as_tensor(
            lines["continuum"].reshape(-1, n_all)[:, sel] * 1e-10,
            dtype=f32, device=dev)
        em = self.emission
        curve_l = attenuation_curve(em.dust_law, lam_l, em.dust_params_dict())
        # incident continuum at the line wavelengths: with fesc > 0 the
        # realized continuum also holds the escaped incident light
        inc = self.grid.spectra[em.incident_type]
        inc = inc.reshape(-1, inc.shape[-1])
        lam_np = np.asarray(self.grid.lam)
        j_hi = np.clip(np.searchsorted(lam_np, lam_l_np), 1, len(lam_np) - 1)
        w_hi = (lam_l_np - lam_np[j_hi - 1]) / (lam_np[j_hi]
                                               - lam_np[j_hi - 1])
        inc10 = torch.as_tensor(
            (inc[:, j_hi - 1] * (1.0 - w_hi) + inc[:, j_hi] * w_hi) * 1e-10,
            dtype=f32, device=dev)
        # IGM at the lines: the lerp weights of λ_line on the rest grid
        i = torch.clamp(torch.searchsorted(self._lam, lam_l, right=True), 1,
                        self._lam.shape[0] - 1)
        x0, x1 = self._lam[i - 1], self._lam[i]
        frac = torch.where(lam_l < self._lam[0], 0.0,
                           torch.where(lam_l > self._lam[-1], 1.0,
                                       (lam_l - x0) / (x1 - x0)))
        cache[ids] = (lam_l, curve_l, lum10, cont10, inc10, (i, frac), sel)
        return cache[ids]

    def line_quantities(self, theta, line_ids=None, row_offset: int = 0):
        """Per-galaxy emission-line quantities from the grid's line tables.

        Line luminosity and continuum are SFZH contractions against the
        (C, Nl) tables, then the dust screen (birth-cloud aware), the
        channel mixing of `_line_mixing`, the IGM at the observed line
        wavelength and the distance. The numbers describe the realized
        spectrum when `emission.reprocessed_types` holds a nebular
        component.

        Returns a dict with "ids" and (B, Nl) numpy arrays: "luminosity"
        [erg/s, float64, dust-attenuated rest frame], "flux" [erg/s/cm²,
        observed], "ew_rest" and "ew_obs" [Å].
        """
        if self.grid.lines is None:
            raise ValueError(
                "grid has no line tables (grid.lines is None); load a grid "
                "whose HDF5 carries a lines/ group")
        ids = tuple(line_ids) if line_ids is not None else tuple(
            self.grid.lines["ids"])
        lam_l, curve_l, lum10, cont10, inc10, (i_l, f_l), sel = (
            self._line_tables(ids))
        theta = torch.atleast_2d(torch.as_tensor(
            theta, dtype=torch.float32, device=self.device))
        em = self.emission
        params = self.theta_dict(theta, row_offset)
        sfzh, _ = self._sfzh_asking(params, marginal=False)
        tau_v = (params[em.tau_v_param][:, None] if em.tau_v_param is not None
                 else torch.zeros_like(sfzh[:, :1]))
        att = torch.exp(-tau_v * curve_l)
        if em.tau_v_bc_param is not None:
            tau_bc = params[em.tau_v_bc_param][:, None]
            sf_y, sf_o = self._split_sfzh(sfzh)
            att_y = torch.exp(-(tau_v + tau_bc) * curve_l)
            lum = (sf_y @ lum10) * att_y + (sf_o @ lum10) * att
            cont = (sf_y @ cont10) * att_y + (sf_o @ cont10) * att
        else:
            lum = (sfzh @ lum10) * att
            cont = (sfzh @ cont10) * att
        lum, cont_total = self._line_mixing(params, lum, cont, sfzh @ inc10,
                                            sel, sfzh=sfzh, att=att)
        z = self._param(params, "redshift", 0.0)
        zp1 = 1.0 + z
        t_grid = self._igm_transmission(zp1)
        t_l = (1.0 if isinstance(t_grid, float)
               else t_grid[:, i_l - 1] * (1.0 - f_l) + t_grid[:, i_l] * f_l)
        inv_d = (1.0 / self._d19_of_z(z))[:, None]
        # L in 1e10 erg/s and d in 1e19 cm: divide by d19² before the
        # 1e-28/(4π) prefactor, which underflows fp32 on its own
        flux = (lum * t_l * inv_d * inv_d) * (1.0e-28 / _FOUR_PI)
        # EW = L_line λ²/(c L_cont); dividing first keeps c·L_cont in range
        ew_rest = (lum / torch.clamp(cont_total, min=1.0e-30)) * (
            lam_l**2 / C_AA_S)
        return {
            "ids": list(ids),
            "luminosity": lum.cpu().numpy().astype(np.float64) * 1.0e10,
            "flux": flux.cpu().numpy(),
            "ew_rest": ew_rest.cpu().numpy(),
            "ew_obs": (ew_rest * zp1[:, None]).cpu().numpy(),
        }

    def _line_mixing(self, params, lum, cont, inc_cont, sel, sfzh=None,
                     att=None):
        """Channel mixing of the line quantities (as `_apply_emission`): the
        lines ride the reprocessed channel, the realized continuum adds the
        escaped incident light unattenuated. Returns (line luminosity,
        continuum), (B, Nl) each."""
        em = self.emission
        fesc = (params[em.fesc][:, None] if isinstance(em.fesc, str)
                else float(em.fesc))
        return (1.0 - fesc) * lum, fesc * inc_cont + (1.0 - fesc) * cont

    def __call__(self, theta):
        return self.photometry(theta)

    @property
    def n_filters(self) -> int:
        return len(self.filters)

    @property
    def n_params(self) -> int:
        return len(self.param_names)
