"""SPS grid loading and representation.

Counterpart of `synference_tpu/grids.py`. The grid itself is host numpy:
`spectra[stype]` has shape (n_ages, n_mets, *extra, n_wav) in erg/s/Hz per
Msun formed; `spectra_device` hands the (A·Z·extra, L) contraction table to
torch on an explicit device. `SPSGrid.from_hdf5` reads the Synthesizer grid
HDF5 layout (groups `axes/` and `spectra/`, axis names in the `axes` file
attribute); `make_synthetic_grid`, `make_synthetic_multiaxis_grid` and
`make_synthetic_agn_grid` build the same deterministic grids as the JAX
package, so both packages can be held against each other on identical
inputs. The AGN grid's line luminosities (~1e44 erg/s) stay float64 on the
host: they overflow float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["SPSGrid", "make_synthetic_grid", "make_synthetic_multiaxis_grid",
           "make_synthetic_agn_grid"]


@dataclass
class SPSGrid:
    """An (age, metallicity, *extra axes, wavelength) SPS model grid.

    Attributes:
        name: grid identifier (e.g. "bpass-2.2.1-bin_chabrier03-0.1,300.0").
        log10_ages: (A,) log10(age/yr), ascending.
        metallicities: (Z,) absolute metallicities, ascending.
        lam: (L,) rest-frame wavelengths [Angstrom], ascending.
        spectra: dict spectra-type -> (A, Z, *extra, L) float32,
            erg/s/Hz/Msun. Synthesizer-compatible type names: "incident",
            "transmitted", "nebular", "total".
        extra_axes: ordered {name: (n_i,) ascending values} for any axes
            beyond (age, Z) — Cloudy-processed Synthesizer grids carry e.g.
            ionization parameter or α-enhancement (the reference inherits
            N-axis support from `synthesizer.grid.Grid`,
            reference library.py:2562-2619). Extra axes appear in `spectra`
            between the metallicity and wavelength axes, in dict order.
            Fix them at load (`fix_axes`) or expose them as θ parameters
            (BatchSEDSimulator interpolates along them per galaxy).
    """

    name: str
    log10_ages: np.ndarray
    metallicities: np.ndarray
    lam: np.ndarray
    spectra: dict = field(default_factory=dict)
    extra_axes: dict = field(default_factory=dict)
    # optional Cloudy line tables (Synthesizer grids carry a `lines/` group;
    # the reference records per-galaxy line quantities from them via
    # pipeline.get_lines/get_observed_lines, reference library.py:2611-2612):
    #   {"ids": [str], "wavelength": (Nl,) rest Å,
    #    "luminosity": (A, Z, Nl) erg/s/Msun, "continuum": (A, Z, Nl)
    #    erg/s/Hz/Msun}
    lines: dict | None = None

    # ------------------------------------------------------------------
    @property
    def n_ages(self) -> int:
        return len(self.log10_ages)

    @property
    def n_mets(self) -> int:
        return len(self.metallicities)

    @property
    def n_wav(self) -> int:
        return len(self.lam)

    @property
    def ages_yr(self) -> np.ndarray:
        return 10.0**self.log10_ages

    @property
    def age_bin_edges_yr(self) -> np.ndarray:
        """(A+1,) bin edges in linear yr: geometric midpoints in log space,
        closed at 0 below and at the top age above."""
        la = self.log10_ages
        mids = 0.5 * (la[1:] + la[:-1])
        lo = np.concatenate([[0.0], 10.0**mids])  # first bin starts at t=0
        hi = 10.0 ** np.concatenate([mids, [la[-1]]])
        return np.concatenate([lo, [hi[-1]]])

    @property
    def log10_metallicities(self) -> np.ndarray:
        return np.log10(self.metallicities)

    @property
    def extra_axis_names(self) -> tuple:
        return tuple(self.extra_axes.keys())

    @property
    def n_extra_cells(self) -> int:
        n = 1
        for v in self.extra_axes.values():
            n *= len(v)
        return n

    @property
    def cells_per_age(self) -> int:
        """Grid cells sharing one age bin: n_mets × extra-axis cells (the
        flat SFZH vector has n_ages × cells_per_age entries)."""
        return self.n_mets * self.n_extra_cells

    def fix_axes(self, values: dict) -> "SPSGrid":
        """Collapse extra axes at fixed values by linear interpolation.

        Args:
            values: {axis_name: value}; each named axis is removed from the
                returned grid, its spectra (and line tables) lerped between
                the two bracketing grid points (clamped at the ends).
        """
        unknown = set(values) - set(self.extra_axes)
        if unknown:
            raise KeyError(
                f"axes {sorted(unknown)} not in grid extra axes "
                f"{self.extra_axis_names}")
        grid = self
        for name, val in values.items():
            ax_names = grid.extra_axis_names
            pos = 2 + ax_names.index(name)  # spectra axis position
            vals = np.asarray(grid.extra_axes[name], np.float64)
            j = int(np.clip(np.searchsorted(vals, val) - 1, 0,
                            max(len(vals) - 2, 0)))
            if len(vals) == 1:
                frac = 0.0
            else:
                frac = float(np.clip(
                    (val - vals[j]) / (vals[j + 1] - vals[j]), 0.0, 1.0))

            def lerp_axis(arr, axis):
                lo = np.take(arr, j, axis=axis)
                hi = np.take(arr, min(j + 1, arr.shape[axis] - 1), axis=axis)
                return ((1.0 - frac) * lo + frac * hi).astype(arr.dtype)

            new_spectra = {
                t: lerp_axis(s, pos) for t, s in grid.spectra.items()
            }
            new_lines = None
            if grid.lines is not None:
                new_lines = dict(grid.lines)
                for k in ("luminosity", "continuum"):
                    new_lines[k] = lerp_axis(grid.lines[k], pos)
            new_extra = {k: v for k, v in grid.extra_axes.items()
                         if k != name}
            grid = SPSGrid(
                name=grid.name,
                log10_ages=grid.log10_ages,
                metallicities=grid.metallicities,
                lam=grid.lam,
                spectra=new_spectra,
                extra_axes=new_extra,
                lines=new_lines,
            )
        return grid

    def spectra_device(self, stype: str, device, dtype=torch.float32):
        """Grid spectra as a (A·Z·extra, L) tensor on `device`."""
        s = self.spectra[stype]
        return torch.as_tensor(
            np.ascontiguousarray(s.reshape(-1, s.shape[-1])),
            dtype=dtype, device=device)

    @property
    def is_log_uniform(self) -> bool:
        """True when lam is geometrically spaced (required for the
        shift-based photometry fast path in `sed.py`)."""
        ratios = np.diff(np.log10(self.lam))
        return bool(np.allclose(ratios, ratios[0], rtol=1e-4))

    def resampled_loglam(self, n_wav: int | None = None) -> "SPSGrid":
        """Return a copy with spectra interpolated onto a geometric λ grid.

        Real SPS grid files often mix linear/log λ spacing; the simulator
        needs uniform log spacing so a redshift becomes a constant index
        shift. Point interpolation is adequate at comparable resolution.
        """
        n = n_wav or self.n_wav
        new_lam = np.geomspace(self.lam[0], self.lam[-1], n)
        new_spectra = {}
        for t, s in self.spectra.items():
            flat = s.reshape(-1, s.shape[-1])
            out = np.empty((flat.shape[0], n), dtype=np.float32)
            for i in range(flat.shape[0]):
                out[i] = np.interp(new_lam, self.lam, flat[i])
            new_spectra[t] = out.reshape(*s.shape[:-1], n)
        return SPSGrid(
            name=self.name,
            log10_ages=self.log10_ages,
            metallicities=self.metallicities,
            lam=new_lam,
            spectra=new_spectra,
            extra_axes=self.extra_axes,
            lines=self.lines,  # λ-grid independent
        )

    # ------------------------------------------------------------------
    # axis-name vocabularies (Synthesizer grids vary in spelling)
    _AGE_AXIS_NAMES = ("ages", "age")
    _LOG_AGE_AXIS_NAMES = ("log10ages", "log10age")
    _MET_AXIS_NAMES = ("metallicities", "metallicity")

    @classmethod
    def from_hdf5(cls, path: str, spectra_types: tuple = None,
                  fixed_axes: dict | None = None) -> "SPSGrid":
        """Load a Synthesizer-format grid HDF5, including N-axis grids.

        Layout (as consumed by the reference via `synthesizer.grid.Grid`):
        `axes` file attr lists axis names IN STORAGE ORDER; datasets under
        `axes/` ("ages" [yr] or "log10ages"/"log10age",
        "metallicities"/"metallicity", plus any extra Cloudy axes such as
        "ionisation_parameter" or "alpha_enhancement");
        `spectra/wavelength` [Angstrom]; each other dataset under `spectra/`
        is a spectra type with one axis per `axes` entry plus trailing λ.
        Spectra are normalized to (age, Z, *extra, L) regardless of the
        file's axis order.

        Args:
            fixed_axes: optional {axis_name: value} — collapse those extra
                axes at load by interpolation (see `fix_axes`).
        """
        import h5py

        with h5py.File(path, "r") as f:
            axes_grp = f["axes"]
            declared = [
                a.decode() if isinstance(a, bytes) else str(a)
                for a in np.atleast_1d(f.attrs.get(
                    "axes", list(axes_grp.keys())))
            ]

            def _read_axis(*names):
                # the `axes` attr and the dataset names can use different
                # spellings of the same axis (e.g. attr "ages", dataset
                # "log10ages") — resolve against the vocabulary
                for n in names:
                    if n in axes_grp:
                        return n, np.asarray(axes_grp[n][:], np.float64)
                raise KeyError(
                    f"none of {names} found under axes/ of {path}")

            age_pos = met_pos = None
            log10_ages = mets = None
            extra = {}
            age_vocab = cls._AGE_AXIS_NAMES + cls._LOG_AGE_AXIS_NAMES
            for pos, ax in enumerate(declared):
                if ax in age_vocab:
                    used, vals = _read_axis(ax, *age_vocab)
                    age_pos = pos
                    log10_ages = (
                        vals if used in cls._LOG_AGE_AXIS_NAMES
                        else np.log10(vals))
                elif ax in cls._MET_AXIS_NAMES:
                    met_pos, (_, mets) = pos, _read_axis(
                        ax, *cls._MET_AXIS_NAMES)
                else:
                    extra[ax] = _read_axis(ax)[1]
            if log10_ages is None or mets is None:
                raise KeyError(
                    f"grid {path} axes {declared} lack an age or "
                    "metallicity axis")
            # destination order: age, Z, extras in declared order
            extra_pos = [p for p, ax in enumerate(declared)
                         if ax not in cls._AGE_AXIS_NAMES
                         and ax not in cls._LOG_AGE_AXIS_NAMES
                         and ax not in cls._MET_AXIS_NAMES]
            src_order = [age_pos, met_pos, *extra_pos]

            def _normalize(arr):
                if arr.ndim != len(declared) + 1:
                    raise ValueError(
                        f"spectra array rank {arr.ndim} does not match "
                        f"{len(declared)} declared axes + wavelength")
                return np.ascontiguousarray(np.transpose(
                    arr, (*src_order, arr.ndim - 1)))

            spec_grp = f["spectra"]
            lam = np.asarray(spec_grp["wavelength"][:], dtype=np.float64)
            types = spectra_types or [
                k for k in spec_grp.keys() if k != "wavelength"
            ]
            spectra = {
                t: _normalize(np.asarray(spec_grp[t][:], dtype=np.float32))
                for t in types
            }
            name = str(f.attrs.get("grid_name", path.rsplit("/", 1)[-1]))
            lines = cls._read_lines(f)
            if lines is not None and lines["luminosity"].ndim > 2:
                lines = dict(lines)
                for k in ("luminosity", "continuum"):
                    arr = lines[k]
                    lines[k] = np.ascontiguousarray(np.transpose(
                        arr, (*src_order, arr.ndim - 1)))
        grid = cls(
            name=name,
            log10_ages=log10_ages,
            metallicities=mets,
            lam=lam,
            spectra=spectra,
            extra_axes=extra,
            lines=lines,
        )
        if fixed_axes:
            grid = grid.fix_axes(fixed_axes)
        return grid

    @staticmethod
    def _read_lines(f) -> dict | None:
        """Read the optional `lines/` group: either the stacked layout
        (datasets id/wavelength/luminosity/continuum) or Synthesizer's
        per-line-subgroup layout (`lines/<id>/{luminosity,continuum}` with a
        `wavelength` attribute)."""
        if "lines" not in f:
            return None
        grp = f["lines"]
        if "luminosity" in grp and not hasattr(grp["luminosity"], "keys"):
            ids_raw = grp["id"][:] if "id" in grp else grp["ids"][:]
            ids = [i.decode() if isinstance(i, bytes) else str(i)
                   for i in ids_raw]
            # float64: AGN-grid line luminosities (~1e44 erg/s) overflow
            # fp32; `line_quantities` rescales before the device cast
            lum = np.asarray(grp["luminosity"][:], np.float64)
            cont = np.asarray(grp["continuum"][:], np.float64)
            wav = np.asarray(grp["wavelength"][:], np.float64)
            if (lum.ndim >= 3 and lum.shape[0] == len(ids)
                    and lum.shape[-1] != len(ids)):
                # lines-first layout -> lines-last. The trailing-axis check
                # disambiguates grids where n_ages coincidentally equals the
                # line count (ambiguous shapes are left as lines-last, the
                # layout this writer produces).
                lum = np.moveaxis(lum, 0, -1)
                cont = np.moveaxis(cont, 0, -1)
            out = {"ids": ids, "wavelength": wav,
                   "luminosity": lum, "continuum": cont}
            if "region" in grp:
                out["region"] = [r.decode() if isinstance(r, bytes)
                                 else str(r) for r in grp["region"][:]]
            return out
        ids, wavs, lums, conts = [], [], [], []
        for lid in grp.keys():
            sub = grp[lid]
            if not hasattr(sub, "keys") or "luminosity" not in sub:
                continue
            ids.append(lid)
            wavs.append(float(sub.attrs.get(
                "wavelength", sub["wavelength"][()] if "wavelength" in sub
                else 0.0)))
            lums.append(np.asarray(sub["luminosity"][:], np.float64))
            conts.append(np.asarray(sub["continuum"][:], np.float64))
        if not ids:
            return None
        return {
            "ids": ids,
            "wavelength": np.asarray(wavs, np.float64),
            "luminosity": np.stack(lums, axis=-1),
            "continuum": np.stack(conts, axis=-1),
        }

    def to_hdf5(self, path: str) -> None:
        import h5py

        with h5py.File(path, "w") as f:
            f.attrs["axes"] = ["ages", "metallicities",
                               *self.extra_axis_names]
            f.attrs["grid_name"] = self.name
            ax = f.create_group("axes")
            ax.create_dataset("ages", data=self.ages_yr)
            ax.create_dataset("metallicities", data=self.metallicities)
            for k, v in self.extra_axes.items():
                ax.create_dataset(k, data=np.asarray(v))
            sp = f.create_group("spectra")
            sp.create_dataset("wavelength", data=self.lam)
            for t, s in self.spectra.items():
                sp.create_dataset(t, data=s)
            if self.lines is not None:
                lg = f.create_group("lines")
                lg.create_dataset(
                    "id", data=np.asarray(self.lines["ids"], dtype="S"))
                lg.create_dataset("wavelength",
                                  data=self.lines["wavelength"])
                lg.create_dataset("luminosity",
                                  data=self.lines["luminosity"])
                lg.create_dataset("continuum", data=self.lines["continuum"])
                if "region" in self.lines:
                    lg.create_dataset(
                        "region",
                        data=np.asarray(self.lines["region"], dtype="S"))


def make_synthetic_grid(
    n_ages: int = 48,
    n_mets: int = 8,
    n_wav: int = 2048,
    lam_min: float = 300.0,
    lam_max: float = 1.0e7,  # reach the FIR so energy-balance dust emission lands on-grid
    seed: int = 0,
    name: str = "synthetic_test_grid",
    line_strength: float = 1.0,
) -> SPSGrid:
    """Deterministic physically-shaped fake SPS grid for tests/benchmarks.

    Spectra are blackbody-like continua whose effective temperature falls with
    age, with a Lyman-break suppression, a Balmer-break feature and a
    metallicity-dependent UV slope — enough structure that photometry responds
    sensibly to every parameter. Units mimic real grids
    (~1e20 erg/s/Hz/Msun scale).
    """
    rng = np.random.default_rng(seed)
    log10_ages = np.linspace(5.0, 10.2, n_ages)
    metallicities = np.logspace(-4, -1.4, n_mets)
    lam = np.geomspace(lam_min, lam_max, n_wav)

    # effective temperature declines with age: 4e4 K (young) -> 3e3 K (old)
    t_eff = 10.0 ** (4.6 - 0.25 * (log10_ages - 5.0))[:, None, None]
    lam_b = lam[None, None, :]
    # Planck-ish shape in L_nu: B_nu ∝ nu^3/(exp(hnu/kT)-1); use lam form
    hc_k = 1.43877688e8  # hc/k in Angstrom*K
    x = hc_k / (lam_b * t_eff)
    planck = (lam_b ** -3.0) / np.expm1(np.clip(x, 1e-6, 60.0))
    # normalize each (age, Z) spectrum to a fixed bolometric-ish scale that
    # declines with age (older populations are dimmer per unit mass)
    lum_scale = 10.0 ** (21.5 - 0.8 * (log10_ages - 5.0) / 5.2)[:, None, None]
    met_slope = (np.log10(metallicities) + 2.7)[None, :, None]
    uv_tilt = (lam_b / 5500.0) ** (0.08 * met_slope)

    spec = planck / planck.max(axis=-1, keepdims=True) * lum_scale * uv_tilt
    # Lyman break at 912 A
    spec = spec * np.where(lam_b < 912.0, 0.01, 1.0)
    # Balmer break grows with age
    balmer = 1.0 - 0.4 * ((log10_ages - 5.0) / 5.2)[:, None, None] * (
        lam_b < 3646.0
    )
    spec = spec * balmer
    # small deterministic wiggles standing in for absorption features
    wig = 1.0 + 0.05 * np.sin(lam_b / 200.0 + met_slope * 3.0)
    spec = (spec * wig).astype(np.float32)

    # "nebular"/"transmitted" variants: transmitted = incident minus ionizing,
    # nebular = reprocessed ionizing energy re-emitted with flat continuum +
    # a few emission-line spikes (young ages only).
    ionizing = np.where(lam_b < 912.0, spec, 0.0)
    transmitted = spec - ionizing
    young = (log10_ages < 7.0)[:, None, None]
    line_lams = np.array([1216.0, 3727.0, 4861.0, 5007.0, 6563.0])
    line_ids = ["H 1 1215.67A", "O 2 3726.03A", "H 1 4861.32A",
                "O 3 5006.84A", "H 1 6562.80A"]
    lines = np.zeros_like(spec)
    profs = []
    for ll in line_lams:
        prof = np.exp(-0.5 * ((lam - ll) / (ll * 0.002)) ** 2)
        profs.append(prof)
        lines += prof[None, None, :]
    neb_scale = ionizing.sum(axis=-1, keepdims=True) * 1.0e-4
    nebular = (young * neb_scale
               * (line_strength * lines + 0.01)).astype(np.float32)
    total = (transmitted + nebular).astype(np.float32)

    # line tables consistent with the nebular spikes: L_line = ∫ L_ν dν over
    # each profile; continuum = the underlying spectrum at λ_line without
    # the line's own spike (what a Cloudy grid's `lines/` group records)
    c_aa_s = 2.99792458e18
    dnu = np.abs(np.gradient(c_aa_s / lam))  # Hz per bin, ascending-λ grid
    lum_tab = np.zeros((n_ages, n_mets, len(line_lams)), np.float32)
    cont_tab = np.zeros_like(lum_tab)
    for li, (ll, prof) in enumerate(zip(line_lams, profs)):
        spike = young * neb_scale * line_strength * prof[None, None, :]
        lum_tab[..., li] = (spike * dnu).sum(-1)
        k = int(np.argmin(np.abs(lam - ll)))
        cont_tab[..., li] = total[..., k] - spike[..., k]

    del rng  # reserved for future stochastic features; grid is deterministic
    return SPSGrid(
        name=name,
        log10_ages=log10_ages,
        metallicities=metallicities,
        lam=lam,
        spectra={
            "incident": spec,
            "transmitted": transmitted.astype(np.float32),
            "nebular": nebular,
            "total": total,
        },
        lines={
            "ids": line_ids,
            "wavelength": line_lams.astype(np.float64),
            "luminosity": lum_tab,
            "continuum": cont_tab,
        },
    )


def make_synthetic_multiaxis_grid(
    n_u: int = 5,
    log10_u: tuple = (-4.0, -1.0),
    axis_name: str = "ionisation_parameter",
    nebular_boost: float = 3.0e4,
    **grid_kwargs,
) -> SPSGrid:
    """A 3-axis (age, Z, U) Cloudy-style test grid.

    Mirrors the shape of Synthesizer Cloudy-processed grids that carry an
    ionization-parameter axis (the reference inherits N-axis support from
    `synthesizer.grid.Grid`, reference library.py:2562-2619). The nebular
    channel (continuum + line tables) scales monotonically with U while the
    stellar channels are U-independent — enough structure that fitting U as
    a free θ parameter is informative.
    """
    base = make_synthetic_grid(**grid_kwargs)
    # `make_synthetic_grid`'s nebular channel is ~1e-6 of the total (its
    # neb_scale mimics a heavily-suppressed ionizing continuum); boost it
    # to the few-percent level real Cloudy grids show so the U axis is
    # photometrically informative in tests
    if nebular_boost != 1.0:
        neb = base.spectra["nebular"] * np.float32(nebular_boost)
        base.spectra["nebular"] = neb
        base.spectra["total"] = (base.spectra["transmitted"]
                                 + neb).astype(np.float32)
        base.lines["luminosity"] = (
            base.lines["luminosity"] * np.float32(nebular_boost))
        # rebuild spike-free continuum at the boosted level: cont =
        # total − spike, and both the flat nebular floor and the spike
        # scale together, so cont_boost = trans_at_l + boost·(cont_base −
        # trans_at_l)
        lam = base.lam
        lam_l = np.asarray(base.lines["wavelength"])
        k_l = np.array([int(np.argmin(np.abs(lam - ll))) for ll in lam_l])
        trans_at_l = base.spectra["transmitted"][..., k_l]
        base.lines["continuum"] = (
            trans_at_l + nebular_boost
            * (base.lines["continuum"] - trans_at_l)).astype(np.float32)
    log_u = np.linspace(log10_u[0], log10_u[1], n_u)
    # nebular reprocessing efficiency rises with ionization parameter
    g_u = 10.0 ** (0.35 * (log_u + 2.5))  # (nU,)

    def expand(arr, scale):
        # (A, Z, L) -> (A, Z, nU, L) with per-U scaling
        return (arr[:, :, None, :]
                * scale[None, None, :, None]).astype(np.float32)

    ones = np.ones_like(g_u)
    nebular = expand(base.spectra["nebular"], g_u)
    transmitted = expand(base.spectra["transmitted"], ones)
    spectra = {
        "incident": expand(base.spectra["incident"], ones),
        "transmitted": transmitted,
        "nebular": nebular,
        "total": (transmitted + nebular).astype(np.float32),
    }
    lines = None
    if base.lines is not None:
        def expand_tab(arr, scale):
            # (A, Z, Nl) -> (A, Z, nU, Nl)
            return (arr[:, :, None, :]
                    * scale[None, None, :, None]).astype(np.float32)

        # Line-free continuum at λ_line for the U-scaled grid. The base
        # grid function defines cont = total − spike at the nearest λ column;
        # with total_u = transmitted + g_u·nebular and spike_u = g_u·spike,
        # algebra gives cont_u = (1 − g_u)·transmitted_at_λl + g_u·cont —
        # exact, no spike reconstruction needed.
        lam = base.lam
        lam_l = np.asarray(base.lines["wavelength"])
        k_l = np.array([int(np.argmin(np.abs(lam - ll))) for ll in lam_l])
        trans_at_l = base.spectra["transmitted"][..., k_l]  # (A, Z, Nl)
        cont_u = (
            (1.0 - g_u)[None, None, :, None] * trans_at_l[:, :, None, :]
            + g_u[None, None, :, None]
            * base.lines["continuum"][:, :, None, :]
        ).astype(np.float32)
        lines = {
            "ids": list(base.lines["ids"]),
            "wavelength": base.lines["wavelength"],
            "luminosity": expand_tab(base.lines["luminosity"], g_u),
            "continuum": cont_u,
        }
    return SPSGrid(
        name=base.name + "_cloudy3axis",
        log10_ages=base.log10_ages,
        metallicities=base.metallicities,
        lam=base.lam,
        spectra=spectra,
        extra_axes={axis_name: log_u},
        lines=lines,
    )


def make_synthetic_agn_grid(
    n_u: int = 6,
    n_nh: int = 4,
    n_wav: int = 2048,
    lam_min: float = 300.0,
    lam_max: float = 1.0e7,
    log10_u: tuple = (-3.0, 0.0),
    log10_nh: tuple = (2.0, 6.0),
    name: str = "synthetic_agn_nlr_blr",
) -> SPSGrid:
    """Cloudy-style AGN grid: disk incident + NLR/BLR reprocessed tables.

    Mirrors the layout of the Cloudy-processed AGN grids Synthesizer's
    BlackHole emission models consume (the reference attaches BlackHole
    components with NLR/BLR reprocessing through them, reference
    library.py:1361-1419): degenerate (age, Z) stellar axes, AGN physics
    parameters as extra axes, spectra normalized **per unit 1e45 erg/s of
    bolometric disk luminosity** (`AGNGridSimulator(l_norm=45.0)` rescales
    by 10**(log10_l_agn - 45)).

    Axes (extra, values in log10):
        ionisation_parameter: log10 U at the illuminated face.
        hydrogen_density: log10 n_H [cm^-3].

    Spectra types:
        incident: bare accretion-disk continuum (axis-independent).
        nlr / blr: each region's emergent SED at covering fraction 1 —
            the disk continuum transmitted through the region plus its
            nebular (line + recombination-continuum) emission. Narrow
            forbidden+Balmer lines respond to U and are collisionally
            suppressed at high n_H; broad permitted lines strengthen
            mildly with n_H.

    The `lines/` group tabulates the strongest UV/optical AGN lines
    (luminosity + line-free continuum), same layout as stellar Cloudy
    grids, so `BatchSEDSimulator.line_quantities` works unchanged.
    """
    lam = np.geomspace(lam_min, lam_max, n_wav)
    log_u = np.linspace(log10_u[0], log10_u[1], n_u)
    log_nh = np.linspace(log10_nh[0], log10_nh[1], n_nh)
    c_aa_s = 2.99792458e18
    nu = c_aa_s / lam  # Hz, descending along ascending lam
    dnu = np.abs(np.gradient(nu))

    # --- accretion disk: nu^-0.5 big-blue-bump between an EUV rolloff and
    # an IR cutoff, unit-normalized bolometrically then scaled to 1e45 erg/s
    window = (1.0 / (1.0 + np.exp(np.clip(-(lam - 150.0) / 30.0, -60, 60)))
              * 1.0 / (1.0 + np.exp(np.clip((lam - 12000.0) / 1500.0,
                                            -60, 60))))
    shape = (nu / 1.0e15) ** -0.5 * window
    disk = shape / (shape * dnu).sum() * 1.0e45  # erg/s/Hz, integral = 1e45
    ion_mask = lam < 912.0
    l_ion = (disk * dnu)[ion_mask].sum()  # ionizing budget, erg/s

    u_c = log_u[:, None, None]   # (U, 1, 1) broadcasting over (U, N, L)
    nh_c = log_nh[None, :, None]
    lam_c = lam[None, None, :]

    # --- transmitted-through-region continua: ionizing column absorbed,
    # optical depth growing with n_H (clamped so some EUV always leaks)
    tau_ion = 2.0 + 0.8 * (nh_c - 2.0)
    transmit = np.where(lam_c < 912.0, np.exp(-np.clip(tau_ion, 0.0, 12.0)),
                        1.0)

    # --- line inventory: (id, lam, region, U-slope, nh-crit log10 or None)
    # narrow forbidden lines are suppressed above their critical densities;
    # permitted lines are not. U-slopes: high-ionization species strengthen
    # with U, low-ionization weaken (flux ∝ 10**(slope·(logU − logU_max))).
    line_defs = [
        ("H 1 1215.67A", 1215.67, "blr", 0.10, None),
        ("C 4 1548.19A", 1548.19, "blr", 0.55, None),
        ("C 3 1908.73A", 1908.73, "blr", 0.30, 5.5),
        ("Mg 2 2795.53A", 2795.53, "blr", -0.15, None),
        ("Ne 3 3868.76A", 3868.76, "nlr", 0.45, 5.9),
        ("O 2 3726.03A", 3726.03, "nlr", -0.35, 3.5),
        ("H 1 4861.32A", 4861.32, "nlr", 0.00, None),
        ("O 3 5006.84A", 5006.84, "nlr", 0.60, 5.8),
        ("H 1 6562.80A", 6562.80, "nlr", 0.00, None),
        ("N 2 6583.45A", 6583.45, "nlr", -0.25, 4.9),
    ]
    # base relative strengths (order as above): roughly Lyα-dominated UV,
    # [OIII]-dominated optical
    base_rel = np.array([1.0, 0.35, 0.12, 0.18, 0.05,
                         0.12, 0.10, 0.45, 0.30, 0.10])

    # region reprocessing efficiencies (fraction of ionizing luminosity
    # reprocessed at covering fraction 1)
    eff_nlr = 0.25 * 10.0 ** (0.30 * (u_c - log_u[-1]))       # (U,1,1)
    eff_blr = 0.20 * 10.0 ** (0.10 * (nh_c - log_nh[-1]))     # (1,N,1)

    # --- absolute per-line luminosities (U, N, Nl): at the reference
    # corner (U = U_max) each region's lines carry 75% of its reprocessed
    # budget, split by base_rel; away from it, U-slopes rescale each line
    # and collisional de-excitation *removes* energy (no renormalization —
    # a suppressed forbidden line's energy goes to heat, not other lines)
    rel_sum = {
        reg: sum(r for (_, _, rg, _, _), r in zip(line_defs, base_rel)
                 if rg == reg)
        for reg in ("nlr", "blr")
    }
    line_lums = np.zeros((n_u, n_nh, len(line_defs)))
    for li, ((_, ll, reg, slope, nh_crit), rel) in enumerate(
            zip(line_defs, base_rel)):
        eff = eff_nlr if reg == "nlr" else eff_blr
        w = (rel / rel_sum[reg]) * 10.0 ** (slope * (u_c - log_u[-1]))
        if nh_crit is not None:
            w = w / (1.0 + 10.0 ** (nh_c - nh_crit))
        line_lums[..., li] = (0.75 * eff * l_ion * w)[..., 0]

    def region_sed(region):
        """(U, N, L) emergent SED for one region at covering fraction 1."""
        eff = eff_nlr if region == "nlr" else eff_blr
        sig = 0.005 if region == "nlr" else 0.02  # σ/λ: ~2 px vs ~8 px
        lines_sum = np.zeros((n_u, n_nh, n_wav))
        for li, (_, ll, reg, _, _) in enumerate(line_defs):
            if reg != region:
                continue
            prof = np.exp(-0.5 * ((lam - ll) / (ll * sig)) ** 2)
            prof = prof / (prof * dnu).sum()  # unit-luminosity profile /Hz
            lines_sum = lines_sum + line_lums[..., li:li + 1] * prof
        # recombination continuum: flat f_ν with a Balmer jump, confined
        # to 912 Å – 1 µm, carrying 25% of the reprocessed energy
        rec = ((lam_c >= 912.0) & (lam_c <= 10000.0)) * (
            0.4 + 0.6 * (lam_c > 3646.0))
        rec = rec / (rec * dnu).sum(axis=-1, keepdims=True)
        return (lines_sum + (0.25 * eff * l_ion) * rec
                + disk[None, None, :] * transmit)

    nlr = region_sed("nlr")
    blr = region_sed("blr")
    incident = np.broadcast_to(disk[None, None, :], (n_u, n_nh, n_wav))

    # --- lines/ tables: luminosity per line (U, N, Nl) + line-free
    # continuum (the disk transmitted continuum at λ_line)
    lam_l = np.array([d[1] for d in line_defs])
    k_l = np.array([int(np.argmin(np.abs(lam - ll))) for ll in lam_l])
    lum_tab = line_lums
    cont_tab = (incident * transmit)[..., k_l]

    def shape5(a):  # (U, N, L) -> (1, 1, U, N, L) float32
        return a[None, None].astype(np.float32)

    return SPSGrid(
        name=name,
        log10_ages=np.array([6.0]),
        metallicities=np.array([0.02]),
        lam=lam,
        spectra={
            "incident": shape5(incident),
            "nlr": shape5(nlr),
            "blr": shape5(blr),
        },
        extra_axes={
            "ionisation_parameter": log_u,
            "hydrogen_density": log_nh,
        },
        lines={
            "ids": [d[0] for d in line_defs],
            "wavelength": lam_l.astype(np.float64),
            # float64 on the host: AGN line luminosities (~1e44 erg/s per
            # 1e45 erg/s bolometric) overflow fp32; `line_quantities`
            # rescales by 1e-10 before the device cast
            "luminosity": lum_tab[None, None].astype(np.float64),
            "continuum": cont_tab[None, None].astype(np.float64),
            # per-line emitting region: AGNGridSimulator scales each line
            # by its region's covering fraction
            "region": [d[2] for d in line_defs],
        },
    )
