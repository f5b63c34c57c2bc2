"""Combination of generated libraries into one.

Counterpart of `synference_tpu/combine.py`, numpy on the host as there:
bases generated once at a filler mass are combined by renormalising each
base's photometry (or, in `spectral_mode`, its spectra) to a target total
stellar mass split across the bases by combination weights, either over
every (redshift × mass × weight × base-row) combination
(`combine_libraries`) or row by row (`combine_libraries_matched`).
Photometry is linear in stellar mass at fixed θ, so the scale
w·10^m / m_base is exact. Supplementary columns scale with the mass where
`scale_supplementary` says so: all, none, the named ones, or "auto" by
their physics. The result is a library dict in the reference schema,
written with this package's `save_library_hdf5` when `out_path` is given.
"""

from __future__ import annotations

import numpy as np

from .library import save_library_hdf5

__all__ = ["combine_libraries", "combine_libraries_matched"]


def _as_rows(arr, n_names):
    """Accept (D, N) or (N, D) and return (D, N)."""
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError("expected a 2-D array")
    if arr.shape[0] != n_names:
        arr = arr.T
    if arr.shape[0] != n_names:
        raise ValueError("array shape matches neither (D, N) nor (N, D)")
    return arr


# Whether each known supplementary quantity scales linearly with the mass
# renormalization factor (fluxes/luminosities/SFRs/masses do; magnitudes,
# ratios, ages, colors, EWs and other mass-invariant quantities do not —
# the reference dispatches the same decision on unyt dimensions,
# library.py:3865-3881 + utils.check_scaling utils.py:946-990).
_SUPP_MASS_SCALES = {
    "m_uv": False, "app_m_uv": False,        # magnitudes: shift, not scale
    "sfr_10": True, "sfr_100": True,         # mass/time
    "burstiness": False,                     # SFR ratio
    "mass_weighted_age": False, "lum_weighted_age": False,
    "flux_weighted_age": False,
    "beta_uv": False, "d4000": False,
    "t10": False, "t50": False, "t90": False,
    "u_minus_v": False, "v_minus_j": False,
    "balmer_decrement": False,
    "ew_halpha": False, "ew_hbeta": False, "ew_oiii": False,
    "n_ion": True,                           # photons/s
    "xi_ion": False,                         # Ndot/L_UV ratio
    "surviving_mass": True,
}

# unit-string fallback for user-supplied columns: substrings that mark a
# mass-scaling physical unit vs known invariant units
_SCALING_UNIT_TOKENS = ("erg", "jy", " w", "w/", "msun", "m_sun", "solmass",
                        "1/s", "photons")
_INVARIANT_UNITS = ("", "mag", "dimensionless", "yr", "myr", "gyr", "angstrom",
                    "aa", "dex")


def _auto_scale_mask(supp_names, supp_units=None):
    """Classify each supplementary column as mass-scaling or invariant."""
    units = list(supp_units) if supp_units is not None else [None] * len(
        supp_names)
    mask = np.zeros(len(supp_names), bool)
    for i, (name, unit) in enumerate(zip(supp_names, units)):
        if name in _SUPP_MASS_SCALES:
            mask[i] = _SUPP_MASS_SCALES[name]
        elif name.startswith("line_flux_") or name.startswith("line_lum_"):
            mask[i] = True
        elif name.startswith("line_ew_"):
            mask[i] = False
        elif unit is not None:
            u = str(unit).strip().lower()
            mask[i] = (u not in _INVARIANT_UNITS
                       and any(t in u for t in _SCALING_UNIT_TOKENS))
        else:
            raise ValueError(
                f"scale_supplementary='auto' cannot classify column "
                f"{name!r} (unknown name, no units stored). Pass an "
                f"explicit list of columns to scale instead.")
    return mask


def _supp_scale_mask(scale_supplementary, supp_names, supp_units=None):
    """(n_supp,) bool mask of which supplementary columns mass-scale.

    The reference scales only flux/luminosity-like quantities when
    renormalizing masses (unyt-dispatched, library.py:3865-3881). Without
    unyt plumbing the selection is either explicit — True/False applies to
    every column, an iterable of names scales exactly those (e.g. line
    fluxes but not M_UV — mixing mag-like and flux-like columns under one
    flag would silently corrupt one group) — or ``"auto"``, which
    classifies the built-in `SUPP_FUNCTIONS` names / `line_*` columns by
    their physics and falls back to the stored unit strings.
    """
    if isinstance(scale_supplementary, str):
        if scale_supplementary != "auto":
            raise ValueError(
                "scale_supplementary must be True/False, 'auto', or an "
                f"iterable of column names, got {scale_supplementary!r}")
        return _auto_scale_mask(supp_names, supp_units)
    if isinstance(scale_supplementary, (list, tuple, set, frozenset)):
        sel = set(scale_supplementary)
        unknown = sel - set(supp_names)
        if unknown:
            raise ValueError(
                f"scale_supplementary names {sorted(unknown)} not in "
                f"supplementary columns {list(supp_names)}")
        return np.array([n in sel for n in supp_names], bool)
    return np.full(len(supp_names), bool(scale_supplementary))


def _base_setup(libraries, base_names, redshift_param, mass_params,
                log_base_masses, spectral_mode=False):
    """Normalize per-base inputs -> list of dicts with unit-mass photometry
    (or unit-mass observed spectra when `spectral_mode`)."""
    n_bases = len(libraries)
    if base_names is None:
        base_names = [
            lib.get("model_name", f"base{i}")
            for i, lib in enumerate(libraries)
        ]
    if mass_params is None:
        mass_params = [None] * n_bases
    if np.isscalar(log_base_masses):
        log_base_masses = [float(log_base_masses)] * n_bases

    if spectral_mode:
        # spectra replace photometry as the combined observable (reference
        # `create_spectral_grid` -> `create_full_library(spectral_mode=True)`,
        # library.py:4887-4919: scaled "observed_spectra" instead of
        # per-filter fluxes; wavelengths stand in for filter codes)
        if "spectra" not in libraries[0]:
            raise ValueError("spectral_mode requires libraries with a "
                             "'spectra' dataset (generate want_spectra=True)")
        lam = np.asarray(libraries[0].get("wavelengths")) \
            if "wavelengths" in libraries[0] else None
        n_rows = (lam.shape[0] if lam is not None
                  else np.asarray(libraries[0]["spectra"]).shape[0])
        filter_codes = lam  # the reference stores wavelengths here
    else:
        filter_codes = list(libraries[0]["filter_codes"])
        n_rows = len(filter_codes)
    bases = []
    for i, lib in enumerate(libraries):
        if spectral_mode:
            if "spectra" not in lib:
                raise ValueError(f"base {i} has no spectra; cannot combine "
                                 "in spectral_mode")
            lam_i = (np.asarray(lib.get("wavelengths"))
                     if "wavelengths" in lib else None)
            if (filter_codes is not None and lam_i is not None
                    and not np.array_equal(lam_i, filter_codes)):
                raise ValueError(
                    f"base {i} has a different wavelength grid to base 0; "
                    "cannot combine spectra")
        elif list(lib["filter_codes"]) != filter_codes:
            raise ValueError(
                f"base {i} has different filters to base 0; cannot combine"
            )
        names = list(lib["parameter_names"])
        params = _as_rows(lib["parameters"], len(names))
        phot = _as_rows(lib["spectra" if spectral_mode else "photometry"],
                        n_rows)
        if redshift_param not in names:
            raise ValueError(f"base {i} lacks parameter {redshift_param!r}")
        z_rows = params[names.index(redshift_param)]
        if mass_params[i] is not None:
            m_base = 10.0 ** params[names.index(mass_params[i])]
        else:
            m_base = np.full(params.shape[1], 10.0 ** log_base_masses[i])
        # varying params carried through (mass + redshift become grid axes)
        keep = [
            j for j, p in enumerate(names)
            if p not in (redshift_param, mass_params[i])
        ]
        prefix = f"{base_names[i]}/" if n_bases > 1 else ""
        bases.append({
            "name": base_names[i],
            "phot_unit": phot / m_base[None, :],  # photometry per Msun
            "params": params[keep],
            "param_names": [prefix + names[j] for j in keep],
            "z": z_rows,
            "m_base": m_base,
            # supplementary kept RAW; mass scaling (if requested) divides by
            # m_base at combination time so scale_supplementary=False
            # passes values through untouched
            "supp": (
                _as_rows(lib["supplementary_parameters"],
                         len(lib["supplementary_parameter_names"]))
                if "supplementary_parameters" in lib else None
            ),
            "supp_names": list(lib.get("supplementary_parameter_names", [])),
            "supp_units": list(
                lib.get("supplementary_parameter_units", [])) or None,
        })
    supp_names = bases[0]["supp_names"]
    for b in bases[1:]:
        if b["supp_names"] != supp_names:
            raise ValueError(
                "all bases must share the same supplementary parameters"
            )
    return bases, filter_codes


def combine_libraries(
    libraries: list,
    log_stellar_masses,
    redshifts,
    combination_weights=None,
    base_names: list | None = None,
    log_base_masses=9.0,
    mass_params: list | None = None,
    redshift_param: str = "redshift",
    mass_name: str = "log_mass",
    scale_supplementary=True,
    out_path: str | None = None,
    z_atol: float = 1.0e-5,
    spectral_mode: bool = False,
) -> dict:
    """Outer-product combination: every (z × mass × weight × base-row) combo.

    Args:
        libraries: library dicts (from `load_library_hdf5` /
            `LibraryGenerator.generate`). Each base must contain rows at
            every redshift in `redshifts` (generate with zdist="delta" over
            a z grid, or filter beforehand).
        log_stellar_masses: (M,) target log10 total stellar masses.
        redshifts: (Z,) redshift grid; base rows are selected by
            |z_row − z| <= z_atol.
        combination_weights: (W, n_bases) rows of per-base mass fractions
            (None -> single base, weight 1).
        log_base_masses: scalar or per-base log10 mass the base photometry
            was generated at; ignored for bases with an entry in
            `mass_params`.
        mass_params: optional per-base parameter name holding each row's
            log10 mass (overrides log_base_masses for that base).
        scale_supplementary: which supplementary parameters scale by the
            same mass factor (the reference scales flux-like ones,
            library.py:3865-3881). True/False = all/none; an iterable of
            names scales exactly those columns (use this when mixing
            flux-like quantities with mag-like ones such as M_UV);
            ``"auto"`` classifies built-in supplementary/line columns by
            their physics (unit-string fallback for custom columns).
        spectral_mode: combine the bases' observed SPECTRA instead of their
            photometry (the reference's `create_spectral_grid` /
            `create_full_library(spectral_mode=True)`,
            library.py:4887-4919). Bases must share one wavelength grid;
            the result carries "spectra" + "wavelengths" keys and the saved
            file stores `Grid/Spectra` + `Grid/Wavelengths`. Spectra scale
            with stellar mass exactly like photometry (L_ν per Msun), so
            the renormalization is identical.

    Returns the combined library dict ((F, N)/(P, N) convention); parameter
    columns are [redshift, log_mass, weight_fraction?, base varying params].
    """
    libraries = list(libraries)
    n_bases = len(libraries)
    if combination_weights is None:
        if n_bases != 1:
            raise ValueError("combination_weights required for >1 base")
        combination_weights = np.ones((1, 1))
    weights = np.atleast_2d(np.asarray(combination_weights, np.float64))
    if weights.shape[1] != n_bases:
        raise ValueError("combination_weights must be (W, n_bases)")
    log_stellar_masses = np.atleast_1d(
        np.asarray(log_stellar_masses, np.float64)
    )
    redshifts = np.atleast_1d(np.asarray(redshifts, np.float64))

    bases, filter_codes = _base_setup(
        libraries, base_names, redshift_param, mass_params, log_base_masses,
        spectral_mode,
    )
    n_filt = bases[0]["phot_unit"].shape[0]
    supp_names = bases[0]["supp_names"]
    supp_mask = _supp_scale_mask(scale_supplementary, supp_names,
                                 bases[0].get("supp_units"))

    param_columns = [redshift_param, mass_name]
    if n_bases > 1:
        param_columns.append("weight_fraction")
    for b in bases:
        param_columns.extend(b["param_names"])

    # per-(mass, weight) scale for each base: (M*W,) after flattening
    masses = 10.0 ** log_stellar_masses  # (M,)
    mw_scale = masses[:, None, None] * weights[None, :, :]  # (M, W, n_bases)
    n_mw = masses.size * weights.shape[0]
    mw_scale = mw_scale.reshape(n_mw, n_bases)
    mw_logmass = np.repeat(log_stellar_masses, weights.shape[0])  # (M*W,)
    mw_wfrac = np.tile(weights[:, 0], masses.size)  # (M*W,)

    phot_out, par_out, supp_out = [], [], []
    for z in redshifts:
        masks = [np.abs(b["z"] - z) <= z_atol for b in bases]
        counts = [int(m.sum()) for m in masks]
        if any(c == 0 for c in counts):
            empty = [bases[i]["name"] for i, c in enumerate(counts) if c == 0]
            raise ValueError(f"no rows at z={z} in base(s) {empty}")
        # index outer product (n_combo, n_bases), same ordering the
        # reference's meshgrid(indexing="ij").T.reshape produces
        grids = np.meshgrid(*[np.arange(c) for c in counts], indexing="ij")
        combos = np.stack([g.ravel() for g in grids], axis=1)
        n_combo = combos.shape[0]

        phot = np.zeros((n_filt, n_mw, n_combo), np.float64)
        supp = (
            np.zeros((len(supp_names), n_mw, n_combo), np.float64)
            if supp_names else None
        )
        par_cols = [
            np.full((n_mw, n_combo), z),
            np.broadcast_to(mw_logmass[:, None], (n_mw, n_combo)),
        ]
        if n_bases > 1:
            par_cols.append(
                np.broadcast_to(mw_wfrac[:, None], (n_mw, n_combo))
            )
        for i, b in enumerate(bases):
            rows = np.where(masks[i])[0][combos[:, i]]  # (n_combo,)
            phot += (
                b["phot_unit"][:, rows][:, None, :]
                * mw_scale[None, :, i, None]
            )
            if supp is not None:
                s = b["supp"][:, rows][:, None, :]
                if supp_mask.any():
                    s_scaled = (s / b["m_base"][rows][None, None, :]) * (
                        mw_scale[None, :, i, None]
                    )
                    s = np.where(supp_mask[:, None, None], s_scaled, s)
                supp = supp + s
            for prow in b["params"][:, rows]:
                par_cols.append(np.broadcast_to(prow[None, :],
                                                (n_mw, n_combo)))
        phot_out.append(phot.reshape(n_filt, -1))
        par_out.append(np.stack([c.reshape(-1) for c in par_cols]))
        if supp is not None:
            supp_out.append(supp.reshape(len(supp_names), -1))

    combined = np.concatenate(phot_out, axis=1).astype(np.float32)
    result = {
        "parameters": np.concatenate(par_out, axis=1).astype(np.float32),
        "parameter_names": param_columns,
        "photometry_units": libraries[0].get("photometry_units", "nJy"),
    }
    if spectral_mode:
        result["spectra"] = combined
        result["filter_codes"] = filter_codes  # = the wavelength grid
        if filter_codes is not None:
            result["wavelengths"] = np.asarray(filter_codes)
    else:
        result["photometry"] = combined
        result["filter_codes"] = filter_codes
    if supp_names:
        result["supplementary_parameters"] = np.concatenate(
            supp_out, axis=1
        ).astype(np.float32)
        result["supplementary_parameter_names"] = supp_names
    if out_path is not None:
        save_library_hdf5(
            out_path,
            parameters=result["parameters"],
            parameter_names=result["parameter_names"],
            photometry=result.get("photometry"),
            spectra=result.get("spectra"),
            filter_codes=None if spectral_mode else result["filter_codes"],
            supplementary_parameters=result.get("supplementary_parameters"),
            supplementary_parameter_names=result.get(
                "supplementary_parameter_names"
            ),
            photometry_units=result["photometry_units"],
            model_name="+".join(b["name"] for b in bases),
            extra_datasets=(
                {"Wavelengths": result["wavelengths"]}
                if spectral_mode and "wavelengths" in result else None
            ),
        )
    return result


def combine_libraries_matched(
    libraries: list,
    log_stellar_masses,
    combination_weights=None,
    base_names: list | None = None,
    log_base_masses=9.0,
    mass_params: list | None = None,
    redshift_param: str = "redshift",
    mass_name: str = "log_mass",
    scale_supplementary=True,
    out_path: str | None = None,
    spectral_mode: bool = False,
) -> dict:
    """Matched (pre-drawn) combination: row k of every base describes the
    same galaxy (reference `create_full_library`, library.py:3982-4072) —
    no outer product; `log_stellar_masses` and `combination_weights` are
    per-row arrays of length N. With `spectral_mode` the combined
    observable is the bases' spectra (the reference's
    `create_spectral_grid` path, library.py:4887-4919).
    """
    libraries = list(libraries)
    n_bases = len(libraries)
    if combination_weights is None:
        if n_bases != 1:
            raise ValueError("combination_weights required for >1 base")
    bases, filter_codes = _base_setup(
        libraries, base_names, redshift_param, mass_params, log_base_masses,
        spectral_mode,
    )
    n = bases[0]["phot_unit"].shape[1]
    for i, b in enumerate(bases):
        if b["phot_unit"].shape[1] != n:
            raise ValueError(f"base {i} row count differs; cannot match rows")
    log_m = np.broadcast_to(
        np.asarray(log_stellar_masses, np.float64), (n,)
    )
    if combination_weights is None:
        weights = np.ones((n, 1))
    else:
        weights = np.broadcast_to(
            np.asarray(combination_weights, np.float64), (n, n_bases)
        )
    scale = (10.0 ** log_m)[:, None] * weights  # (N, n_bases)

    supp_names = bases[0]["supp_names"]
    supp_mask = _supp_scale_mask(scale_supplementary, supp_names,
                                 bases[0].get("supp_units"))
    phot = np.zeros((bases[0]["phot_unit"].shape[0], n), np.float64)
    supp = (
        np.zeros((len(supp_names), n), np.float64) if supp_names else None
    )
    par_cols = [bases[0]["z"], log_m]
    param_columns = [redshift_param, mass_name]
    if n_bases > 1:
        par_cols.append(weights[:, 0])
        param_columns.append("weight_fraction")
    for i, b in enumerate(bases):
        phot += b["phot_unit"] * scale[None, :, i]
        if supp is not None:
            s_scaled = (b["supp"] / b["m_base"][None, :]) * scale[None, :, i]
            supp += np.where(supp_mask[:, None], s_scaled, b["supp"])
        par_cols.extend(list(b["params"]))
        param_columns.extend(b["param_names"])

    result = {
        "parameters": np.stack(
            [np.asarray(c, np.float64) for c in par_cols]
        ).astype(np.float32),
        "parameter_names": param_columns,
        "photometry_units": libraries[0].get("photometry_units", "nJy"),
    }
    if spectral_mode:
        result["spectra"] = phot.astype(np.float32)
        result["filter_codes"] = filter_codes  # = the wavelength grid
        if filter_codes is not None:
            result["wavelengths"] = np.asarray(filter_codes)
    else:
        result["photometry"] = phot.astype(np.float32)
        result["filter_codes"] = filter_codes
    if supp_names:
        result["supplementary_parameters"] = supp.astype(np.float32)
        result["supplementary_parameter_names"] = supp_names
    if out_path is not None:
        save_library_hdf5(
            out_path,
            parameters=result["parameters"],
            parameter_names=result["parameter_names"],
            photometry=result.get("photometry"),
            spectra=result.get("spectra"),
            filter_codes=None if spectral_mode else result["filter_codes"],
            supplementary_parameters=result.get("supplementary_parameters"),
            supplementary_parameter_names=result.get(
                "supplementary_parameter_names"
            ),
            photometry_units=result["photometry_units"],
            model_name="+".join(b["name"] for b in bases),
            extra_datasets=(
                {"Wavelengths": result["wavelengths"]}
                if spectral_mode and "wavelengths" in result else None
            ),
        )
    return result
