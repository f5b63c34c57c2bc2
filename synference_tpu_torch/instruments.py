"""Realistic instrument filter curves (analytic, no download).

A copy of the band table and curve synthesis of `synference_tpu/instruments.py`
(importing it would pull in the JAX package's `__init__`): flat-top profiles
with sigmoid edges and a small deterministic in-band ripple, built from
published band parameters {code: (λ_pivot [Å], bandwidth [Å], peak
throughput)}. Measured curves load from SVO ascii files
(`load_filters_svo_ascii`) or a filter-collection HDF5 file
(`load_filters_hdf5`).
"""

from __future__ import annotations

import hashlib

import numpy as np

from .filters import Filter, FilterSet

__all__ = [
    "BAND_PARAMS",
    "PAPER_SURVEY_63",
    "NIRCAM_20",
    "realistic_filter",
    "load_instrument_filters",
    "load_filters_svo_ascii",
    "load_filters_hdf5",
]

_UM = 1.0e4  # μm -> Å

BAND_PARAMS = {
    # --- Paranal/VISTA (VIRCAM) ------------------------------------------
    "Paranal/VISTA.Z": (8800.0, 970.0, 0.84),
    "Paranal/VISTA.Y": (10210.0, 930.0, 0.86),
    "Paranal/VISTA.J": (12540.0, 1720.0, 0.88),
    "Paranal/VISTA.H": (16460.0, 2910.0, 0.89),
    "Paranal/VISTA.Ks": (21490.0, 3090.0, 0.87),
    # --- Subaru/HSC ------------------------------------------------------
    "Subaru/HSC.g": (4754.0, 1395.0, 0.80),
    "Subaru/HSC.r": (6175.0, 1494.0, 0.84),
    "Subaru/HSC.i": (7711.0, 1471.0, 0.86),
    "Subaru/HSC.z": (8898.0, 766.0, 0.82),
    "Subaru/HSC.Y": (9762.0, 786.0, 0.75),
    # --- CFHT/MegaCam ----------------------------------------------------
    "CFHT/MegaCam.u": (3754.0, 650.0, 0.68),
    "CFHT/MegaCam.g": (4750.0, 1540.0, 0.82),
    "CFHT/MegaCam.r": (6400.0, 1480.0, 0.84),
    "CFHT/MegaCam.i": (7760.0, 1550.0, 0.86),
    "CFHT/MegaCam.z": (9250.0, 1500.0, 0.78),
    # --- Euclid ----------------------------------------------------------
    "Euclid/VIS.vis": (7100.0, 3550.0, 0.78),
    "Euclid/NISP.Y": (10850.0, 2660.0, 0.80),
    "Euclid/NISP.J": (13750.0, 4040.0, 0.82),
    "Euclid/NISP.H": (17725.0, 4990.0, 0.82),
    # --- HST/ACS_WFC -----------------------------------------------------
    "HST/ACS_WFC.F435W": (4329.0, 1038.0, 0.38),
    "HST/ACS_WFC.F475W": (4747.0, 1420.0, 0.42),
    "HST/ACS_WFC.F606W": (5922.0, 2325.0, 0.46),
    "HST/ACS_WFC.F775W": (7693.0, 1511.0, 0.42),
    "HST/ACS_WFC.F814W": (8045.0, 1826.0, 0.44),
    "HST/ACS_WFC.F850LP": (9033.0, 1250.0, 0.36),
    # --- HST/WFC3_IR -----------------------------------------------------
    "HST/WFC3_IR.F105W": (10552.0, 2650.0, 0.50),
    "HST/WFC3_IR.F110W": (11534.0, 4430.0, 0.54),
    "HST/WFC3_IR.F125W": (12486.0, 2845.0, 0.54),
    "HST/WFC3_IR.F140W": (13923.0, 3840.0, 0.54),
    "HST/WFC3_IR.F160W": (15369.0, 2683.0, 0.52),
    # --- JWST/NIRCam (all wide + medium bands) ---------------------------
    "JWST/NIRCam.F070W": (0.704 * _UM, 0.128 * _UM, 0.30),
    "JWST/NIRCam.F090W": (0.901 * _UM, 0.194 * _UM, 0.36),
    "JWST/NIRCam.F115W": (1.154 * _UM, 0.225 * _UM, 0.40),
    "JWST/NIRCam.F140M": (1.404 * _UM, 0.142 * _UM, 0.44),
    "JWST/NIRCam.F150W": (1.501 * _UM, 0.318 * _UM, 0.46),
    "JWST/NIRCam.F162M": (1.626 * _UM, 0.168 * _UM, 0.48),
    "JWST/NIRCam.F182M": (1.845 * _UM, 0.238 * _UM, 0.50),
    "JWST/NIRCam.F200W": (1.990 * _UM, 0.461 * _UM, 0.52),
    "JWST/NIRCam.F210M": (2.093 * _UM, 0.205 * _UM, 0.52),
    "JWST/NIRCam.F250M": (2.503 * _UM, 0.181 * _UM, 0.40),
    "JWST/NIRCam.F277W": (2.786 * _UM, 0.672 * _UM, 0.44),
    "JWST/NIRCam.F300M": (2.996 * _UM, 0.318 * _UM, 0.46),
    "JWST/NIRCam.F335M": (3.365 * _UM, 0.347 * _UM, 0.50),
    "JWST/NIRCam.F356W": (3.563 * _UM, 0.787 * _UM, 0.52),
    "JWST/NIRCam.F360M": (3.621 * _UM, 0.372 * _UM, 0.52),
    "JWST/NIRCam.F410M": (4.092 * _UM, 0.436 * _UM, 0.52),
    "JWST/NIRCam.F430M": (4.280 * _UM, 0.228 * _UM, 0.52),
    "JWST/NIRCam.F444W": (4.421 * _UM, 1.024 * _UM, 0.54),
    "JWST/NIRCam.F460M": (4.624 * _UM, 0.228 * _UM, 0.50),
    "JWST/NIRCam.F480M": (4.834 * _UM, 0.303 * _UM, 0.48),
    # --- JWST/MIRI -------------------------------------------------------
    "JWST/MIRI.F560W": (5.635 * _UM, 1.2 * _UM, 0.28),
    "JWST/MIRI.F770W": (7.639 * _UM, 2.2 * _UM, 0.32),
    "JWST/MIRI.F1000W": (9.953 * _UM, 2.0 * _UM, 0.34),
    "JWST/MIRI.F1130W": (11.309 * _UM, 0.7 * _UM, 0.32),
    "JWST/MIRI.F1280W": (12.810 * _UM, 2.4 * _UM, 0.34),
    "JWST/MIRI.F1500W": (15.064 * _UM, 3.0 * _UM, 0.34),
    "JWST/MIRI.F1800W": (17.984 * _UM, 3.0 * _UM, 0.32),
    "JWST/MIRI.F2100W": (20.795 * _UM, 5.0 * _UM, 0.28),
    "JWST/MIRI.F2550W": (25.365 * _UM, 4.0 * _UM, 0.22),
    # --- Spitzer/IRAC ----------------------------------------------------
    "Spitzer/IRAC.I1": (3.551 * _UM, 0.75 * _UM, 0.46),
    "Spitzer/IRAC.I2": (4.496 * _UM, 1.01 * _UM, 0.48),
    "Spitzer/IRAC.I3": (5.724 * _UM, 1.42 * _UM, 0.42),
    "Spitzer/IRAC.I4": (7.884 * _UM, 2.93 * _UM, 0.42),
}

# The 63-filter GENERAL_SURVEY configuration of the reference paper
# (reference final_library_generation.py:39-103, order preserved).
PAPER_SURVEY_63 = [
    "Paranal/VISTA.Z", "Paranal/VISTA.Y", "Paranal/VISTA.J",
    "Paranal/VISTA.H", "Paranal/VISTA.Ks",
    "Subaru/HSC.g", "Subaru/HSC.r", "Subaru/HSC.i", "Subaru/HSC.z",
    "Subaru/HSC.Y",
    "CFHT/MegaCam.u", "CFHT/MegaCam.g", "CFHT/MegaCam.r", "CFHT/MegaCam.i",
    "CFHT/MegaCam.z",
    "Euclid/VIS.vis", "Euclid/NISP.Y", "Euclid/NISP.J", "Euclid/NISP.H",
    "HST/ACS_WFC.F435W", "HST/ACS_WFC.F475W", "HST/ACS_WFC.F606W",
    "JWST/NIRCam.F070W",
    "HST/ACS_WFC.F775W", "HST/ACS_WFC.F814W", "HST/ACS_WFC.F850LP",
    "JWST/NIRCam.F090W",
    "HST/WFC3_IR.F105W", "HST/WFC3_IR.F110W",
    "JWST/NIRCam.F115W",
    "HST/WFC3_IR.F125W",
    "JWST/NIRCam.F140M",
    "HST/WFC3_IR.F140W",
    "JWST/NIRCam.F150W",
    "HST/WFC3_IR.F160W",
    "JWST/NIRCam.F162M", "JWST/NIRCam.F182M", "JWST/NIRCam.F200W",
    "JWST/NIRCam.F210M", "JWST/NIRCam.F250M", "JWST/NIRCam.F277W",
    "JWST/NIRCam.F300M", "JWST/NIRCam.F335M", "JWST/NIRCam.F356W",
    "JWST/NIRCam.F360M", "JWST/NIRCam.F410M", "JWST/NIRCam.F430M",
    "JWST/NIRCam.F444W", "JWST/NIRCam.F460M", "JWST/NIRCam.F480M",
    "JWST/MIRI.F560W", "JWST/MIRI.F770W", "JWST/MIRI.F1000W",
    "JWST/MIRI.F1130W", "JWST/MIRI.F1280W", "JWST/MIRI.F1500W",
    "JWST/MIRI.F1800W", "JWST/MIRI.F2100W", "JWST/MIRI.F2550W",
    "Spitzer/IRAC.I1", "Spitzer/IRAC.I2", "Spitzer/IRAC.I3",
    "Spitzer/IRAC.I4",
]

# All 20 NIRCam wide+medium bands (reference grab_filters second list)
NIRCAM_20 = [c for c in PAPER_SURVEY_63 if c.startswith("JWST/NIRCam.")]


def realistic_filter(code: str, n_samples: int = 257) -> Filter:
    """Synthesize a measured-morphology transmission curve for `code`.

    Flat-top × two sigmoid edges (edge width 4% of the bandwidth, typical
    of interference filters) × a small in-band ripple (3% amplitude,
    deterministic per-filter phase) — the features that distinguish real
    curves from top-hats: soft edges leak flux across band boundaries,
    ripple perturbs the effective wavelength, peak throughput < 1.
    """
    if code not in BAND_PARAMS:
        raise KeyError(
            f"unknown filter {code!r}; known: {len(BAND_PARAMS)} codes "
            "(see instruments.BAND_PARAMS)")
    center, width, peak = BAND_PARAMS[code]
    lo, hi = center - width / 2.0, center + width / 2.0
    edge = 0.04 * width
    lam = np.linspace(lo - 6.0 * edge, hi + 6.0 * edge, n_samples)

    def sig(x):
        return 1.0 / (1.0 + np.exp(-np.clip(x, -60, 60)))

    top = sig((lam - lo) / edge) * sig((hi - lam) / edge)
    # deterministic per-filter ripple phase/frequency from the code hash
    h = int(hashlib.sha1(code.encode()).hexdigest()[:8], 16)
    phase = 2.0 * np.pi * (h % 997) / 997.0
    n_ripples = 3 + (h // 997) % 4
    ripple = 1.0 + 0.03 * np.sin(
        2.0 * np.pi * n_ripples * (lam - lo) / width + phase)
    trans = np.maximum(peak * top * ripple, 0.0)
    # zero the tails exactly so support bounds are well-defined
    trans[lam < lo - 5.0 * edge] = 0.0
    trans[lam > hi + 5.0 * edge] = 0.0
    return Filter(code=code, lam=lam, transmission=trans)


def load_instrument_filters(codes=None, n_samples: int = 257) -> FilterSet:
    """FilterSet of realistic curves; default = the 63-filter paper survey."""
    codes = list(codes) if codes is not None else list(PAPER_SURVEY_63)
    return FilterSet([realistic_filter(c, n_samples) for c in codes])


# ---------------------------------------------------------------------------
# measured-curve loaders
# ---------------------------------------------------------------------------

_LAM_NAMES = ("lam", "lams", "lambda", "wavelength", "wavelengths",
              "Wavelengths", "new_lam")
_TRANS_NAMES = ("t", "transmission", "trans", "T", "throughput")


def load_filters_svo_ascii(paths, codes=None) -> FilterSet:
    """Measured SVO ascii transmission files -> FilterSet.

    Each file holds two whitespace-separated columns (wavelength [Å],
    transmission) with `#` comments. `paths` is a directory (its `*.dat`,
    `*.txt` and `*.ascii` files), a glob pattern or a list of files. A
    filter's code is the file stem with its first underscore made "/"
    (`JWST_NIRCam.F200W.dat` -> `JWST/NIRCam.F200W`) unless `codes` gives
    them."""
    import glob
    import os

    if isinstance(paths, (str, os.PathLike)):
        p = str(paths)
        if os.path.isdir(p):
            files = sorted(f for ext in ("*.dat", "*.txt", "*.ascii")
                           for f in glob.glob(os.path.join(p, ext)))
        else:
            files = sorted(glob.glob(p)) or [p]
    else:
        files = [str(f) for f in paths]
    if not files:
        raise FileNotFoundError(f"no SVO ascii files found at {paths!r}")
    if codes is not None and len(codes) != len(files):
        raise ValueError("codes must match the number of files")
    filters = []
    for i, path in enumerate(files):
        data = np.loadtxt(path, comments="#", ndmin=2)
        if data.shape[1] < 2:
            raise ValueError(f"{path}: need (wavelength, transmission) "
                             "columns")
        order = np.argsort(data[:, 0])
        if codes is not None:
            code = str(codes[i])
        else:
            stem = os.path.splitext(os.path.basename(path))[0]
            code = stem.replace("_", "/", 1)
        filters.append(Filter(code=code, lam=data[order, 0],
                              transmission=np.maximum(data[order, 1], 0.0)))
    return FilterSet(filters)


def load_filters_hdf5(path, codes=None) -> FilterSet:
    """A filter-collection HDF5 file -> FilterSet. Layouts, in order of
    preference:

    1. `FilterSet.to_hdf5`'s (root attribute `filter_codes` and
       `filter_{i}` groups);
    2. one group per filter holding a transmission dataset (t,
       transmission, trans, T or throughput) and its own or a shared root
       wavelength dataset (lam, lams, lambda, wavelength(s), Wavelengths or
       new_lam); the code is the group's `filter_code`/`code` attribute or
       its path;
    3. a shared root wavelength dataset and one dataset per filter named by
       its code.

    `codes` selects a subset in that order (a missing code raises)."""
    import h5py

    with h5py.File(path, "r") as f:
        if "filter_codes" in f.attrs and "filter_0" in f:
            fs = FilterSet.from_hdf5(f)
            return fs.subset(list(codes)) if codes is not None else fs

        def find_lam(node):
            for n in _LAM_NAMES:
                if n in node and isinstance(node[n], h5py.Dataset):
                    return np.asarray(node[n][:], np.float64)
            return None

        shared_lam = find_lam(f)
        filters = []

        def walk(node, prefix=""):
            for name, item in node.items():
                if isinstance(item, h5py.Group):
                    tds = next((item[t] for t in _TRANS_NAMES
                                if t in item
                                and isinstance(item[t], h5py.Dataset)), None)
                    if tds is None:
                        walk(item, prefix + name + "/")
                        continue
                    lam = find_lam(item)
                    lam = shared_lam if lam is None else lam
                    if lam is None:
                        raise ValueError(
                            f"{path}:{name}: no wavelength dataset")
                    # "/" in a code nests groups: the full path is the code
                    code = str(item.attrs.get(
                        "filter_code", item.attrs.get("code", prefix + name)))
                    filters.append(Filter(
                        code=code, lam=np.asarray(lam),
                        transmission=np.maximum(
                            np.asarray(tds[:], np.float64), 0.0)))
                elif (isinstance(item, h5py.Dataset)
                      and name not in _LAM_NAMES and shared_lam is not None
                      and item.shape == shared_lam.shape):
                    filters.append(Filter(
                        code=prefix + name, lam=shared_lam,
                        transmission=np.maximum(
                            np.asarray(item[:], np.float64), 0.0)))

        walk(f)
    if not filters:
        raise ValueError(f"{path}: no filter curves found (see "
                         "load_filters_hdf5 for the accepted layouts)")
    fs = FilterSet(filters)
    return fs.subset(list(codes)) if codes is not None else fs
