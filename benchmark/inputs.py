"""The inputs every cell hands to the program and to the reference.

Made here, from the run's seed, by code that belongs to the benchmark:

- `make_grid`: a stellar-population grid at the shape a configuration
  states (ages × metallicities × wavelengths, the ionisation axis fixed),
  computed in float64 on the device and kept as float32. The spectra are
  physically shaped stand-ins (a cooling blackbody with a Lyman and a
  Balmer break, a metallicity tilt, a nebular channel for young ages); the
  seed sets the phase and frequency of the small absorption-like wiggles,
  so every seed gives other spectra at the same shape.
- `make_filters`: analytic transmission curves (flat top, sigmoid edges 4%
  of the width, a 3% ripple whose phase comes from the code's hash) from
  published pivot wavelengths, widths and peak throughputs.

Both return plain arrays: the reference reads them, and the traffic
drivers wrap the same arrays in the program's constructors.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_UM = 1.0e4  # micron -> Angstrom

# {code: (pivot [A], width [A], peak throughput)} of the bands the
# configurations name (public filter parameters, rounded)
BAND_PARAMS = {
    "Paranal/VISTA.Z": (8800.0, 970.0, 0.84),
    "Paranal/VISTA.Y": (10210.0, 930.0, 0.86),
    "Paranal/VISTA.J": (12540.0, 1720.0, 0.88),
    "Paranal/VISTA.H": (16460.0, 2910.0, 0.89),
    "Paranal/VISTA.Ks": (21490.0, 3090.0, 0.87),
    "Subaru/HSC.g": (4754.0, 1395.0, 0.80),
    "Subaru/HSC.r": (6175.0, 1494.0, 0.84),
    "Subaru/HSC.i": (7711.0, 1471.0, 0.86),
    "Subaru/HSC.z": (8898.0, 766.0, 0.82),
    "Subaru/HSC.Y": (9762.0, 786.0, 0.75),
    "CFHT/MegaCam.u": (3754.0, 650.0, 0.68),
    "CFHT/MegaCam.g": (4750.0, 1540.0, 0.82),
    "CFHT/MegaCam.r": (6400.0, 1480.0, 0.84),
    "CFHT/MegaCam.i": (7760.0, 1550.0, 0.86),
    "CFHT/MegaCam.z": (9250.0, 1500.0, 0.78),
    "Euclid/VIS.vis": (7100.0, 3550.0, 0.78),
    "Euclid/NISP.Y": (10850.0, 2660.0, 0.80),
    "Euclid/NISP.J": (13750.0, 4040.0, 0.82),
    "Euclid/NISP.H": (17725.0, 4990.0, 0.82),
    "HST/ACS_WFC.F435W": (4329.0, 1038.0, 0.38),
    "HST/ACS_WFC.F475W": (4747.0, 1420.0, 0.42),
    "HST/ACS_WFC.F606W": (5922.0, 2325.0, 0.46),
    "HST/ACS_WFC.F775W": (7693.0, 1511.0, 0.42),
    "HST/ACS_WFC.F814W": (8045.0, 1826.0, 0.44),
    "HST/ACS_WFC.F850LP": (9033.0, 1250.0, 0.36),
    "HST/WFC3_IR.F105W": (10552.0, 2650.0, 0.50),
    "HST/WFC3_IR.F110W": (11534.0, 4430.0, 0.54),
    "HST/WFC3_IR.F125W": (12486.0, 2845.0, 0.54),
    "HST/WFC3_IR.F140W": (13923.0, 3840.0, 0.54),
    "HST/WFC3_IR.F160W": (15369.0, 2683.0, 0.52),
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
    "JWST/MIRI.F560W": (5.635 * _UM, 1.2 * _UM, 0.28),
    "JWST/MIRI.F770W": (7.639 * _UM, 2.2 * _UM, 0.32),
    "JWST/MIRI.F1000W": (9.953 * _UM, 2.0 * _UM, 0.34),
    "JWST/MIRI.F1130W": (11.309 * _UM, 0.7 * _UM, 0.32),
    "JWST/MIRI.F1280W": (12.810 * _UM, 2.4 * _UM, 0.34),
    "JWST/MIRI.F1500W": (15.064 * _UM, 3.0 * _UM, 0.34),
    "JWST/MIRI.F1800W": (17.984 * _UM, 3.0 * _UM, 0.32),
    "JWST/MIRI.F2100W": (20.795 * _UM, 5.0 * _UM, 0.28),
    "JWST/MIRI.F2550W": (25.365 * _UM, 4.0 * _UM, 0.22),
    "Spitzer/IRAC.I1": (3.551 * _UM, 0.75 * _UM, 0.46),
    "Spitzer/IRAC.I2": (4.496 * _UM, 1.01 * _UM, 0.48),
    "Spitzer/IRAC.I3": (5.724 * _UM, 1.42 * _UM, 0.42),
    "Spitzer/IRAC.I4": (7.884 * _UM, 2.93 * _UM, 0.42),
}


def filter_curve(code: str, n_samples: int = 257):
    """(λ [Å], transmission) of one analytic band, float64."""
    center, width, peak = BAND_PARAMS[code]
    lo, hi = center - width / 2.0, center + width / 2.0
    edge = 0.04 * width
    lam = np.linspace(lo - 6.0 * edge, hi + 6.0 * edge, n_samples)
    top = (1.0 / (1.0 + np.exp(-np.clip((lam - lo) / edge, -60, 60)))
           * 1.0 / (1.0 + np.exp(-np.clip((hi - lam) / edge, -60, 60))))
    h = int(hashlib.sha1(code.encode()).hexdigest()[:8], 16)
    phase = 2.0 * np.pi * (h % 997) / 997.0
    n_ripples = 3 + (h // 997) % 4
    ripple = 1.0 + 0.03 * np.sin(
        2.0 * np.pi * n_ripples * (lam - lo) / width + phase)
    trans = np.maximum(peak * top * ripple, 0.0)
    trans[lam < lo - 5.0 * edge] = 0.0
    trans[lam > hi + 5.0 * edge] = 0.0
    return lam, trans


def make_filters(codes) -> list:
    """[(code, λ, transmission)] for the configuration's bands, in order."""
    return [(c, *filter_curve(c)) for c in codes]


def make_grid(grid_cfg: dict, seed: int, device) -> dict:
    """The configuration's grid as float32 host arrays:
    {"log10_ages" (A,), "metallicities" (Z,), "lam" (L,), "incident"
    (A, Z, L), "total" (A, Z, L)}, the ionisation axis already fixed at
    `grid_cfg["log10_u"]`. Computed in float64 on `device`; the seed sets
    the wiggles' phase and frequency (a torch.Generator on the device)."""
    dev = torch.device(device)
    f64 = torch.float64
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(2, generator=gen, device=dev, dtype=f64)
    n_a, n_z, n_l = (int(grid_cfg[k]) for k in ("n_ages", "n_mets", "n_wav"))
    log10_ages = torch.linspace(5.0, 10.2, n_a, dtype=f64, device=dev)
    log10_z = torch.linspace(-4.0, -1.4, n_z, dtype=f64, device=dev)
    lam = torch.logspace(np.log10(grid_cfg["lam_min"]),
                         np.log10(grid_cfg["lam_max"]), n_l, dtype=f64,
                         device=dev)
    la = log10_ages[:, None, None]
    lb = lam[None, None, :]
    t_eff = 10.0 ** (4.6 - 0.25 * (la - 5.0))
    x = 1.43877688e8 / (lb * t_eff)
    planck = lb ** -3.0 / torch.expm1(torch.clamp(x, 1e-6, 60.0))
    lum = 10.0 ** (21.5 - 0.8 * (la - 5.0) / 5.2)
    met = (log10_z + 2.7)[None, :, None]
    spec = planck / planck.amax(dim=-1, keepdim=True) * lum * (
        lb / 5500.0) ** (0.08 * met)
    spec = spec * torch.where(lb < 912.0, 0.01, 1.0)
    spec = spec * (1.0 - 0.4 * ((la - 5.0) / 5.2) * (lb < 3646.0))
    freq = 150.0 + 100.0 * u[0]
    spec = spec * (1.0 + 0.05 * torch.sin(lb / freq + met * 3.0
                                          + 2.0 * np.pi * u[1]))
    ionizing = torch.where(lb < 912.0, spec, 0.0)
    transmitted = spec - ionizing
    lines = sum(torch.exp(-0.5 * ((lb - ll) / (ll * 0.002)) ** 2)
                for ll in (1216.0, 3727.0, 4861.0, 5007.0, 6563.0))
    young = (la < 7.0).to(f64)
    nebular = young * ionizing.sum(dim=-1, keepdim=True) * 1.0e-4 * (
        lines + 0.01)
    # the ionisation axis at log U = grid_cfg["log10_u"]: nebular emission
    # scales as 10^(0.35 (log U + 2.5)), boosted to the few-percent level
    g_u = 10.0 ** (0.35 * (float(grid_cfg["log10_u"]) + 2.5))
    total = transmitted + float(grid_cfg["nebular_boost"]) * g_u * nebular

    def host(t):
        return t.to(torch.float32).cpu().numpy()

    return {"log10_ages": log10_ages.cpu().numpy(),
            "metallicities": (10.0 ** log10_z).cpu().numpy(),
            "lam": lam.cpu().numpy(),
            "incident": host(spec), "total": host(total)}
