"""Dust attenuation laws on torch tensors.

Counterpart of `synference_tpu/dust.py` for the attenuation curves: each law
is a function λ → τ(λ)/τ_V, evaluated once per wavelength grid, so the
screen is an elementwise `exp(-tau_v * k)`; `greybody_emission` is the
energy-balance re-emission. Wavelengths in Angstrom (rest frame).
"""

from __future__ import annotations

import torch

__all__ = ["ATTENUATION_LAWS", "attenuation_curve", "greybody_emission"]


def _power_law(lam, params):
    """τ(λ)/τ_V = (λ/5500Å)^slope."""
    return torch.pow(lam / 5500.0, params.get("slope", -1.0))


def _calzetti2000(lam, params):
    """Calzetti et al. (2000) starburst curve normalized to A_V: k(λ)/R_V with
    R_V = 4.05, the polynomials extrapolated outside 0.12–2.2 µm and clamped
    at 0. Optional 2175 Å Drude bump (`bump`) and power-law tilt (`delta`)."""
    rv = 4.05
    mu = lam * 1.0e-4  # microns
    inv = 1.0 / torch.clamp(mu, min=1.0e-4)
    k_short = 2.659 * (-2.156 + 1.509 * inv - 0.198 * inv**2 + 0.011 * inv**3) + rv
    k_long = 2.659 * (-1.857 + 1.040 * inv) + rv
    k = torch.clamp(torch.where(mu < 0.63, k_short, k_long), min=0.0)
    delta = params.get("delta", 0.0)
    bump = params.get("bump", 0.0)
    if bump:
        lam0, fwhm = 2175.0, 350.0
        drude = (lam * fwhm) ** 2 / ((lam**2 - lam0**2) ** 2 + (lam * fwhm) ** 2)
        k = k + bump * drude
    curve = k / rv
    if delta:
        curve = curve * torch.pow(lam / 5500.0, delta)
    return curve


def _smc_like(lam, params):
    """Steep SMC-bar-like curve approximated as a λ^-1.24 power law."""
    return torch.pow(lam / 5500.0, -1.24)


ATTENUATION_LAWS = {
    "power_law": _power_law,
    "calzetti2000": _calzetti2000,
    "smc": _smc_like,
}


def attenuation_curve(law: str, lam: torch.Tensor, params: dict | None = None):
    """τ(λ)/τ_V for the named law at rest wavelengths `lam` [Å]."""
    return ATTENUATION_LAWS[law](lam, params or {})


_H_ERG_S = 6.62607015e-27  # Planck [erg s]
_K_ERG_K = 1.380649e-16  # Boltzmann [erg/K]
_C_AA_S = 2.99792458e18  # c [Å/s]


def greybody_emission(lam, temperature, emissivity: float = 1.6):
    """Unit-energy greybody SED B_ν(T) ν^β on wavelengths `lam` [Å]: L_ν
    [1/Hz], normalized so ∫ L_ν dν = 1 on this grid; shape (len(lam),) for
    a number `temperature`, (B, len(lam)) for a (B, 1) tensor of them.

    Frequencies are in PHz (ν³⁺ᵝ in Hz overflows fp32; the scale cancels in
    the normalization), and the Planck factor is evaluated in log space (the
    Wien tail e^-x underflows fp32 for x ≳ 90)."""
    nu_phz = _C_AA_S / lam * 1.0e-15
    x = _H_ERG_S * 1.0e15 * nu_phz / (_K_ERG_K * temperature)
    log_g = (3.0 + emissivity) * torch.log(nu_phz) - torch.where(
        x > 30.0, x, torch.log(torch.expm1(torch.clamp(x, 1.0e-6, 30.0))))
    g = torch.exp(log_g - torch.amax(log_g, dim=-1, keepdim=True))
    dnu_phz = -torch.gradient(nu_phz)[0]
    norm = torch.sum(g * dnu_phz, dim=-1, keepdim=True)
    return g / torch.clamp(norm, min=1.0e-30) * 1.0e-15
