"""Supplementary derived quantities recorded alongside photometry.

Counterpart of `synference_tpu/supplementary.py`: the same 22 quantities
(`SUPP_FUNCTIONS`), each a batched function over the simulator's
intermediates from `simulate(θ, want_spectra=True)` (rest-frame L_ν with
and without dust, the SFH mass per age bin, the SFZH weights), as device
tensors. Each function takes a context dict (`supplementary_context`) and
returns (B,).

The rest-frame windows of the JAX package (UV at 1450-1550 Å, the 4000 Å
break, line and continuum windows, the ionising range) are masks over an
ascending λ grid, so here they are column slices: the functions read only
the columns a window covers instead of masking the whole (B, L) slab. The
per-cell bolometric luminosity and its cumulative integral are computed
once per simulator in float64 on the host, then cast to float32.

Names (as in the JAX package): m_uv, app_m_uv, sfr_10, sfr_100,
burstiness, mass_weighted_age, lum_weighted_age, flux_weighted_age,
beta_uv, d4000, t10, t50, t90, u_minus_v, v_minus_j, balmer_decrement,
ew_halpha, ew_hbeta, ew_oiii, n_ion, xi_ion, surviving_mass.
"""

from __future__ import annotations

import numpy as np
import torch

from .units import C_AA_S

_H_ERG_S = 6.62607015e-27

__all__ = ["SUPP_FUNCTIONS", "compute_supplementary",
           "supplementary_context"]


def _cols(ctx, keep: np.ndarray) -> slice:
    """The column slice where the float32 rest grid satisfies `keep` (a
    contiguous run on an ascending grid; empty when nothing does)."""
    idx = np.flatnonzero(keep)
    if idx.size == 0:
        return slice(0, 0)
    if idx[-1] - idx[0] + 1 != idx.size:
        raise ValueError("supplementary windows need an ascending λ grid")
    return slice(int(idx[0]), int(idx[-1]) + 1)


def _window(ctx, lo: float, hi: float) -> slice:
    lam = ctx["lam_host"]
    return _cols(ctx, (lam >= np.float32(lo)) & (lam <= np.float32(hi)))


def _window_mean(ctx, key: str, lo: float, hi: float):
    """Mean of ctx[key] (B, L) over the rest-frame tophat [lo, hi] Å."""
    cols = _window(ctx, lo, hi)
    n = max(cols.stop - cols.start, 1)
    return ctx[key][:, cols].sum(dim=-1) / float(n)


def _abs_mag_from_lnu(lnu_mean):
    """M_AB = -2.5 log10(L_ν [erg/s/Hz]) + 51.595 (flux at 10 pc)."""
    return -2.5 * torch.log10(torch.clamp(lnu_mean, min=1.0e-30)) + 51.595


def _m_uv(ctx):
    return _abs_mag_from_lnu(_window_mean(ctx, "lnu", 1450.0, 1550.0))


def _app_m_uv(ctx):
    return _m_uv(ctx) + ctx["distance_modulus"]


def _sfr_timescale(ctx, t_yr: float):
    ages = ctx["age_bin_edges"]  # (A+1,)
    frac_in = torch.clamp((t_yr - ages[:-1])
                          / torch.clamp(ages[1:] - ages[:-1], min=1.0),
                          0.0, 1.0)
    return (ctx["sfh_mass"] * frac_in).sum(dim=-1) / t_yr


def _sfr_10(ctx):
    return _sfr_timescale(ctx, 1.0e7)


def _sfr_100(ctx):
    return _sfr_timescale(ctx, 1.0e8)


def _burstiness(ctx):
    return _sfr_10(ctx) / torch.clamp(_sfr_100(ctx), min=1.0e-20)


def _mass_weighted_age(ctx):
    m = ctx["sfh_mass"]
    return ((m * ctx["ages_yr"]).sum(dim=-1)
            / torch.clamp(m.sum(dim=-1), min=1.0e-20))


def _cell_ages(ctx):
    return torch.repeat_interleave(ctx["ages_yr"], ctx["cells_per_age"])


def _lum_weighted_age(ctx):
    """Age weighted by each (age, Z) cell's bolometric grid luminosity."""
    w = ctx["sfzh"] * ctx["bol_lum_flat"]
    return ((w * _cell_ages(ctx)).sum(dim=-1)
            / torch.clamp(w.sum(dim=-1), min=1.0e-20))


def _beta_uv(ctx):
    """Least-squares slope of ln f_λ against ln λ over 1250-3000 Å:
    f_λ ∝ L_ν / λ², so β = dln(L_ν)/dln(λ) − 2. The logs are float32 as in
    the JAX package; the sums are float64 (n·Σxy − Σx·Σy cancels: in float32
    it loses ~1e-3 of β)."""
    cols = _window(ctx, 1250.0, 3000.0)
    x = torch.log(ctx["lam"][cols]).double()
    y = torch.log(torch.clamp(ctx["lnu"][:, cols], min=1.0e-30)).double()
    n = float(max(cols.stop - cols.start, 1))
    sx, sy = x.sum(), y.sum(dim=-1)
    sxx = (x * x).sum()
    sxy = (x * y).sum(dim=-1)
    slope = (n * sxy - sx * sy) / torch.clamp(n * sxx - sx * sx, min=1.0e-10)
    return (slope - 2.0).float()


def _d4000(ctx):
    red = _window_mean(ctx, "lnu", 4000.0, 4100.0)
    blue = _window_mean(ctx, "lnu", 3850.0, 3950.0)
    return red / torch.clamp(blue, min=1.0e-30)


def _sfh_quantile(ctx, q: float):
    """Lookback time by which fraction q of the mass had formed, counting
    from the oldest stars: `jnp.interp(q, cumulative mass, ages)` per row."""
    m = ctx["sfh_mass"]
    n_a = m.shape[1]
    total = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0e-20)
    # cumulative from the old end as a product with a 0/1 triangle (one
    # matmul instead of a scan over the age bins)
    tri = torch.ones(n_a, n_a, dtype=m.dtype, device=m.device).triu()
    cm = (m.flip(-1) @ tri) / total  # (B, A) old -> young
    fp = ctx["ages_yr"].flip(0)
    qv = torch.full((m.shape[0], 1), q, dtype=m.dtype, device=m.device)
    i = torch.clamp(torch.searchsorted(cm.contiguous(), qv, right=True),
                    1, n_a - 1)
    x0, x1 = cm.gather(1, i - 1)[:, 0], cm.gather(1, i)[:, 0]
    f0, f1 = fp[i - 1][:, 0], fp[i][:, 0]
    dx = x1 - x0
    tiny = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= tiny
    f = torch.where(dx0, f0, f0 + ((q - x0) / torch.where(dx0, 1.0, dx))
                    * (f1 - f0))
    f = torch.where(q < cm[:, 0], fp[0], f)
    return torch.where(q > cm[:, -1], fp[-1], f)


def _t10(ctx):
    return _sfh_quantile(ctx, 0.1)


def _t50(ctx):
    return _sfh_quantile(ctx, 0.5)


def _t90(ctx):
    return _sfh_quantile(ctx, 0.9)


def _color(ctx, band1, band2):
    m1 = _abs_mag_from_lnu(_window_mean(ctx, "lnu", *band1))
    m2 = _abs_mag_from_lnu(_window_mean(ctx, "lnu", *band2))
    return m1 - m2


def _u_minus_v(ctx):
    return _color(ctx, (3400.0, 3900.0), (5300.0, 5700.0))


def _v_minus_j(ctx):
    return _color(ctx, (5300.0, 5700.0), (11800.0, 12600.0))


def _line_flux(ctx, lam0: float, width: float = 30.0, cont_off: float = 80.0,
               cont_w: float = 50.0):
    """Continuum-subtracted line luminosity around lam0 and the continuum
    L_λ, both in 1e10-scaled units (only their ratios are used). The
    windows are float32 as in the JAX package; the arithmetic is float64
    (line minus continuum cancels: in float32 it loses ~1e-4 of an EW)."""
    lam_h = ctx["lam_host"]
    cols = _cols(ctx, np.abs(lam_h - np.float32(lam0))
                 < np.float32(cont_off + cont_w))
    lam = ctx["lam"][cols]
    llam = ctx["lnu"][:, cols].double() * ((C_AA_S * 1.0e-10)
                                           / lam.double()**2)
    line_m = (torch.abs(lam - lam0) < width).double()
    cont_m = ((torch.abs(lam - (lam0 - cont_off)) < cont_w)
              | (torch.abs(lam - (lam0 + cont_off)) < cont_w)).double()
    cont = (llam * cont_m).sum(dim=-1) / torch.clamp(cont_m.sum(), min=1.0)
    excess = ((llam - cont[:, None]) * line_m
              * ctx["dlam"][cols].double()).sum(dim=-1)
    return excess, cont


def _balmer_decrement(ctx):
    ha, _ = _line_flux(ctx, 6563.0)
    hb, _ = _line_flux(ctx, 4861.0)
    return (ha / torch.clamp(hb, min=1.0e-30)).float()


def _ew(ctx, lam0: float):
    fl, cont = _line_flux(ctx, lam0)
    return (fl / torch.clamp(cont, min=1.0e-30)).float()


def _ew_halpha(ctx):
    return _ew(ctx, 6563.0)


def _ew_hbeta(ctx):
    return _ew(ctx, 4861.0)


def _ew_oiii(ctx):
    return _ew(ctx, 5007.0)


def _n_ion(ctx):
    """Ionising photon rate of the intrinsic spectrum, Ṅ = ∫ L_ν/h dλ/λ
    below 912 Å, in 1e30-scaled arithmetic."""
    cols = _cols(ctx, ctx["lam_host"] < np.float32(912.0))
    integrand = ((ctx["lnu_intrinsic"][:, cols] * 1.0e-30)
                 * (ctx["dlam"][cols] / ctx["lam"][cols]))
    return integrand.sum(dim=-1) * (1.0e30 / _H_ERG_S)


def _xi_ion(ctx):
    luv = _window_mean(ctx, "lnu", 1450.0, 1550.0)
    return _n_ion(ctx) / torch.clamp(luv, min=1.0e-30)


def _flux_weighted_age(ctx):
    """Age weighted by each SFZH cell's flux in an observed F444W-like
    window (38900-49900 Å), from the cells' cumulative ∫ L_ν dν at the
    redshifted window edges."""
    lam = ctx["lam"]
    cum = ctx["cum_lum"]  # (C, L)
    zp1 = 1.0 + ctx["z"]
    n_l = lam.shape[0]

    def edge_idx(lam_rest):
        s = (torch.log(lam_rest) - torch.log(lam[0])) / (
            torch.log(lam[-1]) - torch.log(lam[0]))
        return torch.clamp((s * (n_l - 1)).to(torch.int32), 0,
                           n_l - 1).long()

    flux_cell = (cum[:, edge_idx(49900.0 / zp1)].T
                 - cum[:, edge_idx(38900.0 / zp1)].T)  # (B, C)
    w = ctx["sfzh"] * torch.clamp(flux_cell, min=0.0)
    return ((w * _cell_ages(ctx)).sum(dim=-1)
            / torch.clamp(w.sum(dim=-1), min=1.0e-30))


def _surviving_mass(ctx):
    """Mass surviving stellar mass loss, f_loss(t) = 0.05 ln(1 + t/1.4 Myr)
    (Behroozi+13)."""
    f_loss = 0.05 * torch.log1p(ctx["ages_yr"] / 1.4e6)
    return (ctx["sfh_mass"] * (1.0 - f_loss)).sum(dim=-1)


SUPP_FUNCTIONS = {
    "m_uv": _m_uv,
    "app_m_uv": _app_m_uv,
    "sfr_10": _sfr_10,
    "sfr_100": _sfr_100,
    "burstiness": _burstiness,
    "mass_weighted_age": _mass_weighted_age,
    "lum_weighted_age": _lum_weighted_age,
    "flux_weighted_age": _flux_weighted_age,
    "beta_uv": _beta_uv,
    "d4000": _d4000,
    "t10": _t10,
    "t50": _t50,
    "t90": _t90,
    "u_minus_v": _u_minus_v,
    "v_minus_j": _v_minus_j,
    "balmer_decrement": _balmer_decrement,
    "ew_halpha": _ew_halpha,
    "ew_hbeta": _ew_hbeta,
    "ew_oiii": _ew_oiii,
    "n_ion": _n_ion,
    "xi_ion": _xi_ion,
    "surviving_mass": _surviving_mass,
}


def _grid_tables(sim) -> dict:
    """The simulator's per-grid tables, made once and kept on it: λ and dλ
    in float32 (host and device), the ages, and the per-cell bolometric
    luminosity and cumulative ∫ L_ν dν (float64 on the host, scaled by
    1e-40, then float32 on the device)."""
    tables = getattr(sim, "_supp_tables", None)
    if tables is not None:
        return tables
    grid, dev = sim.grid, sim.device
    lam = np.asarray(grid.lam)
    dlam = np.gradient(lam)
    nu_w = (C_AA_S / lam**2) * dlam  # |dν| per column
    inc = grid.spectra[sim.emission.incident_type].reshape(-1, len(lam))
    per_col = inc.astype(np.float64) * nu_w

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    tables = {
        "lam_host": lam.astype(np.float32),
        "lam": f32(lam), "dlam": f32(dlam),
        "ages_yr": f32(grid.ages_yr),
        "age_bin_edges": f32(grid.age_bin_edges_yr),
        "cells_per_age": int(grid.cells_per_age),
        "bol_lum_flat": f32(per_col.sum(-1) / 1.0e40),
        "cum_lum": f32(np.cumsum(per_col, axis=-1) / 1.0e40),
    }
    sim._supp_tables = tables
    return tables


def supplementary_context(sim, theta, out) -> dict:
    """The context the functions read, for a batch θ (B, P) on the
    simulator's device and its `simulate(θ, want_spectra=True)` outputs."""
    theta = torch.atleast_2d(torch.as_tensor(theta, dtype=torch.float32,
                                             device=sim.device))
    if "redshift" in sim.param_names:
        z = theta[:, sim.param_names.index("redshift")]
    else:
        z = torch.zeros(theta.shape[0], dtype=torch.float32,
                        device=theta.device)
    ctx = dict(_grid_tables(sim))
    ctx.update(lnu=out["lnu"],
               lnu_intrinsic=out.get("lnu_intrinsic", out["lnu"]),
               sfh_mass=out["sfh_mass"], sfzh=out["sfzh"], z=z,
               distance_modulus=sim.cosmology.distance_modulus(
                   torch.clamp(z, min=1.0e-4)))
    return ctx


def compute_supplementary(names, sim, theta, out):
    """(B, len(names)) named quantities for a simulated batch: `theta`
    (B, P) and `out` = `sim.simulate(theta, want_spectra=True)`."""
    ctx = supplementary_context(sim, theta, out)
    return torch.stack([SUPP_FUNCTIONS[n](ctx) for n in names], dim=1)
