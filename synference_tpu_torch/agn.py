"""AGN forward models: an analytic disk + torus, and a Cloudy-style grid.

Counterpart of `synference_tpu/agn.py`. Both simulators subclass
`BatchSEDSimulator` and inherit its observe, IGM and photometry machinery
over (B, ·) batches:

- `AGNSimulator` replaces the stellar SFZH ⊗ grid contraction (`_core`)
  with an analytic L_ν: a ν^α disk between a Lyman-limit cutoff and an IR
  rolloff plus a torus greybody that re-emits `torus_fraction` of the
  bolometric output, normalised to 10**log10_l_agn erg/s. θ names:
  log10_l_agn, redshift, agn_slope (α_ν, default −0.5), tau_v, and
  optionally torus_fraction (0.4) and torus_temperature (300 K).
- `AGNGridSimulator` reads an AGN grid (`grids.make_synthetic_agn_grid`
  or a Cloudy grid in its layout): the physics axes ride the base class's
  extra-axis lerp weights (`_sfzh`), and the channel mix takes per-region
  covering fractions, L_ν = (1 − Σ c_r)·incident + Σ c_r·region_r, behind
  one foreground screen (`_apply_emission`); line quantities scale by their
  emitting region's covering fraction (`_line_mixing`).

Both override the forward model, so the base class's gate keeps them off
K1, K2 and the window bodies (`BatchSEDSimulator._overrides_forward_model`):
their photometry takes the plain `_photometry_fused` route on the interp
and conv variants and `_photometry_batch` otherwise. `agn_fraction` is the
AGN share of a rest-frame band.
"""

from __future__ import annotations

import numpy as np
import torch

from .dust import greybody_emission
from .sed import BatchSEDSimulator, EmissionConfig, register_simulator
from .units import C_AA_S

__all__ = ["AGNSimulator", "AGNGridSimulator", "agn_fraction"]


@register_simulator
class AGNSimulator(BatchSEDSimulator):
    """Analytic AGN SED through the standard observe/photometry pipeline."""

    def __init__(self, grid, filters, param_names=(
            "log10_l_agn", "redshift", "agn_slope", "tau_v"), *, device,
            **kwargs):
        kwargs.setdefault("sfh", "constant")  # unused; the base needs one
        kwargs.setdefault("zdist", "delta")
        super().__init__(grid, filters, param_names, device=device, **kwargs)
        lam = np.asarray(self.grid.lam)
        nu_phz = C_AA_S / lam * 1.0e-15
        dev = self.device
        self._nu_phz = torch.as_tensor(nu_phz.astype(np.float32), device=dev)
        self._dnu_phz_agn = torch.as_tensor(
            (-np.gradient(nu_phz)).astype(np.float32), device=dev)
        # disk band: Lyman limit to 1 µm, smooth rolloffs
        self._disk_window = torch.as_tensor(
            (1.0 / (1.0 + np.exp(np.clip(-(lam - 700.0) / 60.0, -60, 60)))
             * 1.0 / (1.0 + np.exp(np.clip((lam - 12000.0) / 1200.0,
                                           -60, 60)))).astype(np.float32),
            device=dev)
        # the torus at its default temperature, once
        self._torus_300 = greybody_emission(self._lam, 300.0, 1.6)

    def _agn_lnu(self, params):
        """(B, L) rest-frame L_ν [erg/s/Hz], bolometric-normalised."""
        l_bol30 = 10.0 ** (params["log10_l_agn"] - 30.0)  # in 1e30 erg/s
        slope = self._param(params, "agn_slope", -0.5)
        torus_frac = torch.clamp(self._param(params, "torus_fraction", 0.4),
                                 0.0, 0.95)[:, None]
        # disk shape, unit bolometric in PHz units
        shape = self._nu_phz ** slope[:, None] * self._disk_window
        norm = torch.sum(shape * self._dnu_phz_agn, dim=1, keepdim=True)
        disk = shape / torch.clamp(norm, min=1.0e-30) * 1.0e-15  # ∫dν = 1
        if "torus_temperature" in params:  # a greybody per row
            torus = greybody_emission(self._lam,
                                      params["torus_temperature"][:, None])
        else:
            torus = self._torus_300
        lnu_unit = (1.0 - torus_frac) * disk + torus_frac * torus
        # the 1e30 bolometric scale as two factors: folded into one
        # constant it leaves float32's range
        return (l_bol30 * 1.0e15)[:, None] * (lnu_unit * 1.0e15)

    def _core(self, theta, want_spectra: bool, fused: bool = False,
              row_offset: int = 0):
        params = self.theta_dict(theta, row_offset)
        lnu = self._agn_lnu(params)
        tau_v = self._param(params, "tau_v", 0.0)
        lnu = lnu * torch.exp(-tau_v[:, None] * self._dust_curve)
        z = self._param(params, "redshift", 0.0)
        if fused:
            # `_photometry_fused` takes the λ support only, as the base
            # class's `_core` returns it
            l0, l1 = self._sup
            return {"_lnu": lnu[:, l0:l1], "_z": z}
        out = {"fnu_njy": self._observe(params, lnu), "_z": z}
        if want_spectra:
            b = theta.shape[0]
            zeros = lnu.new_zeros
            # no stellar populations: zero SFH and SFZH placeholders
            out.update(lnu=lnu, lnu_intrinsic=lnu,
                       sfh_mass=zeros(b, self.grid.n_ages),
                       sfzh=zeros(b, self.grid.n_ages
                                  * self.grid.cells_per_age))
        return out


def agn_fraction(stellar_lnu, agn_lnu, lam, band=(4000.0, 6000.0)):
    """(…,) AGN share of the summed L_ν over the rest-frame `band` [Å]
    (plain sums over the band's columns)."""
    lam = torch.as_tensor(lam, device=agn_lnu.device)
    m = ((lam >= band[0]) & (lam <= band[1])).to(agn_lnu.dtype)
    a = (agn_lnu * m).sum(-1)
    s = (stellar_lnu * m).sum(-1)
    return a / torch.clamp(a + s, min=1.0e-30)


@register_simulator
class AGNGridSimulator(BatchSEDSimulator):
    """AGN forward model from an AGN grid: disk incident + NLR/BLR tables.

    The grid's stellar (age, Z) axes are 1 × 1; its physics axes
    (ionisation parameter, hydrogen density, ...) are θ columns lerped by
    the base class's extra-axis weights. The per-region covering fractions
    c_r are θ columns ``covering_fraction_<region>`` (default 0.1):

        L_ν = (1 − Σ_r c_r) · incident + Σ_r c_r · region_r

    behind one foreground screen. `emission.dust_emission` re-emits the
    absorbed energy as a greybody. The grid's tables are per 10**l_norm
    erg/s of bolometric disk luminosity and scale by
    10**(log10_l_agn − l_norm); each line scales by its emitting region's
    covering fraction (`grid.lines["region"]`), 0 for a region the
    emission config does not model.

    θ names (default): log10_l_agn, redshift, the grid's extra axes,
    covering_fraction_<region> per reprocessed type, tau_v. The JAX
    package sets `_mega_off` here; the forward-model gate keeps K1, K2 and
    the window bodies away without it.
    """

    def __init__(self, grid, filters, param_names=None, l_norm: float = 45.0,
                 emission=None, *, device, **kwargs):
        if emission is None:
            regions = tuple(sorted(t for t in grid.spectra
                                   if t != "incident"))
            emission = EmissionConfig(
                incident_type="incident", reprocessed_types=regions,
                fesc=0.0)
        if param_names is None:
            param_names = (
                "log10_l_agn", "redshift", *grid.extra_axis_names,
                *(f"covering_fraction_{t}"
                  for t in emission.reprocessed_types),
                "tau_v",
            )
        kwargs.setdefault("sfh", "constant")  # unused; _sfzh is overridden
        kwargs.setdefault("zdist", "delta")
        super().__init__(grid, filters, param_names, emission=emission,
                         device=device, **kwargs)
        self._log10_l_norm = float(l_norm)
        regs = (grid.lines or {}).get("region") if grid.lines else None
        self._line_regions = tuple(regs) if regs is not None else None

    def model_extra(self) -> dict:
        """Extra constructor arguments stored in a library's Model group."""
        return {"l_norm": self._log10_l_norm}

    def _sfzh(self, params):
        """(B, cells) axis-lerp weights × the bolometric scale, and the
        (B, 1) age marginal."""
        w = None
        for ax_name, ax_vals in self._extra_axes:
            wa = self._axis_delta_weights(ax_vals, params[ax_name])
            w = wa if w is None else (w[:, :, None] * wa[:, None, :]).reshape(
                wa.shape[0], -1)
        scale = 10.0 ** (params["log10_l_agn"] - self._log10_l_norm)
        if w is None:
            w = torch.ones_like(scale)[:, None]
        flat = w * scale[:, None]
        return flat, flat.sum(dim=1, keepdim=True)

    def _covering_fractions(self, params):
        return [torch.clamp(self._param(params, f"covering_fraction_{t}",
                                        0.1), 0.0, 1.0)
                for t in self.emission.reprocessed_types]

    def _apply_emission(self, params, sfzh, trimmed: bool = False):
        """Covering fractions in place of fesc -> (lnu, intrinsic)."""
        em = self.emission
        curve = self._dust_curve_sup if trimmed else self._dust_curve
        l0, l1 = self._sup if trimmed else (0, self.grid.n_wav)

        def contract(stype):
            return sfzh @ self._components[stype][:, l0:l1]

        covs = self._covering_fractions(params)
        cov_tot = torch.clamp(sum(covs), 0.0, 1.0)[:, None]
        intrinsic = (1.0 - cov_tot) * contract(em.incident_type)
        for c, t in zip(covs, em.reprocessed_types):
            intrinsic = intrinsic + c[:, None] * contract(t)
        tau_v = (params[em.tau_v_param] if em.tau_v_param is not None
                 else torch.zeros_like(sfzh[:, 0]))
        lnu = intrinsic * torch.exp(-tau_v[:, None] * curve)
        if em.dust_emission:
            if trimmed:
                raise ValueError("dust_emission needs the full λ grid")
            lnu = self._add_dust_emission(lnu, intrinsic)
        return lnu, intrinsic

    def _line_mixing(self, params, lum, cont, inc_cont, sel, sfzh=None,
                     att=None):
        """Line quantities under the covering-fraction mix: every channel
        sits behind the one screen, so the realised continuum is
        att·((1 − c)·inc + c·cont) with c = Σ c_r. The grid's line table
        carries only the emitting region's transmitted continuum, which
        stands in for every region's (as in the JAX package). Each line is
        scaled by its region's covering fraction, gathered through a zero
        column for regions the config does not model."""
        covs = self._covering_fractions(params)
        cov_tot = torch.clamp(sum(covs), 0.0, 1.0)[:, None]
        att_l = att if att is not None else 1.0
        cont_real = (1.0 - cov_tot) * inc_cont * att_l + cov_tot * cont
        if self._line_regions is None:
            return cov_tot * lum, cont_real
        types = list(self.emission.reprocessed_types)
        idx = [types.index(r) if r in types else len(types)
               for r in (self._line_regions[int(i)] for i in np.asarray(sel))]
        cov_mat = torch.cat([torch.stack(covs, dim=1),
                             lum.new_zeros(lum.shape[0], 1)], dim=1)
        cov_vec = cov_mat[:, torch.as_tensor(idx, device=lum.device)]
        return cov_vec * lum, cont_real
