"""Composite forward models: several SED components per galaxy.

Counterpart of `synference_tpu/composite.py`. A `CompositeSEDSimulator`
sums its component simulators' photometry and spectra: each component
keeps its own θ block (names prefixed "component.param") and the `shared`
names (redshift by default) appear once and go to every component. Each
component takes its own route: a stellar `BatchSEDSimulator` reaches K2 on
the card through its own gate, AGN components take their plain routes.
`grid_combinations` is the Cartesian θ grid of a set of parameter values.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["CompositeSEDSimulator", "grid_combinations"]


class CompositeSEDSimulator:
    """Sum of component simulators with shared and per-component θ.

    Args:
        components: {name: simulator}, all on one device and one
            `FilterSet`; each keeps its own `param_names`, which appear in
            the composite θ as "name.param" except the `shared` ones.
            Spectra (`want_spectra`, `agn_fraction`) need one rest
            wavelength grid for all, and raise otherwise (the JAX package
            adds them column by column whatever their grids).
        shared: parameter names given once and broadcast to every
            component (default: ("redshift",)).
    """

    def __init__(self, components: dict, shared: tuple = ("redshift",)):
        if not components:
            raise ValueError("need at least one component")
        self.components = dict(components)
        self.shared = tuple(shared)
        first = next(iter(self.components.values()))
        self.filters = first.filters
        self.device = first.device
        for cname, sim in self.components.items():
            if list(sim.filters.codes) != list(self.filters.codes):
                raise ValueError("components must share a FilterSet")
            if sim.device != self.device:
                raise ValueError(
                    f"component {cname!r} is on {sim.device}, the first "
                    f"component on {self.device}: components must share a "
                    "device")
        lams = [np.asarray(s.grid.lam) for s in self.components.values()]
        # spectra add column by column: only on one rest wavelength grid
        self._lam_shared = all(lam.shape == lams[0].shape
                               and np.array_equal(lam, lams[0])
                               for lam in lams)
        names = list(self.shared)
        for cname, sim in self.components.items():
            names.extend(f"{cname}.{p}" for p in sim.param_names
                         if p not in self.shared)
        self.param_names = tuple(names)
        self._index = {n: i for i, n in enumerate(self.param_names)}
        self._columns = {
            cname: [self._index[p if p in self.shared else f"{cname}.{p}"]
                    for p in sim.param_names]
            for cname, sim in self.components.items()}

    def _component_theta(self, theta, cname):
        """(B, P_total) -> (B, P_c) in that component's order."""
        return theta[:, self._columns[cname]]

    def _theta(self, theta):
        return torch.atleast_2d(torch.as_tensor(
            theta, dtype=torch.float32, device=self.device))

    def simulate(self, theta, want_spectra: bool = False,
                 row_offset: int = 0):
        """θ (B, P_total) -> {"photometry_njy": (B, F)}, and with
        `want_spectra` the summed "fnu_njy" and "lnu" (B, L)."""
        if want_spectra:
            self._check_lam_shared()
        theta = self._theta(theta)
        outs = [sim.simulate(self._component_theta(theta, cname),
                             want_spectra=want_spectra, row_offset=row_offset)
                for cname, sim in self.components.items()]
        total = {"photometry_njy": sum(o["photometry_njy"] for o in outs)}
        if want_spectra:
            total["fnu_njy"] = sum(o["fnu_njy"] for o in outs)
            total["lnu"] = sum(o["lnu"] for o in outs)
        return total

    def _check_lam_shared(self):
        if not self._lam_shared:
            raise ValueError(
                "the components' rest wavelength grids differ, so their "
                "spectra do not add column by column (photometry does)")

    def photometry(self, theta, row_offset: int = 0):
        return self.simulate(theta, row_offset=row_offset)["photometry_njy"]

    def agn_fraction(self, theta, min_wav_rest: float = 1.0e4,
                     max_wav_rest: float = 3.0e5,
                     agn_components: tuple | None = None):
        """(B,) device tensor: the share of the rest-frame [min, max] Å
        luminosity ∫ L_ν dν that comes from AGN components (default: every
        component that is an `agn.AGNSimulator`), integrated on the device
        with dν ∝ dλ/λ² over the first component's rest grid."""
        from .agn import AGNSimulator

        if agn_components is None:
            agn_components = tuple(
                n for n, s in self.components.items()
                if isinstance(s, AGNSimulator))
        if not agn_components:
            raise ValueError("no AGN components in this composite")
        self._check_lam_shared()
        theta = self._theta(theta)
        lam = np.asarray(next(iter(self.components.values())).grid.lam)
        total = agn = None
        for cname, sim in self.components.items():
            lnu = sim.simulate(self._component_theta(theta, cname),
                               want_spectra=True)["lnu"]
            total = lnu if total is None else total + lnu
            if cname in agn_components:
                agn = lnu if agn is None else agn + lnu
        # ∫ L_ν dν over the window, dν = c/λ² dλ: the c cancels in the ratio
        m = ((lam >= min_wav_rest) & (lam <= max_wav_rest)).astype(np.float32)
        w = torch.as_tensor((m * np.gradient(lam) / lam**2).astype(
            np.float32), device=self.device)
        return torch.sum(agn * w, dim=-1) / torch.clamp(
            torch.sum(total * w, dim=-1), min=1.0e-30)

    def __call__(self, theta):
        return self.photometry(theta)

    @property
    def n_filters(self) -> int:
        return len(self.filters)

    @property
    def n_params(self) -> int:
        return len(self.param_names)


def grid_combinations(param_values: dict) -> tuple:
    """(θ (N, P) float32, names): every combination of the given 1-D value
    arrays, in `np.meshgrid(indexing="ij")` order."""
    names = list(param_values)
    grids = np.meshgrid(*[np.asarray(param_values[n]) for n in names],
                        indexing="ij")
    theta = np.stack([g.reshape(-1) for g in grids], axis=1).astype(np.float32)
    return theta, names
