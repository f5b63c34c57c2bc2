"""Plain forward model with Charlot & Fall (2000) dust: θ → band photometry
[nJy], for the `cf00` cell.

`forward.ForwardModel` (its SFZH, Inoue 2014 IGM, distances, knot matrix
and knot photometry, unchanged) with two screens in place of the one
Calzetti screen (Charlot & Fall 2000, ApJ 539, 718):

    L_ν = (L_young · exp(−τ_BC·τ̂_λ) + L_old) · exp(−τ_V·τ̂_λ),
    τ̂_λ = (λ / 5500 Å)^−0.7,

with L_young the SFZH's product with the spectra over the cells of grid
ages younger than 10^7 yr and L_old over the rest. Built here from the
formula and the grid's ages; nothing is read from the program under test,
and nothing of it is imported.

Precision: each population's first product is taken by `first_product`
(exact: float64, rounded once to float32), the birth-cloud factor in
float32 as a screen is, and the two populations summed in float64 and
rounded once; the rest is `ForwardModel`'s. The control passes
`forward.tf32_first_product`.

Departures from Charlot & Fall (2000), each a choice of the model the
configuration runs:
- the young population is split by grid age: a cell whose grid age is
  below 10^7 yr is young as a whole, and the age bin that straddles
  10^7 yr is old as a whole, where CF00 splits by each star's own age;
- one power law, slope −0.7, for both screens, as CF00's fit has it
  (later models such as da Cunha et al. 2008 steepen the birth cloud's);
- no escape fraction: every young star sits inside its cloud;
- the grid's nebular emission rides the young cells' spectra, so the
  lines are behind both screens, as CF00 has them; no dust emission
  (the absorbed energy is not re-emitted).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.forward import ForwardModel, exact_first_product


class CF00Model(ForwardModel):
    """`ForwardModel` with the two screens of Charlot & Fall (2000).

    `model` as `ForwardModel`'s, plus "dust_params" {"slope"},
    "age_pivot_log10" and "tau_v_bc_param" (the θ column of τ_BC)."""

    def __init__(self, grid: dict, filters: list, model: dict, device):
        super().__init__(grid, filters, model, device)
        lam = np.asarray(grid["lam"], np.float64)
        l0, l1 = self.support
        slope = float(model["dust_params"]["slope"])
        self.curve = torch.as_tensor(
            ((lam / 5500.0) ** slope)[l0:l1].astype(np.float32),
            device=self.device)
        self.log10_ages = np.asarray(grid["log10_ages"], np.float64)
        self.cells_per_age = len(grid["metallicities"])
        self.pivot = float(model["age_pivot_log10"])
        self.tau_bc_name = model["tau_v_bc_param"]

    def young(self, shift: int = 0):
        """(C,) bool: the cells of grid ages younger than the pivot;
        `shift` moves the split by that many grid ages (a planted fault)."""
        n = int(np.sum(10.0 ** self.log10_ages < 10.0 ** self.pivot)) + shift
        ages = np.arange(len(self.log10_ages)) < n
        return torch.as_tensor(np.repeat(ages, self.cells_per_age),
                               device=self.device)

    def photometry(self, theta, first_product=exact_first_product,
                   block: int = 512, drop_bc: bool = False,
                   pivot_shift: int = 0):
        """(B, P) θ float32 on the model's device -> (B, F) band fluxes
        [nJy], in blocks of `block` rows. The planted faults: `drop_bc`
        leaves the birth cloud out (τ_BC read as 0), `pivot_shift` moves
        the young/old split by that many grid ages."""
        young = self.young(pivot_shift)
        out = []
        for i in range(0, theta.shape[0], block):
            rows = theta[i:i + block]
            tau_bc = self._col(rows, self.tau_bc_name)
            if drop_bc:
                tau_bc = torch.zeros_like(tau_bc)
            out.append(self._block(rows, self._two_screens(
                first_product, young, tau_bc)))
        return torch.cat(out)

    def _two_screens(self, first_product, young, tau_bc):
        """The first product of `ForwardModel._block` with the birth cloud
        over the young cells: L_young·exp(−τ_BC·τ̂) + L_old, whose ISM
        screen `_block` then applies."""
        bc = torch.exp(-tau_bc[:, None] * self.curve[None, :])

        def product(sfzh, sed_w):
            lum_young = first_product(sfzh[:, young], sed_w[young])
            lum_old = first_product(sfzh[:, ~young], sed_w[~young])
            return (lum_young.double() * bc.double()
                    + lum_old.double()).float()

        return product
