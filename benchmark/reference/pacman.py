"""Plain forward model with Pacman emission and a free escape fraction:
θ → band photometry [nJy], for the `pacman` cell.

`forward.ForwardModel` (its SFZH, Calzetti 2000 screen, Inoue 2014 IGM,
distances, knot matrix and knot photometry, unchanged) with Synthesizer's
`PacmanEmission` mix in place of its one screened product:

    L_ν = fesc · L_incident + (1 − fesc) · L_total · exp(−τ_V·k_λ),

with fesc a column of θ, L_incident the SFZH's product with the grid's
incident spectra (the light that escapes, unscreened) and L_total its
product with the grid's transmitted + nebular spectra (the light the
nebula reprocesses, behind the ISM screen). Built here from the formula
and the grid's arrays; nothing is read from the program under test, and
nothing of it is imported.

Precision: both first products are taken by `first_product` (exact:
float64, rounded once to float32), the screen in float32 as
`ForwardModel` takes it, and the mix in float64, rounded once to float32;
the rest is `ForwardModel`'s. The control passes
`forward.tf32_first_product`.

Departures from Synthesizer's `PacmanEmission`, each a choice of the model
the configuration runs:
- Lyman-α escapes as the other lines do: `fesc_ly_alpha` is 1, so the
  line rides the reprocessed light scaled by (1 − fesc), where Synthesizer
  scales it by its own escape fraction;
- the reprocessed light is the grid's "total" (transmitted + nebular, made
  at fesc 0) scaled by (1 − fesc) as a whole, where Synthesizer builds the
  transmitted and nebular parts from the grid's own components (the same
  sum: each part is linear in (1 − fesc));
- one ISM screen, Calzetti 2000, over the reprocessed light, no birth
  cloud, and no dust emission (the absorbed energy is not re-emitted).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.forward import ForwardModel, exact_first_product


class PacmanModel(ForwardModel):
    """`ForwardModel` with Synthesizer's Pacman mix.

    `model` as `ForwardModel`'s, plus "fesc" (the θ column of the escape
    fraction) and "incident_type" (the grid's array of escaped light)."""

    def __init__(self, grid: dict, filters: list, model: dict, device):
        super().__init__(grid, filters, model, device)
        l0, l1 = self.support
        lam = np.asarray(grid["lam"], np.float64)
        wlam = torch.as_tensor((np.gradient(lam) / lam).astype(np.float32),
                               device=self.device)
        spectra = torch.as_tensor(grid[model["incident_type"]],
                                  device=self.device)
        spectra = spectra.reshape(-1, lam.shape[0])[:, l0:l1]
        self.inc_w = (spectra * wlam[None, l0:l1]).contiguous()
        self.fesc_name = model["fesc"]

    def photometry(self, theta, first_product=exact_first_product,
                   block: int = 512, fesc_ignored: bool = False,
                   escape_screened: bool = False):
        """(B, P) θ float32 on the model's device -> (B, F) band fluxes
        [nJy], in blocks of `block` rows. The planted faults:
        `fesc_ignored` reads fesc as 0, `escape_screened` puts the escaped
        light behind the ISM screen too."""
        out = []
        for i in range(0, theta.shape[0], block):
            rows = theta[i:i + block]
            fesc = self._col(rows, self.fesc_name)
            if fesc_ignored:
                fesc = torch.zeros_like(fesc)
            att = torch.exp(-self._col(rows, "tau_v")[:, None]
                            * self.curve[None, :])
            # `_block` screens what the product returns by its row's τ_V:
            # with τ_V read as 0 that screen is exp(0) = 1 exactly, and the
            # product below applies the real one to the reprocessed light
            unscreened = rows.clone()
            unscreened[:, self.param_names.index("tau_v")] = 0.0
            out.append(self._block(unscreened, self._mix(
                first_product, fesc, att, escape_screened)))
        return torch.cat(out)

    def _mix(self, first_product, fesc, att, escape_screened: bool):
        """The first product of `ForwardModel._block` as Pacman's mix:
        fesc·L_incident + (1 − fesc)·L_total·exp(−τ_V·k), in float64,
        rounded once (with `escape_screened`, the escaped part screened
        too)."""
        f = fesc.double()[:, None]
        a = att.double()

        def product(sfzh, sed_w):
            inc = first_product(sfzh, self.inc_w).double()
            rep = first_product(sfzh, sed_w).double()
            escaped = f * inc * (a if escape_screened else 1.0)
            return (escaped + (1.0 - f) * rep * a).float()

        return product
