"""Flat-ΛCDM cosmology on torch tensors.

Counterpart of `synference_tpu/cosmology.py`: the same fixed-order (64-node)
Gauss–Legendre quadratures for luminosity distance and age, evaluated in
float32 on whatever device the redshift tensor lives on. Radiation and
neutrino densities are neglected (error <0.1% for z < 20).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .units import C_CM_S, MPC_CM

# Hubble time for H0 = 1 km/s/Mpc, in Gyr: (Mpc/km) s -> Gyr
_HUBBLE_GYR = MPC_CM / 1.0e5 / 3.1557e16  # = 977.79 Gyr
# Hubble distance for H0 = 1 km/s/Mpc, in Mpc
_HUBBLE_MPC = C_CM_S / 1.0e5  # = 299792.458 Mpc

_GL_ORDER = 64
_GL_X, _GL_W = np.polynomial.legendre.leggauss(_GL_ORDER)


def _z_tensor(z) -> torch.Tensor:
    if isinstance(z, torch.Tensor):
        return z.to(torch.float32)
    return torch.as_tensor(np.asarray(z, np.float32))


def _gauss_legendre(upper, integrand):
    """∫_0^upper integrand(x) dx, broadcast over the trailing batch dims."""
    x = torch.as_tensor(_GL_X, dtype=torch.float32, device=upper.device)
    w = torch.as_tensor(_GL_W, dtype=torch.float32, device=upper.device)
    half = 0.5 * upper[..., None]
    return torch.sum(w * integrand(half * (x + 1.0)), dim=-1) * half[..., 0]


@dataclass(frozen=True)
class Cosmology:
    """Flat ΛCDM. Defaults are Planck 2018 (TT,TE,EE+lowE+lensing+BAO)."""

    h0: float = 67.66  # km/s/Mpc
    om0: float = 0.30966

    @property
    def ode0(self) -> float:
        return 1.0 - self.om0

    @property
    def hubble_time_gyr(self) -> float:
        return _HUBBLE_GYR / self.h0

    @property
    def hubble_distance_mpc(self) -> float:
        return _HUBBLE_MPC / self.h0

    def comoving_distance_mpc(self, z):
        """d_C(z) = d_H ∫0^z dz'/E(z')."""
        z = _z_tensor(z)
        integral = _gauss_legendre(
            z, lambda zz: 1.0 / torch.sqrt(self.om0 * (1.0 + zz) ** 3 + self.ode0))
        return self.hubble_distance_mpc * integral

    def luminosity_distance_mpc(self, z):
        z = _z_tensor(z)
        return (1.0 + z) * self.comoving_distance_mpc(z)

    def luminosity_distance_cm(self, z):
        return self.luminosity_distance_mpc(z) * MPC_CM

    def age_gyr(self, z):
        """Age of the universe at z: t_H ∫0^{a(z)} sqrt(a) da / sqrt(Om + Ode a³)."""
        z = _z_tensor(z)
        a = 1.0 / (1.0 + z)
        integral = _gauss_legendre(
            a, lambda aa: torch.sqrt(aa) / torch.sqrt(self.om0 + self.ode0 * aa**3))
        return self.hubble_time_gyr * integral

    def age_yr(self, z):
        return self.age_gyr(z) * 1.0e9


PLANCK18 = Cosmology()
