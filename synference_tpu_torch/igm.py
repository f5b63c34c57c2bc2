"""Intergalactic-medium attenuation: Inoue14 (default) and Madau95.

Counterpart of `synference_tpu/igm.py`: the same piecewise power laws and
the same Table-2 coefficients (Inoue, Shimizu, Iwata & Tanaka 2014, MNRAS
442, 1805, eqs. 20-29; Madau 1995 eqs. 12-16). `z` may be a scalar or a
tensor that broadcasts against `lam_obs`, so a whole table of redshifts is
one call.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["igm_transmission", "IGM_MODELS"]

# Madau (1995) Lyman-series coefficients: (rest wavelength Å, A_j)
_MADAU_LINES = (
    (1215.67, 0.0036),
    (1025.72, 1.7e-3),
    (972.537, 1.2e-3),
    (949.743, 9.3e-4),
)


def _madau95_tau(lam_obs, z):
    zp1 = 1.0 + z
    tau = torch.zeros_like(lam_obs)
    for lam_j, a_j in _MADAU_LINES:
        x = lam_obs / lam_j
        tau = tau + torch.where(
            (lam_obs < lam_j * zp1) & (x > 1.0), a_j * x**3.46, 0.0)
    xc = torch.clamp(lam_obs / 911.75, min=1.0)
    xem = zp1
    lyc = (
        0.25 * xc**3 * (xem**0.46 - xc**0.46)
        + 9.4 * xc**1.5 * (xem**0.18 - xc**0.18)
        - 0.7 * xc**3 * (xc ** (-1.32) - xem ** (-1.32))
        - 0.023 * (xem**1.68 - xc**1.68)
    )
    return tau + torch.where(lam_obs < 911.75 * zp1,
                             torch.clamp(lyc, min=0.0), 0.0)


# Table 2: λ_j [Å], A_LAF1, A_LAF2, A_LAF3, A_DLA1, A_DLA2 for Lyman series
# lines j = 2..40. LAF segments switch at λ_obs/λ_j = 2.2 and 5.7; DLA at 3.0.
_INOUE_TABLE = np.array([
    [1215.67, 1.690e-02, 2.354e-03, 1.026e-04, 1.617e-04, 5.390e-05],
    [1025.72, 4.692e-03, 6.536e-04, 2.849e-05, 1.545e-04, 5.151e-05],
    [972.537, 2.239e-03, 3.119e-04, 1.360e-05, 1.498e-04, 4.992e-05],
    [949.743, 1.319e-03, 1.837e-04, 8.010e-06, 1.460e-04, 4.868e-05],
    [937.803, 8.707e-04, 1.213e-04, 5.287e-06, 1.429e-04, 4.763e-05],
    [930.748, 6.178e-04, 8.606e-05, 3.752e-06, 1.402e-04, 4.672e-05],
    [926.226, 4.609e-04, 6.421e-05, 2.799e-06, 1.377e-04, 4.590e-05],
    [923.150, 3.569e-04, 4.971e-05, 2.167e-06, 1.355e-04, 4.516e-05],
    [920.963, 2.843e-04, 3.960e-05, 1.726e-06, 1.335e-04, 4.448e-05],
    [919.352, 2.318e-04, 3.229e-05, 1.407e-06, 1.316e-04, 4.385e-05],
    [918.129, 1.923e-04, 2.679e-05, 1.168e-06, 1.298e-04, 4.326e-05],
    [917.181, 1.622e-04, 2.259e-05, 9.847e-07, 1.281e-04, 4.271e-05],
    [916.429, 1.385e-04, 1.929e-05, 8.410e-07, 1.265e-04, 4.218e-05],
    [915.824, 1.196e-04, 1.666e-05, 7.263e-07, 1.250e-04, 4.168e-05],
    [915.329, 1.043e-04, 1.453e-05, 6.334e-07, 1.236e-04, 4.120e-05],
    [914.919, 9.174e-05, 1.278e-05, 5.571e-07, 1.222e-04, 4.075e-05],
    [914.576, 8.128e-05, 1.132e-05, 4.936e-07, 1.209e-04, 4.031e-05],
    [914.286, 7.251e-05, 1.010e-05, 4.403e-07, 1.197e-04, 3.989e-05],
    [914.039, 6.505e-05, 9.062e-06, 3.950e-07, 1.185e-04, 3.949e-05],
    [913.826, 5.868e-05, 8.174e-06, 3.563e-07, 1.173e-04, 3.910e-05],
    [913.641, 5.319e-05, 7.409e-06, 3.230e-07, 1.162e-04, 3.872e-05],
    [913.480, 4.843e-05, 6.746e-06, 2.941e-07, 1.151e-04, 3.836e-05],
    [913.339, 4.427e-05, 6.167e-06, 2.689e-07, 1.140e-04, 3.800e-05],
    [913.215, 4.063e-05, 5.660e-06, 2.467e-07, 1.130e-04, 3.766e-05],
    [913.104, 3.738e-05, 5.207e-06, 2.270e-07, 1.120e-04, 3.732e-05],
    [913.006, 3.454e-05, 4.811e-06, 2.097e-07, 1.110e-04, 3.700e-05],
    [912.918, 3.199e-05, 4.456e-06, 1.943e-07, 1.101e-04, 3.668e-05],
    [912.839, 2.971e-05, 4.139e-06, 1.804e-07, 1.091e-04, 3.637e-05],
    [912.768, 2.766e-05, 3.853e-06, 1.680e-07, 1.082e-04, 3.607e-05],
    [912.703, 2.582e-05, 3.596e-06, 1.568e-07, 1.073e-04, 3.578e-05],
    [912.645, 2.415e-05, 3.364e-06, 1.466e-07, 1.065e-04, 3.549e-05],
    [912.592, 2.263e-05, 3.153e-06, 1.375e-07, 1.056e-04, 3.521e-05],
    [912.543, 2.126e-05, 2.961e-06, 1.291e-07, 1.048e-04, 3.493e-05],
    [912.499, 2.000e-05, 2.785e-06, 1.214e-07, 1.040e-04, 3.466e-05],
    [912.458, 1.885e-05, 2.625e-06, 1.145e-07, 1.032e-04, 3.440e-05],
    [912.420, 1.779e-05, 2.479e-06, 1.080e-07, 1.024e-04, 3.414e-05],
    [912.385, 1.682e-05, 2.343e-06, 1.022e-07, 1.017e-04, 3.389e-05],
    [912.353, 1.593e-05, 2.219e-06, 9.673e-08, 1.009e-04, 3.364e-05],
    [912.324, 1.510e-05, 2.103e-06, 9.169e-08, 1.002e-04, 3.339e-05],
], dtype=np.float32)

_LAM_L = 911.8  # Lyman-limit wavelength [Å], Inoue14 convention


def _inoue14_tau_ls(lam_obs, z):
    """Lyman-series τ (LAF + DLA): one broadcast over the 39-line table."""
    tab = torch.as_tensor(_INOUE_TABLE, device=lam_obs.device)
    zp1 = 1.0 + z
    lam_j = tab[:, 0]
    x = lam_obs[..., None] / lam_j
    in_band = (x > 1.0) & (lam_obs[..., None] < lam_j * zp1[..., None])
    a1, a2, a3, d1, d2 = (tab[:, k] for k in (1, 2, 3, 4, 5))
    tau_laf = torch.where(
        x < 2.2, a1 * x**1.2, torch.where(x < 5.7, a2 * x**3.7, a3 * x**5.5))
    tau_dla = torch.where(x < 3.0, d1 * x**2.0, d2 * x**3.0)
    return torch.sum(torch.where(in_band, tau_laf + tau_dla, 0.0), dim=-1)


def _inoue14_tau_lc_laf(lam_obs, z):
    """Lyα-forest Lyman-continuum τ, eqs. 25-27."""
    x_raw = lam_obs / _LAM_L
    zp1 = 1.0 + z
    in_band = x_raw < zp1
    x = torch.clamp(x_raw, min=1.0)
    low = 0.325 * (x**1.2 - zp1 ** (-0.9) * x**2.1)
    mid = torch.where(
        x < 2.2,
        2.55e-2 * zp1**1.6 * x**2.1 + 0.325 * x**1.2 - 0.250 * x**2.1,
        2.55e-2 * (zp1**1.6 * x**2.1 - x**3.7),
    )
    high = torch.where(
        x < 2.2,
        5.22e-4 * zp1**3.4 * x**2.1 + 0.325 * x**1.2 - 3.14e-2 * x**2.1,
        torch.where(
            x < 5.7,
            5.22e-4 * zp1**3.4 * x**2.1 + 0.218 * x**2.1 - 2.55e-2 * x**3.7,
            5.22e-4 * (zp1**3.4 * x**2.1 - x**5.5),
        ),
    )
    tau = torch.where(z < 1.2, low, torch.where(z < 4.7, mid, high))
    return torch.where(in_band, torch.clamp(tau, min=0.0), 0.0)


def _inoue14_tau_lc_dla(lam_obs, z):
    """DLA Lyman-continuum τ, eqs. 28-29."""
    x_raw = lam_obs / _LAM_L
    zp1 = 1.0 + z
    in_band = x_raw < zp1
    x = torch.clamp(x_raw, min=1.0)
    low = (0.211 * zp1**2.0 - 7.66e-2 * zp1**2.3 * x ** (-0.3)
           - 0.135 * x**2.0)
    high = torch.where(
        x < 3.0,
        0.634 + 4.7e-2 * zp1**3.0 - 1.78e-2 * zp1**3.3 * x ** (-0.3)
        - 0.135 * x**2.0 - 0.291 * x ** (-0.3),
        4.7e-2 * zp1**3.0 - 1.78e-2 * zp1**3.3 * x ** (-0.3)
        - 2.92e-2 * x**3.0,
    )
    tau = torch.where(z < 2.0, low, high)
    return torch.where(in_band, torch.clamp(tau, min=0.0), 0.0)


def igm_transmission(lam_obs: torch.Tensor, z, model: str = "inoue14"):
    """IGM transmission e^{-τ_eff} at observed wavelengths for redshift z.

    Args:
        lam_obs: observed-frame wavelengths [Å], float32.
        z: redshift, a float or a tensor broadcastable against `lam_obs`.
        model: "inoue14" | "madau95" | "none".
    """
    if model in (None, "none"):
        return torch.ones_like(lam_obs)
    z = torch.as_tensor(z, dtype=lam_obs.dtype, device=lam_obs.device)
    if model == "inoue14":
        tau = (_inoue14_tau_ls(lam_obs, z) + _inoue14_tau_lc_laf(lam_obs, z)
               + _inoue14_tau_lc_dla(lam_obs, z))
        return torch.exp(-tau)
    if model in ("madau95", "madau96"):
        return torch.exp(-_madau95_tau(lam_obs, z))
    raise ValueError(f"unknown IGM model {model!r}")


IGM_MODELS = ("inoue14", "madau95", "none")
