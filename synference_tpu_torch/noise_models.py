"""Photometric uncertainty models on torch tensors.

Counterpart of the `NoiseModel` interface and `DepthNoiseModel` of
`synference_tpu/noise_models.py`: `apply(generator, flux_njy) ->
(noisy_flux_njy, sigma_njy)`, all in nJy, with noise drawn from an explicit
`torch.Generator` on the flux's device. The empirical and spectral models
and their HDF5 registry are not ported yet (ROADMAP M10).
"""

from __future__ import annotations

import numpy as np
import torch

from . import units as U

__all__ = ["NoiseModel", "DepthNoiseModel"]


class NoiseModel:
    """Interface: `apply(generator, flux_njy) -> (noisy_flux_njy, sigma_njy)`."""

    def apply(self, generator: torch.Generator, flux_njy: torch.Tensor):
        raise NotImplementedError


class DepthNoiseModel(NoiseModel):
    """Gaussian noise at a fixed survey depth: σ = flux(depth_ab) /
    depth_sigma_level, clipped to [min, max] flux error (nJy)."""

    def __init__(self, depth_ab: float, depth_sigma_level: float = 5.0,
                 min_flux_error_njy: float = 0.0,
                 max_flux_error_njy: float = np.inf):
        self.depth_ab = float(depth_ab)
        self.depth_sigma_level = float(depth_sigma_level)
        self.sigma_njy = float(U.ab_depth_to_sigma_njy(depth_ab,
                                                       depth_sigma_level))
        self.min_flux_error_njy = float(min_flux_error_njy)
        self.max_flux_error_njy = float(max_flux_error_njy)

    def apply(self, generator: torch.Generator, flux_njy: torch.Tensor):
        noise = self.sigma_njy * torch.randn(
            flux_njy.shape, generator=generator, dtype=flux_njy.dtype,
            device=flux_njy.device)
        sigma = torch.clamp(torch.full_like(flux_njy, self.sigma_njy),
                            self.min_flux_error_njy, self.max_flux_error_njy)
        return flux_njy + noise, sigma
