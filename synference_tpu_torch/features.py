"""Feature engineering: raw photometry -> training feature arrays.

Counterpart of `synference_tpu/features.py` (`FeatureConfig`,
`FeaturePipeline.build`) for the configuration the mock-library path uses:
depth-noise scattering (`depths_ab`, `n_scatters`), a unit transform with
error propagation (`unit`, `asinh_softening_njy`), optional error columns,
an error floor and dropped filters. Column order follows the JAX package:
[photometry (F'), unc_* (F')].

Normalization, missing-band simulation, flag columns, extra features,
multi-set depths, θ-column transforms and the replay on observations are not
ported yet (ROADMAP M6); configs that ask for them raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import units as U
from .noise_models import DepthNoiseModel

__all__ = ["FeatureConfig", "FeaturePipeline", "FeatureResult"]


@dataclass(frozen=True)
class FeatureConfig:
    """Static feature-engineering configuration (the JAX package's fields,
    less `norm_unit` and `missing_value`, which only the unported options
    read; see its docstring for their meaning)."""

    filter_codes: tuple
    remove_filters: tuple = ()
    unit: str = "asinh"
    asinh_softening_njy: object = 5.0
    n_scatters: int = 1
    depths_ab: tuple | None = None
    depth_sigma_level: float = 5.0
    min_pct_error: float = 0.0
    include_errors: bool = True
    include_flags: bool = False
    normalize_method: str | None = None
    missing_fraction: float = 0.0
    missing_flux_options: tuple = ()
    extra_features: tuple = ()
    remove_parameters: tuple = ()
    add_parameters: tuple = ()
    parameter_transforms: tuple = ()

    def unported_fields(self) -> list:
        """Names of set options this package does not implement yet."""
        asked = {
            "include_flags": self.include_flags,
            "normalize_method": self.normalize_method is not None,
            "missing_fraction": self.missing_fraction > 0,
            "missing_flux_options": bool(self.missing_flux_options),
            "extra_features": bool(self.extra_features),
            "remove_parameters": bool(self.remove_parameters),
            "add_parameters": bool(self.add_parameters),
            "parameter_transforms": bool(self.parameter_transforms),
            "depths_ab (multi-set)": bool(
                self.depths_ab
                and isinstance(self.depths_ab[0], (tuple, list))),
        }
        return [k for k, v in asked.items() if v]


@dataclass
class FeatureResult:
    features: np.ndarray  # (N', D)
    feature_names: list
    parameters: np.ndarray | None  # (N', P) scatter-repeated, NaN-pruned
    flags: dict = field(default_factory=dict)
    # source-galaxy index per row: scatter copies share it (group splits on it)
    source_index: np.ndarray | None = None


class FeaturePipeline:
    """Build training features from noiseless library photometry.

    Args:
        config: FeatureConfig.
        noise_models: optional {filter_code: NoiseModel}; when absent and
            `config.depths_ab` is set, DepthNoiseModels are built.
    """

    def __init__(self, config: FeatureConfig, noise_models: dict | None = None):
        unported = config.unported_fields()
        if unported:
            raise NotImplementedError(
                f"FeatureConfig options {unported} are not ported yet "
                "(ROADMAP M6)")
        self.config = config
        self.kept_codes = [c for c in config.filter_codes
                           if c not in config.remove_filters]
        self._keep_idx = [list(config.filter_codes).index(c)
                          for c in self.kept_codes]
        self.noise_models = dict(noise_models or {})
        if not self.noise_models and config.depths_ab is not None:
            depths = dict(zip(config.filter_codes, config.depths_ab))
            self.noise_models = {
                c: DepthNoiseModel(depths[c], config.depth_sigma_level)
                for c in self.kept_codes}
        self._softening = self._resolve_softening()

    def _resolve_softening(self) -> np.ndarray:
        """Per-kept-filter asinh softening b in nJy."""
        cfg = self.config
        s = cfg.asinh_softening_njy
        if isinstance(s, str):
            # "snr_5": b = the 5-sigma depth noise level per filter
            level = float(s.split("_")[1])
            if cfg.depths_ab is None:
                raise ValueError("snr-based softening requires depths_ab")
            depths = dict(zip(cfg.filter_codes, cfg.depths_ab))
            return np.array([
                float(U.ab_depth_to_sigma_njy(depths[c], cfg.depth_sigma_level))
                * level for c in self.kept_codes])
        if isinstance(s, (tuple, list, np.ndarray)):
            arr = np.asarray(s, dtype=np.float64)
            if len(arr) == len(cfg.filter_codes):
                arr = arr[self._keep_idx]
            if len(arr) != len(self.kept_codes):
                raise ValueError("softening length mismatch")
            return arr
        return np.full(len(self.kept_codes), float(s))

    def _scatter(self, generator, phot_njy):
        """(N, F') -> noisy (S·N, F'), sigma (S·N, F') or None; scatter
        repetitions tiled along axis 0, per-filter models column-wise."""
        cfg = self.config
        tiled = phot_njy.repeat(cfg.n_scatters, 1)
        if not self.noise_models:
            return tiled, None
        cols, sigs = [], []
        for j, code in enumerate(self.kept_codes):
            noisy, sig = self.noise_models[code].apply(generator, tiled[:, j])
            cols.append(noisy)
            sigs.append(sig)
        noisy = torch.stack(cols, dim=1)
        sigma = torch.stack(sigs, dim=1)
        if cfg.min_pct_error > 0:
            sigma = torch.maximum(sigma, cfg.min_pct_error * torch.abs(noisy))
        return noisy, sigma

    def _to_unit(self, flux_njy, sigma_njy):
        """nJy flux and 1σ -> the configured feature unit (σ propagated)."""
        cfg = self.config
        fb = torch.as_tensor(self._softening, dtype=torch.float32,
                             device=flux_njy.device)
        x = U.convert_flux(flux_njy, "nJy", cfg.unit, f_b_njy=fb)
        xe = (None if sigma_njy is None else
              U.convert_flux_err(flux_njy, sigma_njy, "nJy", cfg.unit,
                                 f_b_njy=fb))
        return x, xe

    def build(self, generator: torch.Generator, phot_njy, parameters=None,
              remove_nan: bool = True) -> FeatureResult:
        """Training-time features (scattering on).

        Args:
            generator: noise source, on the photometry's device.
            phot_njy: (N, F) noiseless photometry [nJy] in
                config.filter_codes order (tensor or array).
            parameters: optional (N, P) θ, repeated per scatter and
                NaN-pruned in sync with the features.
        """
        cfg = self.config
        phot = torch.as_tensor(phot_njy, dtype=torch.float32,
                               device=generator.device)[:, self._keep_idx]
        n = phot.shape[0]
        noisy, sigma = self._scatter(generator, phot)
        x, xe = self._to_unit(noisy, sigma)
        blocks = [x]
        names = list(self.kept_codes)
        if cfg.include_errors and xe is not None:
            blocks.append(xe)
            names += [f"unc_{c}" for c in self.kept_codes]
        features = torch.cat(blocks, dim=1).cpu().numpy()
        params = (None if parameters is None else np.tile(
            np.asarray(torch.as_tensor(parameters).cpu(), np.float32),
            (cfg.n_scatters, 1)))
        source_index = np.tile(np.arange(n), cfg.n_scatters)
        if remove_nan:
            good = np.isfinite(features).all(axis=1)
            features, source_index = features[good], source_index[good]
            if params is not None:
                params = params[good]
        return FeatureResult(features=features, feature_names=names,
                             parameters=params,
                             flags={"feature_names": names,
                                    "n_input_rows": int(n)},
                             source_index=source_index)
