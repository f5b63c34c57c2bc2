"""Feature engineering: raw photometry -> training feature arrays.

Counterpart of `synference_tpu/features.py` (`FeatureConfig`,
`FeaturePipeline.build`) for the configuration the mock-library path uses:
depth-noise scattering (`depths_ab`, `n_scatters`), a unit transform with
error propagation (`unit`, `asinh_softening_njy`), optional error columns,
an error floor and dropped filters. Column order follows the JAX package:
[photometry (F'), unc_* (F')].

`FeatureConfig.to_flags` / `from_flags` write and read the JAX package's
provenance record (same names and values), and `transform_observations`
replays the training transform on a catalogue.

Normalization, missing-band simulation, flag columns, extra features,
multi-set depths and θ-column transforms are not ported yet (ROADMAP M6);
configs, and flag records, that ask for them raise NotImplementedError.
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
    """Static feature-engineering configuration (the JAX package's fields;
    see its docstring for their meaning). `norm_unit` and `missing_value`
    are read by unported options only and are carried for the flag record."""

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
    norm_unit: str = "log10_nJy"
    missing_fraction: float = 0.0
    missing_flux_options: tuple = ()
    missing_value: float = 99.0
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

    def to_flags(self) -> dict:
        """The serialisable provenance record (feature_array_flags)."""
        multi = bool(self.depths_ab) and isinstance(
            self.depths_ab[0], (tuple, list))
        return {
            "filter_codes": list(self.filter_codes),
            "remove_filters": list(self.remove_filters),
            "unit": self.unit,
            "asinh_softening_njy": (
                list(self.asinh_softening_njy)
                if isinstance(self.asinh_softening_njy, (tuple, list))
                else self.asinh_softening_njy),
            "n_scatters": self.n_scatters,
            "depths_ab": (
                [list(row) for row in self.depths_ab] if multi
                else (list(self.depths_ab) if self.depths_ab else None)),
            "depth_sigma_level": self.depth_sigma_level,
            "min_pct_error": self.min_pct_error,
            "include_errors": self.include_errors,
            "include_flags": self.include_flags,
            "normalize_method": self.normalize_method,
            "norm_unit": self.norm_unit,
            "missing_fraction": self.missing_fraction,
            "missing_flux_options": [list(m)
                                     for m in self.missing_flux_options],
            "missing_value": self.missing_value,
            "extra_features": list(self.extra_features),
            "remove_parameters": list(self.remove_parameters),
            "add_parameters": list(self.add_parameters),
            "parameter_transforms": [list(t)
                                     for t in self.parameter_transforms],
        }

    @classmethod
    def from_flags(cls, d: dict) -> "FeatureConfig":
        d = dict(d)
        d["filter_codes"] = tuple(d["filter_codes"])
        d["remove_filters"] = tuple(d.get("remove_filters", ()))
        soft = d.get("asinh_softening_njy", 5.0)
        d["asinh_softening_njy"] = (tuple(soft) if isinstance(soft, list)
                                    else soft)
        dep = d.get("depths_ab")
        if dep and isinstance(dep[0], (tuple, list)):
            d["depths_ab"] = tuple(tuple(row) for row in dep)
        else:
            d["depths_ab"] = tuple(dep) if dep else None
        d["missing_flux_options"] = tuple(
            tuple(m) for m in d.get("missing_flux_options", ()))
        for key in ("extra_features", "remove_parameters", "add_parameters"):
            d[key] = tuple(d.get(key, ()))
        d["parameter_transforms"] = tuple(
            tuple(t) for t in d.get("parameter_transforms", ()))
        return cls(**d)


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
        flags = cfg.to_flags()
        flags["feature_names"] = names
        flags["n_input_rows"] = int(n)
        return FeatureResult(features=features, feature_names=names,
                             parameters=params, flags=flags,
                             source_index=source_index)

    def transform_observations(self, flux, flux_err=None, flux_unit="nJy",
                               missing_mask=None, *, device) -> np.ndarray:
        """Replay the training transform on observations (no scattering).

        Args:
            flux: (M, F) observed fluxes in config.filter_codes order.
            flux_err: (M, F) matching 1σ errors (required when the training
                features include errors).
            flux_unit: unit of the provided values.
            missing_mask: per-band missing flags; not ported (ROADMAP M6).
            device: where the transform runs.
        """
        if missing_mask is not None:
            raise NotImplementedError(
                "missing-band replay is not ported yet (ROADMAP M6)")
        cfg = self.config
        flux = torch.as_tensor(flux, dtype=torch.float32, device=device)
        f_njy = U.convert_flux(flux, flux_unit, "nJy")[:, self._keep_idx]
        e_njy = None
        if flux_err is not None:
            err = torch.as_tensor(flux_err, dtype=torch.float32,
                                  device=device)
            e_njy = U.convert_flux_err(flux, err, flux_unit,
                                       "nJy")[:, self._keep_idx]
            if cfg.min_pct_error > 0:
                e_njy = torch.maximum(e_njy,
                                      cfg.min_pct_error * torch.abs(f_njy))
        x, xe = self._to_unit(f_njy, e_njy)
        blocks = [x]
        if cfg.include_errors and xe is not None:
            blocks.append(xe)
        return torch.cat(blocks, dim=1).cpu().numpy()

    @classmethod
    def from_flags(cls, flags: dict, noise_models=None) -> "FeaturePipeline":
        """The pipeline of a flag record, as `build` or the JAX package
        wrote it."""
        flags = {k: v for k, v in flags.items()
                 if k not in ("feature_names", "n_input_rows")}
        return cls(FeatureConfig.from_flags(flags), noise_models)
