"""Feature engineering: raw photometry -> training feature arrays.

Counterpart of `synference_tpu/features.py`: noise scattering (per-filter
depth models or multi-set depths, `n_scatters` repetitions), a unit
transform with error propagation, normalisation by a filter or by a
parameter or supplementary column, simulated missing bands (a random
fraction or preset masks) with flag columns, filter-arithmetic extra
features, and the fitted θ columns (removed, added from supplementary
quantities, transformed by `PARAMETER_TRANSFORMS`). Column order follows
the JAX package:

    [photometry (F'), unc_* (F'), flag_* (F'), extra features, norm]

`FeatureConfig.to_flags` / `from_flags` write and read the JAX package's
provenance record, and `transform_observations` replays the training
transform on a catalogue. Noise and missing-band draws come from a
`torch.Generator`; `build` also takes the missing-band mask and the depth
set of each row as arrays, so that two runs, or two packages, can share
them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import units as U
from .filter_arithmetic import FilterArithmeticParser
from .noise_models import DepthNoiseModel

__all__ = ["FeatureConfig", "FeaturePipeline", "FeatureResult",
           "PARAMETER_TRANSFORMS"]

# named θ-column transforms (a name registry keeps the flag record
# serialisable)
PARAMETER_TRANSFORMS = {
    "log10": torch.log10,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "pow10": lambda v: 10.0 ** v,
    "arcsinh": torch.arcsinh,
}


@dataclass(frozen=True)
class FeatureConfig:
    """Static feature-engineering configuration, the JAX package's fields
    with their meaning there: `normalize_method` names a filter, a
    parameter or a supplementary column (appended in `norm_unit`);
    `missing_fraction` / `missing_flux_options` simulate missing bands
    (set to `missing_value`, flagged with `include_flags`); `depths_ab`
    is per filter or a tuple of per-filter sets (one drawn per row);
    `remove_parameters` / `add_parameters` / `parameter_transforms` edit the
    fitted θ columns."""

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
        """Names of set options this package does not implement: none, every
        field of the JAX package's configuration is ported."""
        return []

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
    # fitted θ column names after remove/add/transform (None: no parameters)
    parameter_names: list | None = None




def _column(values, names, name: str, device):
    """Column `name` of (N, K) `values` whose columns are `names`."""
    return torch.as_tensor(values, dtype=torch.float32,
                           device=device)[:, list(names).index(name)]


class FeaturePipeline:
    """Build training features from noiseless library photometry, and replay
    the transform on observations.

    Args:
        config: FeatureConfig.
        noise_models: optional {filter_code: NoiseModel}; when absent and
            `config.depths_ab` is set, DepthNoiseModels are built (or, for
            2-D depths, a table of per-set noise levels).
    """

    def __init__(self, config: FeatureConfig, noise_models: dict | None = None):
        self.config = config
        self.kept_codes = [c for c in config.filter_codes
                           if c not in config.remove_filters]
        self._keep_idx = [list(config.filter_codes).index(c)
                          for c in self.kept_codes]
        self.noise_models = dict(noise_models or {})
        self._depth_sets_njy = None  # (k, F') σ per depth set
        if not self.noise_models and config.depths_ab is not None:
            if isinstance(config.depths_ab[0], (tuple, list)):
                sets = np.asarray(config.depths_ab, np.float64)
                if sets.shape[1] != len(config.filter_codes):
                    raise ValueError(
                        f"2-D depths_ab must be (k, "
                        f"{len(config.filter_codes)}); got {sets.shape}")
                self._depth_sets_njy = np.stack([
                    [float(U.ab_depth_to_sigma_njy(d, config.depth_sigma_level))
                     for d in row] for row in sets])[:, self._keep_idx]
            else:
                depths = dict(zip(config.filter_codes, config.depths_ab))
                self.noise_models = {
                    c: DepthNoiseModel(depths[c], config.depth_sigma_level)
                    for c in self.kept_codes}
        self._softening = self._resolve_softening()

    @property
    def _norm_filter(self) -> int | None:
        """Index among the kept filters of the normalising filter, if any."""
        method = self.config.normalize_method
        return self.kept_codes.index(method) if method in self.kept_codes \
            else None

    @property
    def _phot_codes(self) -> list:
        """The kept filters that stay photometry columns (all but the
        normalising one)."""
        return [c for c in self.kept_codes
                if c != self.config.normalize_method]

    def _resolve_softening(self) -> np.ndarray:
        """Per-kept-filter asinh softening b in nJy."""
        cfg = self.config
        s = cfg.asinh_softening_njy
        if isinstance(s, str):
            # "snr_5": b = the 5-sigma depth noise level per filter (the
            # mean over sets for multi-set depths)
            level = float(s.split("_")[1])
            if cfg.depths_ab is None:
                raise ValueError("snr-based softening requires depths_ab")
            if self._depth_sets_njy is not None:
                return self._depth_sets_njy.mean(axis=0) * level
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

    def _scatter(self, generator, phot_njy, depth_set=None):
        """(N, F') -> noisy (S·N, F'), sigma (S·N, F') or None; scatter
        repetitions tiled along axis 0, per-filter models column-wise, or
        one depth set per row (drawn, or `depth_set` (S·N,) passed in)."""
        cfg = self.config
        tiled = phot_njy.repeat(cfg.n_scatters, 1)
        if self._depth_sets_njy is not None:
            sets = torch.as_tensor(self._depth_sets_njy, dtype=torch.float32,
                                   device=tiled.device)
            if depth_set is None:
                depth_set = torch.randint(0, sets.shape[0], (tiled.shape[0],),
                                          generator=generator,
                                          device=tiled.device)
            sigma = sets[torch.as_tensor(depth_set, device=tiled.device).long()]
            if cfg.min_pct_error > 0:
                sigma = torch.maximum(sigma, cfg.min_pct_error * tiled.abs())
            noise = torch.randn(tiled.shape, generator=generator,
                                device=tiled.device)
            return tiled + sigma * noise, sigma
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

    def _norm_is_mag(self) -> bool:
        return U.FluxUnit.parse(self.config.unit) in (
            U.FluxUnit.AB, U.FluxUnit.ASINH, U.FluxUnit.LOG10_NJY)

    def _normalize_by_filter(self, x, xe, raw_njy):
        """Drop the normalising filter's column and normalise the rest by
        it (a difference in magnitude units, a ratio otherwise); returns
        (x, xe, the appended norm column from its raw nJy flux)."""
        cfg = self.config
        j = self._norm_filter
        norm_col = x[:, j]
        sel = [i for i in range(x.shape[1]) if i != j]
        x = x[:, sel]
        xe = None if xe is None else xe[:, sel]
        if self._norm_is_mag():
            x = x - norm_col[:, None]
        else:
            safe = torch.where(norm_col == 0, 1.0, norm_col)
            x = x / safe[:, None]
            if xe is not None:
                xe = xe / safe.abs()[:, None]
        return x, xe, U.convert_flux(raw_njy[:, j], "nJy", cfg.norm_unit)

    def _normalize_by_value(self, x, col):
        """Normalise by a per-row parameter or supplementary value, read as
        a flux in nJy for magnitude units; returns (x, norm column)."""
        cfg = self.config
        if self._norm_is_mag():
            if not bool(torch.isfinite(col).all() and (col > 0).all()):
                raise ValueError(
                    f"normalize_method={cfg.normalize_method!r}: "
                    "magnitude-space normalisation treats the column as a "
                    "flux in nJy, but it holds non-positive or non-finite "
                    "values; use a flux-like quantity or a linear unit")
            factor = U.convert_flux(col, "nJy", cfg.unit,
                                    f_b_njy=float(np.mean(self._softening)))
            x = x - factor[:, None]
        else:
            x = x / torch.where(col == 0, 1.0, col)[:, None]
        return x, U.convert_flux(col, "nJy", cfg.norm_unit)

    def _missing_options(self, device):
        """The preset masks over the photometry columns (the normalising
        filter's column removed)."""
        opts = torch.as_tensor(self.config.missing_flux_options,
                               dtype=torch.float32, device=device)
        j = self._norm_filter
        if j is not None:
            opts = torch.cat([opts[:, :j], opts[:, j + 1:]], dim=1)
        return opts

    def _extra_columns(self, x_pre_missing, values: dict):
        """The `extra_features` columns: a named value from `values`, or a
        filter-arithmetic expression over the photometry columns."""
        cols = dict(zip(self._phot_codes, x_pre_missing.unbind(dim=1)))
        parser = FilterArithmeticParser()
        out = []
        for expr in self.config.extra_features:
            if expr in values:
                out.append(values[expr])
                continue
            try:
                out.append(parser.parse_and_evaluate(expr, cols))
            except KeyError as e:
                raise ValueError(
                    f"extra feature {expr!r} is neither a filter expression "
                    "nor a supplied parameter/supplementary column (pass it "
                    "as extra_values={...} when transforming observations)"
                ) from e
        return out

    def build(self, generator: torch.Generator, phot_njy, parameters=None,
              parameter_names=(), supplementary=None, supplementary_names=(),
              remove_nan: bool = True, *, missing_mask=None,
              depth_set=None) -> FeatureResult:
        """Training-time features (scattering on).

        Args:
            generator: noise and missing-band source, on the photometry's
                device.
            phot_njy: (N, F) noiseless photometry [nJy] in
                config.filter_codes order (tensor or array).
            parameters: optional (N, P) θ with columns `parameter_names`,
                repeated per scatter and NaN-pruned with the features.
            supplementary: optional (N, S) columns `supplementary_names`,
                for normalisation, extra features and added θ columns.
            missing_mask: optional (S·N, F'') 0/1 mask over the photometry
                columns (1 = missing), used instead of the drawn one.
            depth_set: optional (S·N,) set index per row for 2-D depths,
                used instead of the drawn one.
        """
        cfg = self.config
        dev = generator.device
        phot = torch.as_tensor(phot_njy, dtype=torch.float32,
                               device=dev)[:, self._keep_idx]
        n, s = phot.shape[0], cfg.n_scatters
        noisy, sigma = self._scatter(generator, phot, depth_set)
        x, xe = self._to_unit(noisy, sigma)
        named = {}  # parameter, then supplementary columns, scatter-tiled
        for vals, cols in ((parameters, parameter_names),
                           (supplementary, supplementary_names)):
            if vals is not None and len(cols):
                t = torch.as_tensor(vals, dtype=torch.float32, device=dev)
                for i, name in enumerate(cols):
                    named.setdefault(name, t[:, i].repeat(s))

        norm = None
        if cfg.normalize_method is not None:
            if self._norm_filter is not None:
                x, xe, norm = self._normalize_by_filter(x, xe,
                                                        phot.repeat(s, 1))
            elif cfg.normalize_method in named:
                x, norm = self._normalize_by_value(
                    x, named[cfg.normalize_method])
            else:
                raise ValueError(
                    f"normalize_method {cfg.normalize_method!r} is neither a "
                    "filter nor a parameter/supplementary name")
        names = list(self._phot_codes)
        x_pre_missing = x
        blocks = [x]
        if cfg.include_errors and xe is not None:
            blocks.append(xe)
            names += [f"unc_{c}" for c in self._phot_codes]

        if missing_mask is None:
            if cfg.missing_flux_options:
                opts = self._missing_options(dev)
                choice = torch.randint(0, opts.shape[0], (x.shape[0],),
                                       generator=generator, device=dev)
                missing_mask = opts[choice]
            elif cfg.missing_fraction > 0:
                missing_mask = (torch.rand(x.shape, generator=generator,
                                           device=dev) < cfg.missing_fraction)
        if missing_mask is not None:
            mask = torch.as_tensor(missing_mask, device=dev).to(torch.float32)
            blocks[0] = torch.where(mask == 1.0, cfg.missing_value, x)
            if len(blocks) > 1:
                blocks[1] = torch.where(mask == 1.0, cfg.missing_value,
                                        blocks[1])
            if cfg.include_flags:
                blocks.append(mask)
                names += [f"flag_{c}" for c in self._phot_codes]
        for expr, col in zip(cfg.extra_features,
                             self._extra_columns(x_pre_missing, named)):
            blocks.append(col[:, None])
            names.append(expr)
        if norm is not None:
            blocks.append(norm[:, None])
            names.append(f"norm_{cfg.normalize_method}_{cfg.norm_unit}")
        features = torch.cat(blocks, dim=1).cpu().numpy()

        params, param_names = None, None
        if parameters is not None:
            params, param_names = self._fitted_parameters(
                parameters, parameter_names, supplementary,
                supplementary_names, dev)
            params = np.tile(params, (s, 1))
        source_index = np.tile(np.arange(n), s)
        if remove_nan:
            good = np.isfinite(features).all(axis=1)
            if params is not None and cfg.parameter_transforms:
                good &= np.isfinite(params).all(axis=1)
            features, source_index = features[good], source_index[good]
            if params is not None:
                params = params[good]
        flags = cfg.to_flags()
        flags["feature_names"] = names
        flags["n_input_rows"] = int(n)
        return FeatureResult(features=features, feature_names=names,
                             parameters=params, flags=flags,
                             source_index=source_index,
                             parameter_names=param_names)

    def _fitted_parameters(self, parameters, parameter_names, supplementary,
                           supplementary_names, device):
        """The fitted θ columns: removed, added from supplementary columns,
        transformed; returns ((N, P') float32 array, names)."""
        cfg = self.config
        # a copy: the transforms below write into it
        p = torch.tensor(np.asarray(torch.as_tensor(parameters).cpu()),
                         dtype=torch.float32, device=device)
        names = list(parameter_names)
        if cfg.remove_parameters:
            keep = [i for i, name in enumerate(names)
                    if name not in cfg.remove_parameters]
            p, names = p[:, keep], [names[i] for i in keep]
        for name in cfg.add_parameters:
            if name not in tuple(supplementary_names):
                raise ValueError(
                    f"add_parameters entry {name!r} not in supplementary "
                    f"names {tuple(supplementary_names)}")
            col = _column(supplementary, supplementary_names, name, device)
            p = torch.cat([p, col[:, None]], dim=1)
            names.append(name)
        for pname, tname in cfg.parameter_transforms:
            if tname not in PARAMETER_TRANSFORMS:
                raise ValueError(
                    f"unknown parameter transform {tname!r}; known: "
                    f"{sorted(PARAMETER_TRANSFORMS)}")
            if pname not in names:
                raise ValueError(f"parameter {pname!r} not found for "
                                 "transform")
            j = names.index(pname)
            p[:, j] = PARAMETER_TRANSFORMS[tname](p[:, j])
            names[j] = f"{tname}_{pname}"
        return p.cpu().numpy(), names

    def transform_observations(self, flux, flux_err=None, flux_unit="nJy",
                               missing_mask=None,
                               extra_values: dict | None = None,
                               norm_values=None, *, device) -> np.ndarray:
        """Replay the training transform on observations (no scattering).

        Args:
            flux: (M, F) observed fluxes in config.filter_codes order.
            flux_err: (M, F) matching 1σ errors (required when the training
                features include errors).
            flux_unit: unit of the provided values.
            missing_mask: optional (M, F) 0/1 array, 1 = missing.
            extra_values: {name: (M,)} for `extra_features` that named a
                parameter or supplementary column at training time.
            norm_values: (M,) per-object values when `normalize_method`
                named a parameter or supplementary column (a flux in nJy
                for magnitude units).
            device: where the transform runs.
        """
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

        norm = None
        if cfg.normalize_method is not None and self._norm_filter is None:
            if norm_values is None:
                raise ValueError(
                    f"normalize_method={cfg.normalize_method!r} named a "
                    "parameter/supplementary quantity at training time; pass "
                    "norm_values=(M,) with that quantity per object")
            x, norm = self._normalize_by_value(x, torch.as_tensor(
                norm_values, dtype=torch.float32, device=device))
        elif cfg.normalize_method is not None:
            x, xe, norm = self._normalize_by_filter(x, xe, f_njy)

        blocks = [x]
        if cfg.include_errors and xe is not None:
            blocks.append(xe)
        if missing_mask is not None:
            m = torch.as_tensor(missing_mask, dtype=torch.float32,
                                device=device)[:, self._keep_idx]
            j = self._norm_filter
            if j is not None:
                m = torch.cat([m[:, :j], m[:, j + 1:]], dim=1)
            blocks[0] = torch.where(m == 1.0, cfg.missing_value, blocks[0])
            if len(blocks) > 1:
                blocks[1] = torch.where(m == 1.0, cfg.missing_value,
                                        blocks[1])
            if cfg.include_flags:
                blocks.append(m)
        elif cfg.include_flags and (cfg.missing_fraction > 0
                                    or cfg.missing_flux_options):
            blocks.append(torch.zeros_like(x))
        values = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                  for k, v in (extra_values or {}).items()}
        # extra features from the photometry columns before missing bands
        # were set, as at training time
        blocks += [c[:, None] for c in self._extra_columns(x, values)]
        if norm is not None:
            blocks.append(norm[:, None])
        return torch.cat(blocks, dim=1).cpu().numpy()

    @classmethod
    def from_flags(cls, flags: dict, noise_models=None) -> "FeaturePipeline":
        """The pipeline of a flag record, as `build` or the JAX package
        wrote it."""
        flags = {k: v for k, v in flags.items()
                 if k not in ("feature_names", "n_input_rows")}
        return cls(FeatureConfig.from_flags(flags), noise_models)
