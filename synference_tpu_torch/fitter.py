"""`SBIFitter`: the top-level amortised-inference workflow.

Counterpart of `synference_tpu/fitter.py` for the NPE engine: it holds the
library, builds features, trains flow ensembles on its device, produces
posteriors, evaluates their calibration, and saves and loads the result.
`save_state` writes the JAX package's layout (plain Python and numpy only),
so a file written by either package loads in the other.

A fitter starts from a library: arrays, the dict `LibraryGenerator.generate`
returns (`from_library`), or an HDF5 file either package wrote
(`init_from_hdf5`). Feature configs may rewrite the fitted θ columns
(remove, add supplementary columns, transform); `parameter_names` then
holds the fitted names.

Not ported yet, each raising NotImplementedError with its ROADMAP item: the
"nle" and "nre" engines (M11/M13); not present: spectral features (M10),
the simformer, the online engines and the plotting and dataframe helpers
(M14).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .diagnostics import evaluate_members_fused, evaluate_posterior
from .features import FeatureConfig, FeaturePipeline
from .flows.base import (ConditionalFlow, build_flow, params_from_numpy,
                         params_to_numpy, tree_leaves, tree_map)
from .posterior import DirectPosterior, EnsemblePosterior
from .priors import BoxUniform, priors_from_library
from .train import TrainConfig, train_ensemble

__all__ = ["SBIFitter"]


class SBIFitter:
    """Train and apply amortised posteriors over an SED library.

        fitter = SBIFitter(photometry, parameters, names, codes, device="cuda")
        fitter.create_feature_array(FeatureConfig(...))
        result = fitter.run_single_sbi(model_type="nsf", n_nets=3)
        samples = fitter.sample_posterior(x_obs, n_samples=1000)
        report = fitter.evaluate_model()
    """

    def __init__(self, photometry: np.ndarray, parameters: np.ndarray,
                 parameter_names, filter_codes, supplementary=None,
                 supplementary_names=(), spectra=None, wavelengths=None,
                 name: str = "sbi_model", *, device):
        """photometry (N, F) in nJy, parameters (N, P), supplementary
        (N, S), spectra (N, L) on `wavelengths`; features, training and
        sampling run on `device`."""
        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # raises where the device is absent
        self.photometry = np.asarray(photometry, np.float32)
        self.parameters = np.asarray(parameters, np.float32)
        self.parameter_names = list(parameter_names)
        # the library's own θ names (parameter_names become the fitted ones)
        self._raw_parameter_names = list(parameter_names)
        self.filter_codes = list(filter_codes)
        self.supplementary = (None if supplementary is None
                              else np.asarray(supplementary))
        self.supplementary_names = list(supplementary_names)
        self.spectra = (None if spectra is None
                        else np.asarray(spectra, np.float32))
        self.wavelengths = (None if wavelengths is None
                            else np.asarray(wavelengths))
        self.name = name
        self.engine = "npe"
        self._clear_training_state()

    def _clear_training_state(self):
        self.feature_pipeline: FeaturePipeline | None = None
        self.features: np.ndarray | None = None
        self.feature_params: np.ndarray | None = None
        self.feature_source: np.ndarray | None = None
        self.feature_flags: dict | None = None
        self.prior: BoxUniform | None = None
        self.flow: ConditionalFlow | None = None
        self.train_result = None
        self.posterior = None
        self._split = None

    @classmethod
    def from_library(cls, lib: dict, name: str = "sbi_model", *,
                     device) -> "SBIFitter":
        """A fitter over a library dict in the reference schema, as
        `LibraryGenerator.generate` and `load_library_hdf5` return it."""
        return cls(
            photometry=lib["photometry"].T, parameters=lib["parameters"].T,
            parameter_names=lib["parameter_names"],
            filter_codes=lib["filter_codes"],
            supplementary=(lib["supplementary_parameters"].T
                           if "supplementary_parameters" in lib else None),
            supplementary_names=lib.get("supplementary_parameter_names", ()),
            spectra=lib["spectra"].T if "spectra" in lib else None,
            wavelengths=lib.get("wavelengths"), name=name, device=device)

    @classmethod
    def init_from_hdf5(cls, path: str, name: str | None = None, *,
                       device) -> "SBIFitter":
        """A fitter over a library file that this or the JAX package wrote
        (the reference schema)."""
        from .library import load_library_hdf5

        return cls.from_library(
            load_library_hdf5(path),
            name=name or os.path.basename(path).rsplit(".", 1)[0],
            device=device)

    def _generator(self, generator, seed: int) -> torch.Generator:
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def create_feature_array(self, config: FeatureConfig | None = None,
                             noise_models: dict | None = None,
                             generator: torch.Generator | None = None,
                             **config_kwargs):
        """Build the training features (noise from `generator`, seed 0 on
        the fitter's device when None)."""
        if config is None:
            config = FeatureConfig(filter_codes=tuple(self.filter_codes),
                                   **config_kwargs)
        self.feature_pipeline = FeaturePipeline(config, noise_models)
        res = self.feature_pipeline.build(
            self._generator(generator, 0), self.photometry, self.parameters,
            self._raw_parameter_names, supplementary=self.supplementary,
            supplementary_names=self.supplementary_names)
        self.features = res.features
        self.feature_params = res.parameters
        self.feature_flags = res.flags
        self.feature_source = res.source_index
        self.parameter_names = list(res.parameter_names)
        return res

    # ------------------------------------------------------------------
    def create_priors(self, overrides=None, extend_pct: float = 0.0):
        self.prior = priors_from_library(
            self.feature_params if self.feature_params is not None
            else self.parameters,
            self.parameter_names, overrides=overrides, extend_pct=extend_pct,
            device=self.device)
        return self.prior

    # ------------------------------------------------------------------
    def split_dataset(self, test_fraction: float = 0.1, seed: int = 0):
        """Held-out split grouped by source galaxy: with n_scatters > 1 the
        feature rows hold noise-realisation copies of each galaxy, and a
        row-level split would leak θ into the test set."""
        n = self.features.shape[0]
        rng = np.random.default_rng(seed)
        if self.feature_source is None:
            perm = rng.permutation(n)
            n_test = max(int(n * test_fraction), 1)
            self._split = {"test": perm[:n_test], "train": perm[n_test:]}
            return self._split
        uniq = np.unique(self.feature_source)
        perm_g = rng.permutation(len(uniq))
        n_test_g = max(int(len(uniq) * test_fraction), 1)
        is_test = np.isin(self.feature_source, uniq[perm_g[:n_test_g]])
        # np.where gives row-ordered indices, and library rows are sorted
        # by redshift: without the shuffle a `test[:max_objects]` cut would
        # evaluate on the lowest-z corner only
        self._split = {"test": rng.permutation(np.where(is_test)[0]),
                       "train": rng.permutation(np.where(~is_test)[0])}
        return self._split

    # ------------------------------------------------------------------
    def run_single_sbi(self, model_type: str = "nsf", engine: str = "npe",
                       n_nets: int = 1, hidden_features: int = 50,
                       num_transforms: int = 5,
                       train_config: TrainConfig | None = None,
                       test_fraction: float = 0.1,
                       generator: torch.Generator | None = None,
                       epoch_callback=None, support_aware: bool = True,
                       **model_kwargs):
        """Train the estimator q(θ|x) and build its posterior.

        support_aware: reparametrise the flow onto the prior box by a logit
        transform, so that every sample is in-support by construction.
        `generator` (seed 42 on the fitter's device when None) drives the
        split, the initial weights and the shuffles.
        """
        engine = engine.lower()
        if engine not in ("npe", "nle", "nre"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine != "npe":
            raise NotImplementedError(
                f"engine {engine!r} is not ported yet (ROADMAP M11 for its "
                "estimators, M13 for its MCMC-sampled posterior)")
        if self.features is None:
            self.create_feature_array()
        if self.prior is None:
            self.create_priors()
        if self._split is None:
            self.split_dataset(test_fraction)

        cfg = dict(model_kwargs, hidden_features=hidden_features,
                   num_transforms=num_transforms)
        if support_aware:
            cfg.setdefault("support_low", tuple(
                self.prior.low.cpu().numpy().astype(np.float64)))
            cfg.setdefault("support_high", tuple(
                self.prior.high.cpu().numpy().astype(np.float64)))
        self.flow = build_flow(model_type, theta_dim=len(self.parameter_names),
                               context_dim=self.features.shape[1],
                               device=self.device, **cfg)

        tr_idx = self._split["train"]
        source = self.feature_source
        self.train_result = train_ensemble(
            self.flow, self.feature_params[tr_idx], self.features[tr_idx],
            generator=self._generator(generator, 42),
            config=train_config or TrainConfig(), n_nets=n_nets,
            groups=None if source is None else source[tr_idx],
            epoch_callback=epoch_callback)
        self.engine = engine
        self._set_posterior(self.train_result.params)
        return self.train_result

    def _set_posterior(self, stacked_params):
        if tree_leaves(stacked_params)[0].shape[0] == 1:
            self.posterior = DirectPosterior(
                self.flow, tree_map(lambda a: a[0], stacked_params),
                self.prior)
        else:
            self.posterior = EnsemblePosterior(self.flow, stacked_params,
                                               self.prior)

    # ------------------------------------------------------------------
    def sample_posterior(self, xs, n_samples: int = 1000,
                         generator: torch.Generator | None = None):
        """(M, D_features) -> (M, n_samples, P) numpy array, all objects in
        one pass (seed 1 on the fitter's device when no generator)."""
        with torch.no_grad():
            return self.posterior.sample_batch(
                xs, n_samples, self._generator(generator, 1)).cpu().numpy()

    # ------------------------------------------------------------------
    def evaluate_model(self, n_samples: int = 256,
                       generator: torch.Generator | None = None,
                       max_objects: int = 512) -> dict:
        """Held-out metrics and coverage of the posterior."""
        idx = self._split["test"][:max_objects]
        return evaluate_posterior(
            self.posterior, self.features[idx], self.feature_params[idx],
            generator=generator, n_samples=n_samples,
            parameter_names=self.parameter_names)

    def evaluate_members(self, n_samples: int = 256,
                         generator: torch.Generator | None = None,
                         max_objects: int = 512) -> dict:
        """Per-member calibration with seed-to-seed error bars (see
        `diagnostics.evaluate_members_fused`); needs n_nets > 1."""
        if self.train_result is None or self.train_result.n_members < 2:
            raise ValueError("evaluate_members needs an n_nets>1 ensemble")
        idx = self._split["test"][:max_objects]
        return evaluate_members_fused(
            self.flow, self.train_result.params, self.prior,
            self.features[idx], self.feature_params[idx],
            generator=generator, n_samples=n_samples,
            parameter_names=self.parameter_names)

    # ------------------------------------------------------------------
    def save_state(self, path: str):
        """Persist flow spec, parameters, prior and feature flags in the JAX
        package's layout: a pickle of plain Python and numpy."""
        if self.train_result is None:
            raise RuntimeError("nothing to save: train a model first")
        state = {
            "name": self.name,
            "engine": self.engine,
            "prior": self.prior.to_dict(),
            "parameter_names": self.parameter_names,
            "filter_codes": self.filter_codes,
            "feature_flags": self.feature_flags,
            "flow_spec": self.flow.spec(),
            "params": params_to_numpy(self.train_result.params),
            "n_members": self.train_result.n_members,
            "train_history": {
                "train_losses": np.asarray(self.train_result.train_losses),
                "val_losses": np.asarray(self.train_result.val_losses),
            },
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    @classmethod
    def load_saved_model(cls, path: str, *, device) -> "SBIFitter":
        """Rebuild a fitter from a file that `save_state` of this or of the
        JAX package wrote (posterior only; the library is not needed). Load
        only files you trust: unpickling can run code."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        fitter = cls.__new__(cls)
        fitter.device = torch.device(device)
        fitter.name = state["name"]
        fitter.parameter_names = list(state["parameter_names"])
        fitter.filter_codes = list(state["filter_codes"])
        fitter.engine = state.get("engine", "npe")
        fitter.photometry = None
        fitter.parameters = None
        fitter.supplementary = fitter.spectra = fitter.wavelengths = None
        fitter.supplementary_names = []
        fitter._raw_parameter_names = list(fitter.parameter_names)
        fitter._clear_training_state()
        if fitter.engine != "npe":
            raise NotImplementedError(
                f"saved engine {fitter.engine!r} is not ported yet (ROADMAP "
                "M13 for nle/nre posteriors, M14 for the simformer)")
        fitter.flow = ConditionalFlow.from_spec(state["flow_spec"],
                                                fitter.device)
        fitter.prior = BoxUniform.from_dict(state["prior"], fitter.device)
        params = params_from_numpy(state["params"], fitter.device)
        k = int(tree_leaves(params)[0].shape[0])
        if state.get("n_members", k) != k:
            raise ValueError(
                f"saved state names {state['n_members']} members, its "
                f"parameters carry {k}")
        fitter._set_posterior(params)
        flags = state.get("feature_flags")
        fitter.feature_flags = flags
        fitter.feature_pipeline = (FeaturePipeline.from_flags(flags)
                                   if flags else None)
        return fitter

    # ------------------------------------------------------------------
    def features_from_observations(self, flux, flux_err=None,
                                   flux_unit="nJy", missing_mask=None,
                                   extra_values=None, norm_values=None):
        """Replay the training feature transform on a catalogue."""
        if self.feature_pipeline is None:
            raise RuntimeError("no feature pipeline; build or load one first")
        return self.feature_pipeline.transform_observations(
            flux, flux_err, flux_unit, missing_mask, extra_values,
            norm_values, device=self.device)
