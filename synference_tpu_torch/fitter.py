"""`SBIFitter`: the top-level amortised-inference workflow.

Counterpart of `synference_tpu/fitter.py`: it holds the library, builds
features, trains estimators on its device for the three engines ("npe": a
flow q(θ|x) sampled directly; "nle": a flow likelihood q(x|θ) and "nre": a
classifier log-ratio, both sampled by batched MCMC), runs the online
engines (`run_online_sbi`: SNPE, SNLE, SNRE), produces posteriors,
evaluates their calibration, and saves and loads the result.
`save_state` writes the JAX package's layout (plain Python and numpy only),
so a file written by either package loads in the other.

A fitter starts from a library: arrays, the dict `LibraryGenerator.generate`
returns (`from_library`), or an HDF5 file either package wrote
(`init_from_hdf5`). Feature configs may rewrite the fitted θ columns
(remove, add supplementary columns, transform); `parameter_names` then
holds the fitted names.

Spectral features come from library spectra on an instrument grid
(`create_feature_array_from_raw_spectra`): crop, noise from a
`SpectralNoiseModel`, and flux normalisation with the log10 norm appended.

Validation beside the calibration report: `detect_misspecification` (a
marginal flow over the training features), `lc2st` on held-out calibration
pairs, `calculate_map`, the loss histories (`training_log_probs`,
`validation_log_probs`) and `save_metrics`.

Figures and views: `plot_diagnostics` and `run_validation_from_file` draw
`plotting.py`'s figures (matplotlib), `create_dataframe` gives a pandas
view of the library; both packages are imported where they are used.

`run_single_simformer` trains a score-based transformer over the joint
(θ, x) tokens on every feature row (`simformer.py`, engine "simformer");
its saved model is the posterior's `state_dict` in the JAX layout.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from . import online
from .diagnostics import evaluate_members_fused, evaluate_posterior
from .features import FeatureConfig, FeaturePipeline
from .flows.base import (ConditionalFlow, build_flow, params_from_numpy,
                         params_to_numpy, tree_leaves, tree_map)
from .posterior import (DirectPosterior, EnsemblePosterior,
                        LikelihoodPosterior, RatioPosterior)
from .priors import BoxUniform, priors_from_library
from .ratio import RatioEstimator, build_ratio_estimator, nre_loss
from .train import TrainConfig, train_ensemble

__all__ = ["SBIFitter"]


class SBIFitter:
    """Train and apply amortised posteriors over an SED library.

        fitter = SBIFitter(photometry, parameters, names, codes, device="cuda")
        fitter.create_feature_array(FeatureConfig(...))
        result = fitter.run_single_sbi(model_type="nsf", n_nets=3)
        # or engine="nle" / "nre", sampled by batched MCMC, or
        # fitter.run_single_simformer(), a score-based joint posterior
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
    def create_feature_array_from_raw_spectra(
            self, noise_model=None, n_scatters: int = 1,
            crop: tuple | None = None, crop_lam: tuple | None = None,
            normalize_pixel: int | None = None, normalize=None,
            generator: torch.Generator | None = None, draws=None):
        """Spectral features from the library spectra, which must already be
        on one instrument grid (`LibraryGenerator(spectral_pipeline=...)`).

        Steps: crop by pixel (`crop`) or wavelength (`crop_lam`, Å); tile
        `n_scatters` copies and scatter them through `noise_model` (a
        `SpectralNoiseModel`; its normals from `generator`, seed 0 on the
        fitter's device when None, or passed as `draws`); normalise by
        `normalize`: an int pixel (as `normalize_pixel`), ("tophat",
        centre_Å, width_Å) or ("bandpass", lo_Å, hi_Å) mean flux, or a
        callable (spectra (B, L), λ (L,)) -> (B,) norms. The norm's
        log10 |·| is appended as a feature. Wavelength options need the
        library's `wavelengths`. Rows with a non-finite feature are
        dropped."""
        if self.spectra is None:
            raise RuntimeError("library has no spectra")
        dev = self.device
        spec = torch.as_tensor(self.spectra, dtype=torch.float32, device=dev)
        lam = (None if self.wavelengths is None
               else np.asarray(self.wavelengths, np.float64))
        if crop_lam is not None:
            if lam is None:
                raise ValueError("crop_lam needs library wavelengths")
            i0, i1 = np.searchsorted(lam, crop_lam)
            crop = (int(i0), int(i1))
        if crop is not None:
            spec = spec[:, crop[0]:crop[1]]
            if lam is not None:
                lam = lam[crop[0]:crop[1]]
        params = torch.as_tensor(self.parameters, dtype=torch.float32,
                                 device=dev)
        reps = max(n_scatters, 1) if (n_scatters > 1
                                      or noise_model is not None) else 1
        spec, params = spec.repeat(reps, 1), params.repeat(reps, 1)
        if noise_model is not None:
            spec, _ = noise_model.apply(self._generator(generator, 0), spec,
                                        draws=draws)
        if normalize is None and normalize_pixel is not None:
            normalize = int(normalize_pixel)
        norm_flag = normalize
        if normalize is not None:
            if callable(normalize):
                norm = torch.as_tensor(normalize(spec, lam),
                                       dtype=torch.float32, device=dev)
                norm_flag = getattr(normalize, "__name__", "callable")
            elif isinstance(normalize, int):
                norm = spec[:, normalize]
            else:
                kind = normalize[0]
                if lam is None:
                    raise ValueError(
                        f"normalize={kind!r} needs library wavelengths")
                if kind == "tophat":
                    lo = normalize[1] - 0.5 * normalize[2]
                    hi = normalize[1] + 0.5 * normalize[2]
                elif kind == "bandpass":
                    lo, hi = normalize[1], normalize[2]
                else:
                    raise ValueError(f"unknown normalize kind {kind!r}")
                m = (lam >= lo) & (lam <= hi)
                if not m.any():
                    raise ValueError(
                        f"normalize window [{lo}, {hi}] Å misses the grid")
                m = torch.as_tensor(m, dtype=spec.dtype, device=dev)
                norm = (spec * m).sum(-1) / m.sum()
            norm = torch.where(norm == 0, 1.0, norm)
            spec = torch.cat([spec / norm[:, None],
                              torch.log10(torch.abs(norm))[:, None]], dim=1)
        feats = spec.cpu().numpy()
        good = np.isfinite(feats).all(axis=1)
        source = np.tile(np.arange(self.spectra.shape[0]), reps)
        self.features = feats[good]
        self.feature_params = params.cpu().numpy()[good]
        self.feature_source = source[good]
        self.feature_flags = {"spectral": True, "crop": crop,
                              "normalize": norm_flag,
                              "n_scatters": n_scatters}
        return self.features

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
        """Train the estimator and build its posterior.

        Engines: "npe" trains q(θ|x) and samples it directly; "nle" trains
        the flow likelihood q(x|θ) (the flow's "θ" slot holds the features,
        its context θ) and "nre" a classifier log-ratio (`model_type` is
        ignored; `hidden_features` becomes at least 64, `num_layers` and
        `net` go in `model_kwargs`); both sample by batched MCMC.
        `hidden_features` and `num_transforms` reach the flows that take
        them, as in the JAX package.

        support_aware (npe only): reparametrise the flow onto the prior box
        by a logit transform, so that every sample is in-support by
        construction. `generator` (seed 42 on the fitter's device when None)
        drives the split, the initial weights and the shuffles.
        """
        engine = engine.lower()
        if engine not in ("npe", "nle", "nre"):
            raise ValueError(f"unknown engine {engine!r}")
        if self.features is None:
            self.create_feature_array()
        if self.prior is None:
            self.create_priors()
        if self._split is None:
            self.split_dataset(test_fraction)

        theta_dim, x_dim = len(self.parameter_names), self.features.shape[1]
        cfg = dict(model_kwargs)
        loss_fn = None
        if engine == "nre":
            cfg.setdefault("hidden_features", max(hidden_features, 64))
            self.flow = build_ratio_estimator(theta_dim, x_dim,
                                              device=self.device, **cfg)
            loss_fn = nre_loss(self.flow)
        else:
            if model_type in ("maf", "nsf", "ncsf", "realnvp", "nice", "naf",
                              "unaf", "sospf", "gf"):
                cfg.update(hidden_features=hidden_features,
                           num_transforms=num_transforms)
            elif model_type in ("mdn", "cnf", "made"):
                cfg.setdefault("hidden_features", hidden_features)
            if engine == "nle":
                self.flow = build_flow(model_type, theta_dim=x_dim,
                                       context_dim=theta_dim,
                                       device=self.device, **cfg)
            else:
                if support_aware:
                    cfg.setdefault("support_low", tuple(
                        self.prior.low.cpu().numpy().astype(np.float64)))
                    cfg.setdefault("support_high", tuple(
                        self.prior.high.cpu().numpy().astype(np.float64)))
                self.flow = build_flow(model_type, theta_dim=theta_dim,
                                       context_dim=x_dim, device=self.device,
                                       **cfg)

        tr_idx = self._split["train"]
        source = self.feature_source
        theta_tr, x_tr = self.feature_params[tr_idx], self.features[tr_idx]
        if engine == "nle":  # the trainer's "θ" slot holds the modelled x
            theta_tr, x_tr = x_tr, theta_tr
        self.train_result = train_ensemble(
            self.flow, theta_tr, x_tr,
            generator=self._generator(generator, 42),
            config=train_config or TrainConfig(), n_nets=n_nets,
            groups=None if source is None else source[tr_idx],
            loss_fn=loss_fn, epoch_callback=epoch_callback)
        self.engine = engine
        self._set_posterior(self.train_result.params)
        return self.train_result

    def _set_posterior(self, stacked_params):
        """The engine's posterior over stacked parameters; one member's
        parameters lose the member axis."""
        params = stacked_params
        if tree_leaves(stacked_params)[0].shape[0] == 1:
            params = tree_map(lambda a: a[0], stacked_params)
        if self.engine == "nle":
            self.posterior = LikelihoodPosterior(self.flow, params,
                                                 self.prior)
        elif self.engine == "nre":
            self.posterior = RatioPosterior(self.flow, params, self.prior)
        elif params is not stacked_params:
            self.posterior = DirectPosterior(self.flow, params, self.prior)
        else:
            self.posterior = EnsemblePosterior(self.flow, stacked_params,
                                               self.prior)

    # ------------------------------------------------------------------
    def run_single_simformer(self, d_model: int = 128, n_heads: int = 4,
                             n_layers: int = 4, attn_mask: str = "full",
                             batch_size: int = 256,
                             learning_rate: float = 1.0e-4,
                             max_epochs: int = 100,
                             n_diffusion_steps: int = 500,
                             generator: torch.Generator | None = None):
        """Train a score-based transformer joint posterior on the whole
        feature array (`attn_mask` "full" or "causal"); the draws come from
        `generator` (seed 0 on the fitter's device when None). Returns the
        training history."""
        from .simformer import (Simformer, SimformerConfig,
                                SimformerPosterior, block_attn_mask,
                                train_simformer)

        if self.features is None:
            self.create_feature_array()
        if self.prior is None:
            self.create_priors()
        theta, x = self.feature_params, self.features
        n_theta, n_x = theta.shape[1], x.shape[1]
        model = Simformer(SimformerConfig(
            n_tokens=n_theta + n_x, d_model=d_model, n_heads=n_heads,
            n_layers=n_layers), device=self.device)
        mask = (None if attn_mask == "full"
                else block_attn_mask(n_theta, n_x, attn_mask))
        params, std, hist = train_simformer(
            model, theta, x, self._generator(generator, 0),
            batch_size=batch_size, learning_rate=learning_rate,
            max_epochs=max_epochs, attn_mask=mask)
        self.posterior = SimformerPosterior(model, params, std,
                                            attn_mask=mask,
                                            n_steps=n_diffusion_steps)
        self.engine = "simformer"
        self.flow = None
        self.train_result = None
        return hist

    # ------------------------------------------------------------------
    def run_online_sbi(self, simulate_fn, x_obs, engine: str = "snpe",
                       model_type: str = "nsf", n_rounds: int = 3,
                       sims_per_round: int = 2000, train_config=None,
                       generator: torch.Generator | None = None,
                       verbose: bool = True, **model_kwargs):
        """Sequential SBI focused on one observation: "snpe" (truncated
        proposals, a flow q(θ|x)), "snle" (a flow q(x|θ), MCMC) or "snre"
        (a classifier log-ratio, MCMC; `model_type` picks its net among
        "mlp", "resnet", "linear", else "mlp"). `simulate_fn` maps θ
        (B, P) on the fitter's device to features (B, D) matching `x_obs`.
        The draws and the training come from `generator` (seed 0 on the
        fitter's device when None). Returns (posterior, {"theta": [...],
        "x": [...]} per round as numpy, per-round history)."""
        engine = engine.lower()
        if engine not in ("snpe", "npe", "snle", "nle", "snre", "nre"):
            raise ValueError(f"unknown online engine {engine!r}")
        if self.prior is None:
            self.create_priors()
        theta_dim = len(self.parameter_names)
        x_dim = np.atleast_1d(np.asarray(x_obs)).shape[-1]
        generator = self._generator(generator, 0)
        kw = dict(n_rounds=n_rounds, sims_per_round=sims_per_round,
                  train_config=train_config, generator=generator,
                  verbose=verbose)
        if engine in ("snpe", "npe"):
            self.flow = build_flow(model_type, theta_dim=theta_dim,
                                   context_dim=x_dim, device=self.device,
                                   **model_kwargs)
            run, self.engine = online.run_online_snpe, "npe"
        elif engine in ("snle", "nle"):
            self.flow = build_flow(model_type, theta_dim=x_dim,
                                   context_dim=theta_dim, device=self.device,
                                   **model_kwargs)
            run, self.engine = online.run_online_snle, "nle"
        else:
            net = model_type if model_type in ("mlp", "resnet", "linear") \
                else "mlp"
            self.flow = build_ratio_estimator(theta_dim, x_dim, net=net,
                                              device=self.device,
                                              **model_kwargs)
            run, self.engine = online.run_online_snre, "nre"
        self.train_result = None
        posterior, data, hist = run(simulate_fn, self.prior, self.flow,
                                    x_obs, **kw)
        self.posterior = posterior
        return posterior, data, hist

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
        if self.engine != "npe":
            raise ValueError("evaluate_members needs an npe ensemble (its "
                             "members are flow posteriors q(θ|x))")
        idx = self._split["test"][:max_objects]
        return evaluate_members_fused(
            self.flow, self.train_result.params, self.prior,
            self.features[idx], self.feature_params[idx],
            generator=generator, n_samples=n_samples,
            parameter_names=self.parameter_names)

    # ------------------------------------------------------------------
    def detect_misspecification(self, x_obs, quantile: float = 0.01,
                                generator: torch.Generator | None = None,
                                max_train: int = 20000, **flow_kwargs):
        """Flag observations whose feature-marginal density lies below the
        training features' `quantile`: a "maf" marginal flow
        (`diagnostics.fit_marginal_flow`, `flow_kwargs` such as
        `max_epochs` passed on) over the first `max_train` feature rows.
        Returns (flags, logp_obs, threshold) on the host."""
        from .diagnostics import fit_marginal_flow, misspecification_check

        if self.features is None:
            self.create_feature_array()
        x_train = self.features[:max_train]
        flow, params = fit_marginal_flow(x_train, generator,
                                         device=self.device, **flow_kwargs)
        return misspecification_check(flow, params, x_train,
                                      np.atleast_2d(np.asarray(x_obs)),
                                      quantile=quantile)

    def lc2st(self, x_obs, n_cal: int = 1000,
              generator: torch.Generator | None = None, **kwargs) -> dict:
        """Local C2ST at one observation on the first `n_cal` held-out
        calibration pairs (see `diagnostics.lc2st`)."""
        from .diagnostics import lc2st as _lc2st

        if self._split is None or self.feature_params is None:
            raise ValueError(
                "lc2st needs library calibration pairs: run "
                "create_feature_array + split_dataset first (fitters "
                "restored via load_saved_model carry no library)")
        idx = self._split["test"][:n_cal]
        return _lc2st(self.posterior, self.feature_params[idx],
                      self.features[idx], x_obs, generator, **kwargs)

    @property
    def training_log_probs(self) -> np.ndarray:
        """−training loss per epoch, (epochs, members)."""
        return -np.asarray(self.train_result.train_losses)

    @property
    def validation_log_probs(self) -> np.ndarray:
        """−validation loss per epoch, (epochs, members)."""
        return -np.asarray(self.train_result.val_losses)

    def calculate_map(self, x, generator: torch.Generator | None = None,
                      n_starts: int = 512):
        """MAP estimate: the highest-density one of `n_starts` posterior
        draws. x (D,) gives (P,), x (M, D) gives (M, P), all objects in
        one batched draw and one `log_prob` call (seed 1 on the fitter's
        device when no generator)."""
        generator = self._generator(generator, 1)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            if x.ndim == 1 and hasattr(self.posterior, "map_estimate"):
                return self.posterior.map_estimate(x, generator, n_starts)
            xs = torch.atleast_2d(x)
            s = self.posterior.sample_batch(xs, n_starts, generator)
            m, n, p = s.shape
            lp = self.posterior.log_prob(
                s.reshape(m * n, p),
                xs.repeat_interleave(n, dim=0)).reshape(m, n)
            best = s[torch.arange(m, device=self.device), lp.argmax(dim=1)]
        return best[0] if x.ndim == 1 else best

    def save_metrics(self, report: dict, path: str):
        """Write a metrics dict as JSON (arrays and tensors as lists)."""
        def safe(v):
            if isinstance(v, dict):
                return {k: safe(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [safe(x) for x in v]
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, (np.floating, np.integer, np.bool_)):
                return v.item()
            return v

        with open(path, "w") as f:
            json.dump(safe(report), f, indent=2)

    def create_dataframe(self, data: str = "all"):
        """A pandas view of the library. `data`: "parameters",
        "photometry", "supplementary", "features" or "all" (the first
        three side by side)."""
        import pandas as pd

        frames = []
        if data in ("parameters", "all"):
            frames.append(pd.DataFrame(self.parameters,
                                       columns=self._raw_parameter_names))
        if data in ("photometry", "all") and self.photometry is not None:
            frames.append(pd.DataFrame(self.photometry,
                                       columns=self.filter_codes))
        if data in ("supplementary", "all") and self.supplementary is not None:
            frames.append(pd.DataFrame(self.supplementary,
                                       columns=self.supplementary_names))
        if data == "features":
            if self.features is None:
                self.create_feature_array()
            frames.append(pd.DataFrame(np.asarray(self.features)))
        if not frames:
            raise ValueError(f"no data for {data!r}")
        return pd.concat(frames, axis=1)

    def run_validation_from_file(self, validation_file: str,
                                 plots_dir: str = ".",
                                 n_samples: int = 256,
                                 max_objects: int = 512,
                                 generator: torch.Generator | None = None):
        """Validate a saved model on this fitter's held-out split: load it
        onto this fitter's device, compute the evaluation report, draw
        `n_samples` per object for the coverage and prediction figures
        (from `generator`, seed 1 on the fitter's device when None) and
        write both figures and a metrics JSON to `plots_dir`. Returns
        (report, paths)."""
        from .plotting import plot_coverage, plot_posterior_predictions

        loaded = type(self).load_saved_model(validation_file,
                                             device=self.device)
        if self._split is None:
            self.split_dataset()
        generator = self._generator(generator, 1)
        idx = self._split["test"][:max_objects]
        xs, truths = self.features[idx], self.feature_params[idx]
        report = evaluate_posterior(
            loaded.posterior, xs, truths, generator=generator,
            n_samples=n_samples, parameter_names=self.parameter_names)
        os.makedirs(plots_dir, exist_ok=True)
        samples = loaded.sample_posterior(xs, n_samples, generator)
        stem = f"{loaded.name}_validation"
        paths = {
            "coverage": os.path.join(plots_dir, f"{stem}_coverage.png"),
            "predictions": os.path.join(plots_dir,
                                        f"{stem}_predictions.png"),
            "metrics": os.path.join(plots_dir, f"{stem}_metrics.json"),
        }
        plot_coverage(samples, truths, self.parameter_names,
                      save=paths["coverage"])
        plot_posterior_predictions(samples, truths, self.parameter_names,
                                   save=paths["predictions"])
        self.save_metrics(report, paths["metrics"])
        return report, paths

    def plot_diagnostics(self, out_dir: str = ".", n_samples: int = 200,
                         max_objects: int = 200,
                         generator: torch.Generator | None = None) -> dict:
        """Coverage, loss and prediction figures for the held-out split,
        saved under `out_dir`. Returns the saved paths."""
        from .plotting import (plot_coverage, plot_loss,
                               plot_posterior_predictions)

        if self._split is None:
            self.split_dataset()
        idx = self._split["test"][:max_objects]
        samples = self.sample_posterior(self.features[idx], n_samples,
                                        generator)
        truths = self.feature_params[idx]
        paths = {"coverage": os.path.join(out_dir,
                                          f"{self.name}_coverage.png")}
        plot_coverage(samples, truths, self.parameter_names,
                      save=paths["coverage"])
        if self.train_result is not None:
            paths["loss"] = os.path.join(out_dir, f"{self.name}_loss.png")
            plot_loss(self.train_result.train_losses,
                      self.train_result.val_losses, save=paths["loss"])
        paths["predictions"] = os.path.join(out_dir,
                                            f"{self.name}_predictions.png")
        plot_posterior_predictions(samples, truths, self.parameter_names,
                                   save=paths["predictions"])
        return paths

    # ------------------------------------------------------------------
    def save_state(self, path: str):
        """Persist flow spec, parameters, prior and feature flags in the JAX
        package's layout: a pickle of plain Python and numpy. After an
        online run (no training result) the posterior's parameters are
        saved, with a member axis."""
        if self.posterior is None:
            raise RuntimeError("nothing to save: train a model first")
        state = {
            "name": self.name,
            "engine": self.engine,
            "prior": self.prior.to_dict(),
            "parameter_names": self.parameter_names,
            "filter_codes": self.filter_codes,
            "feature_flags": self.feature_flags,
        }
        if self.engine == "simformer":
            state["simformer"] = self.posterior.state_dict()
        elif self.train_result is not None:
            state["flow_spec"] = self.flow.spec()
            state.update({
                "params": params_to_numpy(self.train_result.params),
                "n_members": self.train_result.n_members,
                "train_history": {
                    "train_losses": np.asarray(
                        self.train_result.train_losses),
                    "val_losses": np.asarray(self.train_result.val_losses),
                },
            })
        else:
            state["flow_spec"] = self.flow.spec()
            params = self.posterior.params
            if params["theta_mean"].ndim == 1:
                params = tree_map(lambda a: a.unsqueeze(0), params)
            state.update({"params": params_to_numpy(params),
                          "n_members": int(params["theta_mean"].shape[0])})
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
        fitter.prior = BoxUniform.from_dict(state["prior"], fitter.device)
        if fitter.engine == "simformer":
            from .simformer import SimformerPosterior

            fitter.posterior = SimformerPosterior.from_state_dict(
                state["simformer"], device=fitter.device)
        elif fitter.engine in ("npe", "nle", "nre"):
            spec = state["flow_spec"]
            fitter.flow = (RatioEstimator.from_spec(spec, fitter.device)
                           if spec.get("model") == "nre"
                           else ConditionalFlow.from_spec(spec,
                                                          fitter.device))
            params = params_from_numpy(state["params"], fitter.device)
            k = int(tree_leaves(params)[0].shape[0])
            if state.get("n_members", k) != k:
                raise ValueError(
                    f"saved state names {state['n_members']} members, its "
                    f"parameters carry {k}")
            fitter._set_posterior(params)
        else:
            raise ValueError(f"unknown saved engine {fitter.engine!r}")
        flags = state.get("feature_flags")
        fitter.feature_flags = flags
        # spectral features (`create_feature_array_from_raw_spectra`) have
        # no photometric pipeline to replay
        fitter.feature_pipeline = (FeaturePipeline.from_flags(flags)
                                   if flags and not flags.get("spectral")
                                   else None)
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
