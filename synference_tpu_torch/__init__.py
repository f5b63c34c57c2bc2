"""synference_tpu_torch — the PyTorch/CUDA port of synference_tpu.

The mock-library forward path (θ draws → SFZH → windowed photometry →
features; HDF5 libraries with supplementary quantities that the JAX package
reads, chunk resume), the inference paths on top of it (`SBIFitter`: the
whole flow zoo, NPE with direct sampling, NLE and NRE with batched-MCMC
posteriors, the online engines SNPE/SNLE/SNRE, calibration metrics, saved
models that the JAX package reads), catalogue fitting (`fit_catalogue`: OOD
vote, missing-band imputation, reconstructed photometry) and the dense simulator path
(`BatchSEDSimulator.photometry` / `simulate` on θ in any order, spectra
included, and `recover_sed`) with every SFH and metallicity family,
particle SFZHs, emission-line quantities and the conv engine, the
spectroscopic front end (`spectra.SpectralFeaturePipeline`, raw-spectra
features, the flows' embedding net) and the noise-model zoo, and
exact-likelihood fitting and validation through the simulator's gradient
(HMC, MAP + Laplace, VI, SMC evidences, Fisher forecasts, score
compression, C2ST/L-C2ST, the NPE-vs-HMC cross-check, `RestrictedPrior`),
the AGN forward models (`AGNSimulator`, `AGNGridSimulator`), composite
stellar-plus-AGN models, library combination, config-driven training,
runtime utilities, plotting and test-data generation, the simformer (a
score-based transformer joint posterior), hyperparameter search
(`hpo.py`) and multi-process generation, training and sampling on
`torch.distributed` (`parallel/`), on torch tensors, with hand-written CUDA kernels for Hopper in `csrc/`: K1 the
windowed megakernel, K2 the full-table megakernel, K3 the exact-shift
numerators. Every public entry point takes an explicit device; CPU tensors
run the kernels' plain PyTorch versions. This package imports neither `jax`
nor `synference_tpu`.
"""

from .agn import AGNGridSimulator, AGNSimulator, agn_fraction
from .catalogue import (MissingPhotometryHandler,
                        compare_methods_feature_importance, fit_catalogue,
                        fit_catalogue_table, mahalanobis_ood,
                        ood_feature_contributions, ood_vote)
from .combine import combine_libraries, combine_libraries_matched
from .composite import CompositeSEDSimulator, grid_combinations
from .config import load_config, run_from_config
from .cosmology import PLANCK18, Cosmology
from .dust import ATTENUATION_LAWS, attenuation_curve, greybody_emission
from .features import FeatureConfig, FeaturePipeline, FeatureResult
from .fitter import SBIFitter
from .filter_arithmetic import FilterArithmeticParser
from .filters import Filter, FilterSet, tophat_filter
from .flows.base import ConditionalFlow, build_flow
from .hpo import (MedianPruner, SearchSpace, Study, optimize_sbi,
                  sweep_learning_rates)
from .grids import (SPSGrid, make_synthetic_agn_grid, make_synthetic_grid,
                    make_synthetic_multiaxis_grid)
from .igm import igm_transmission
from .instruments import (load_filters_hdf5, load_filters_svo_ascii,
                          load_instrument_filters, realistic_filter)
from .library import (LibraryCreator, LibraryGenerator, auto_batch_size,
                      draw_from_hypercube, draw_from_hypercube_device,
                      load_library_hdf5, save_library_hdf5,
                      simulator_from_library)
from .noise_models import (AsinhEmpiricalNoiseModel, DepthNoiseModel,
                           EmpiricalNoiseModel, GeneralEmpiricalNoiseModel,
                           NoiseModel, SpectralNoiseModel,
                           create_noise_models_from_catalogue,
                           load_noise_model_hdf5, save_noise_model_hdf5)
from .diagnostics import (c2st, evaluate_members_fused, evaluate_posterior,
                          expected_coverage, feature_importance,
                          fisher_forecast, fit_marginal_flow, lc2st,
                          misspecification_check, pit_ks_statistic,
                          pit_values, point_metrics, posterior_crosscheck,
                          sbc_ranks, score_compression,
                          shapley_feature_importance, tarp_coverage,
                          tarp_deviation)
from .mcmc import (censored_gaussian_loglike_rows, dirichlet_cumsum_transform,
                   fit_catalogue_hmc, fit_catalogue_map, fit_catalogue_vi,
                   fit_observation_hmc, fit_observation_mcmc,
                   gaussian_loglike, model_comparison, run_batched_mcmc,
                   run_ensemble_mcmc, run_smc, split_rhat_ess)
from .online import run_online_snle, run_online_snpe, run_online_snre
from .posterior import (DirectPosterior, EnsemblePosterior,
                        LikelihoodPosterior, RatioPosterior)
from .priors import (BoxUniform, RestrictedPrior, priors_from_library,
                     restricted_prior_from_simulations)
from .ratio import RatioEstimator, build_ratio_estimator, nre_loss
from .recovery import recover_sed
from .sed import BatchSEDSimulator, EmissionConfig
from .simformer import (VPSDE, Simformer, SimformerConfig, SimformerPosterior,
                        train_simformer)
from .sfh import SFH_FAMILIES, ZDIST_FAMILIES, sfh_weights, zdist_weights
from .spectra import (SpectralFeaturePipeline, generate_constant_r_grid,
                      match_resolution_constant_r)
from .supplementary import SUPP_FUNCTIONS, compute_supplementary
from .train import TrainConfig, TrainResult, train_ensemble, train_npe
from .units import FluxUnit, convert_flux, convert_flux_err

__all__ = [
    "PLANCK18", "Cosmology", "FeatureConfig", "FeaturePipeline",
    "FeatureResult", "Filter", "FilterSet", "tophat_filter", "SPSGrid",
    "make_synthetic_grid", "make_synthetic_multiaxis_grid",
    "load_instrument_filters", "realistic_filter", "LibraryGenerator",
    "auto_batch_size", "draw_from_hypercube", "DepthNoiseModel", "NoiseModel",
    "BatchSEDSimulator", "EmissionConfig", "recover_sed", "SBIFitter",
    "TrainConfig", "TrainResult", "train_ensemble", "train_npe", "BoxUniform",
    "priors_from_library", "ConditionalFlow", "build_flow", "DirectPosterior",
    "EnsemblePosterior", "LibraryCreator", "draw_from_hypercube_device",
    "load_library_hdf5", "save_library_hdf5", "simulator_from_library",
    "SUPP_FUNCTIONS", "compute_supplementary", "MissingPhotometryHandler",
    "fit_catalogue", "fit_catalogue_table", "ood_vote", "load_filters_hdf5",
    "load_filters_svo_ascii", "AsinhEmpiricalNoiseModel",
    "EmpiricalNoiseModel", "GeneralEmpiricalNoiseModel",
    "SpectralNoiseModel", "create_noise_models_from_catalogue",
    "load_noise_model_hdf5", "save_noise_model_hdf5",
    "SpectralFeaturePipeline", "generate_constant_r_grid",
    "LikelihoodPosterior", "RatioPosterior", "RatioEstimator",
    "build_ratio_estimator", "nre_loss", "run_batched_mcmc",
    "split_rhat_ess", "run_online_snpe", "run_online_snle",
    "run_online_snre", "run_ensemble_mcmc", "run_smc", "model_comparison",
    "gaussian_loglike", "censored_gaussian_loglike_rows",
    "dirichlet_cumsum_transform", "fit_observation_mcmc",
    "fit_observation_hmc", "fit_catalogue_hmc", "fit_catalogue_map",
    "fit_catalogue_vi", "RestrictedPrior",
    "restricted_prior_from_simulations", "pit_values", "sbc_ranks",
    "tarp_coverage", "tarp_deviation", "expected_coverage",
    "pit_ks_statistic", "point_metrics", "evaluate_posterior",
    "evaluate_members_fused", "c2st", "lc2st", "fisher_forecast",
    "score_compression", "posterior_crosscheck", "fit_marginal_flow",
    "misspecification_check", "feature_importance",
    "shapley_feature_importance", "ATTENUATION_LAWS", "attenuation_curve",
    "greybody_emission", "igm_transmission", "make_synthetic_agn_grid",
    "SFH_FAMILIES", "ZDIST_FAMILIES", "sfh_weights", "zdist_weights",
    "FilterArithmeticParser", "FluxUnit", "convert_flux",
    "convert_flux_err", "mahalanobis_ood", "ood_feature_contributions",
    "compare_methods_feature_importance", "CompositeSEDSimulator",
    "grid_combinations", "combine_libraries", "combine_libraries_matched",
    "match_resolution_constant_r", "AGNSimulator", "AGNGridSimulator",
    "agn_fraction", "load_config", "run_from_config", "Simformer",
    "SimformerConfig", "SimformerPosterior", "VPSDE", "train_simformer",
    "Study", "SearchSpace", "MedianPruner", "optimize_sbi",
    "sweep_learning_rates",
]
