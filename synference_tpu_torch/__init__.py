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
features, the flows' embedding net) and the noise-model zoo, on torch
tensors, with hand-written CUDA kernels for Hopper in `csrc/`: K1 the
windowed megakernel, K2 the full-table megakernel, K3 the exact-shift
numerators. Every public entry point takes an explicit device; CPU tensors
run the kernels' plain PyTorch versions. This package imports neither `jax`
nor `synference_tpu`.
"""

from .catalogue import (MissingPhotometryHandler, fit_catalogue,
                        fit_catalogue_table, ood_vote)
from .cosmology import PLANCK18, Cosmology
from .features import FeatureConfig, FeaturePipeline, FeatureResult
from .fitter import SBIFitter
from .filters import Filter, FilterSet, tophat_filter
from .flows.base import ConditionalFlow, build_flow
from .grids import SPSGrid, make_synthetic_grid, make_synthetic_multiaxis_grid
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
from .mcmc import run_batched_mcmc, split_rhat_ess
from .online import run_online_snle, run_online_snpe, run_online_snre
from .posterior import (DirectPosterior, EnsemblePosterior,
                        LikelihoodPosterior, RatioPosterior)
from .priors import BoxUniform, priors_from_library
from .ratio import RatioEstimator, build_ratio_estimator, nre_loss
from .recovery import recover_sed
from .sed import BatchSEDSimulator, EmissionConfig
from .spectra import SpectralFeaturePipeline, generate_constant_r_grid
from .supplementary import SUPP_FUNCTIONS, compute_supplementary
from .train import TrainConfig, TrainResult, train_ensemble, train_npe

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
    "run_online_snre",
]
