"""synference_tpu_torch — the PyTorch/CUDA port of synference_tpu.

The mock-library forward path (θ draws → SFZH → windowed photometry →
features), the NPE path on top of it (`SBIFitter`: NSF ensemble training,
posterior sampling, calibration metrics, saved models that the JAX package
reads) and the dense simulator path (`BatchSEDSimulator.photometry` /
`simulate` on θ in any order, spectra included, and `recover_sed`) on torch
tensors, with hand-written CUDA kernels for Hopper in `csrc/`: K1 the
windowed megakernel, K2 the full-table megakernel, K3 the exact-shift
numerators. Every public entry point takes an explicit device; CPU tensors
run the kernels' plain PyTorch versions. This package imports neither `jax`
nor `synference_tpu`.
"""

from .cosmology import PLANCK18, Cosmology
from .features import FeatureConfig, FeaturePipeline, FeatureResult
from .fitter import SBIFitter
from .filters import Filter, FilterSet, tophat_filter
from .flows.base import ConditionalFlow, build_flow
from .grids import SPSGrid, make_synthetic_grid, make_synthetic_multiaxis_grid
from .instruments import load_instrument_filters, realistic_filter
from .library import LibraryGenerator, auto_batch_size, draw_from_hypercube
from .noise_models import DepthNoiseModel, NoiseModel
from .posterior import DirectPosterior, EnsemblePosterior
from .priors import BoxUniform, priors_from_library
from .recovery import recover_sed
from .sed import BatchSEDSimulator, EmissionConfig
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
    "EnsemblePosterior",
]
