"""synference_tpu_torch — the PyTorch/CUDA port of synference_tpu.

The mock-library forward path (θ draws → SFZH → windowed photometry →
features) and the dense simulator path (`BatchSEDSimulator.photometry` /
`simulate` on θ in any order, spectra included, and `recover_sed`) on torch
tensors, with hand-written CUDA kernels for Hopper in `csrc/`: K1 the
windowed megakernel, K2 the full-table megakernel, K3 the exact-shift
numerators. Every public entry point takes an explicit device; CPU tensors
run the kernels' plain PyTorch versions. This package imports neither `jax`
nor `synference_tpu`.
"""

from .cosmology import PLANCK18, Cosmology
from .features import FeatureConfig, FeaturePipeline, FeatureResult
from .filters import Filter, FilterSet, tophat_filter
from .grids import SPSGrid, make_synthetic_grid, make_synthetic_multiaxis_grid
from .instruments import load_instrument_filters, realistic_filter
from .library import LibraryGenerator, auto_batch_size, draw_from_hypercube
from .noise_models import DepthNoiseModel, NoiseModel
from .recovery import recover_sed
from .sed import BatchSEDSimulator, EmissionConfig

__all__ = [
    "PLANCK18", "Cosmology", "FeatureConfig", "FeaturePipeline",
    "FeatureResult", "Filter", "FilterSet", "tophat_filter", "SPSGrid",
    "make_synthetic_grid", "make_synthetic_multiaxis_grid",
    "load_instrument_filters", "realistic_filter", "LibraryGenerator",
    "auto_batch_size", "draw_from_hypercube", "DepthNoiseModel", "NoiseModel",
    "BatchSEDSimulator", "EmissionConfig", "recover_sed",
]
