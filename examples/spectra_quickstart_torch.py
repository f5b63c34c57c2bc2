"""Spectroscopic quickstart of the PyTorch port: prism-like R~100 spectra ->
embedding-net NPE posteriors, end to end on one NVIDIA card (or the CPU).

The twin of `examples/spectra_quickstart.py` through `synference_tpu_torch`'s
public names: the same forward model (48 ages × 8 metallicities × 2048 λ
synthetic grid, one F200W tophat, lognormal SFH, delta-Z, the default
emission), an R = 100 instrument grid over 6000-53000 Å with the
20000-30000 Å norm feature (`SpectralFeaturePipeline`), a library of
spectra through `LibraryGenerator(spectral_pipeline=...)`, 2 per cent
Gaussian noise drawn with numpy (seed 0) as in the JAX example, log10
features, an NSF of 64 × 8 with a 128-wide embedding net to 32 features
trained at batch 512 with early stopping after 5 epochs, and an evaluation
with 128 draws on 512 held-out objects. Its pass rule is the JAX example's:
TARP deviation < 0.1 once the library has at least 20 000 spectra; then it
prints SPECTRA_QUICKSTART_PASS. The last line is a JSON summary with each
stage's seconds.

Size knobs (as in the JAX example):
    SYNFERENCE_SPECTRA_N       library size (default 30000)
    SYNFERENCE_SPECTRA_EPOCHS  max training epochs (default 25)

Run from anywhere: python examples/spectra_quickstart_torch.py
[--device cpu]
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import synference_tpu_torch as tt
from synference_tpu_torch.diagnostics import evaluate_posterior

N_LIBRARY = int(os.environ.get("SYNFERENCE_SPECTRA_N", 30_000))
MAX_EPOCHS = int(os.environ.get("SYNFERENCE_SPECTRA_EPOCHS", 25))
PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
PRIOR = {"log10_mass": (8.0, 11.0), "redshift": (0.5, 6.0),
         "log10_peak_age": (7.8, 9.2), "tau": (0.1, 1.0),
         "log10_metallicity": (-3.5, -1.8), "tau_v": (0.0, 1.5)}


def main(device: str, n_library: int = N_LIBRARY) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu to run "
                             "without a card)")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    seconds = {}
    t = clock()
    grid = tt.make_synthetic_grid(n_ages=48, n_mets=8, n_wav=2048)
    filters = tt.FilterSet([tt.tophat_filter("F200W", 20000.0, 4600.0)])
    sim = tt.BatchSEDSimulator(grid, filters, PNAMES, sfh="lognormal",
                               zdist="delta", emission=tt.EmissionConfig(),
                               device=dev)
    # NIRSpec-prism-like instrument grid: R≈100 over 0.6-5.3 µm
    obs_lam = tt.generate_constant_r_grid(r=100, start=6000.0, end=53000.0)
    pipe = tt.SpectralFeaturePipeline(grid.lam, obs_lam, instrument_r=100.0,
                                      norm_window=(20000.0, 30000.0),
                                      device=dev)
    seconds["model"] = clock() - t

    t = clock()
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              spectral_pipeline=pipe, device=dev)
    lib = gen.generate(n=n_library, batch_size=8192, want_spectra=True)
    spectra = lib["spectra"].T  # (N, n_pix + 1)
    theta = lib["parameters"].T
    seconds["library"] = clock() - t
    print(f"{n_library:,} spectra on {spectra.shape[1]} prism pixels "
          f"({seconds['library']:.1f} s)", flush=True)

    # noise + an embedding-net NSF on the pixel vector
    rng = np.random.default_rng(0)
    x = spectra + 0.02 * np.abs(spectra) * rng.standard_normal(spectra.shape)
    x = np.log10(np.maximum(x, 1e-12)).astype(np.float32)
    good = np.isfinite(x).all(axis=1)
    x, theta = x[good], theta[good].astype(np.float32)

    t = clock()
    flow = tt.build_flow("nsf", theta_dim=theta.shape[1],
                         context_dim=x.shape[1], hidden_features=64,
                         num_transforms=8, embedding_dim=32,
                         embedding_hidden=128, device=dev)
    n_test = 512
    res = tt.train_npe(flow, theta[:-n_test], x[:-n_test],
                       torch.Generator(device=dev).manual_seed(1),
                       tt.TrainConfig(max_epochs=MAX_EPOCHS,
                                      stop_after_epochs=5, batch_size=512))
    seconds["training"] = clock() - t
    best_val = float(np.min(res.val_losses))
    print(f"trained: best val {best_val:.2f} after {len(res.val_losses)} "
          f"epochs ({seconds['training']:.1f} s)", flush=True)

    t = clock()
    prior = tt.priors_from_library(theta, PNAMES, device=dev)
    post = tt.DirectPosterior(flow, res.params, prior)
    report = evaluate_posterior(post, x[-n_test:], theta[-n_test:],
                                n_samples=128)
    seconds["evaluation"] = clock() - t
    tarp = float(report["tarp_deviation"])
    print(f"TARP {tarp:.3f} PIT-KS max {max(report['pit_ks']):.3f} "
          f"z-R2 {report['point']['r2'][1]:.3f}", flush=True)
    if n_library >= 20_000:  # the calibration band only means much at scale
        assert tarp < 0.1, f"TARP deviation {tarp} >= 0.1"
    print("SPECTRA_QUICKSTART_PASS", flush=True)
    seconds["total"] = sum(seconds.values())
    return {"n_library": n_library, "max_epochs": MAX_EPOCHS,
            "epochs": len(res.val_losses), "n_pixels": int(spectra.shape[1]),
            "best_val_loss": best_val, "tarp_deviation": tarp,
            "pit_ks": [float(v) for v in report["pit_ks"]],
            "z_r2": float(report["point"]["r2"][1]), "seconds": seconds,
            "device": str(dev)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device)))
