"""Gradient-based fitting through the differentiable simulator, in the
PyTorch port, on one NVIDIA card (or the CPU).

The twin of `examples/gradient_fitting.py` through `synference_tpu_torch`'s
public names: the same tiny forward model (16 ages × 4 metallicities ×
1024 λ synthetic grid, 4 tophat bands, lognormal SFH with fixed redshift,
age, τ and metallicity, Calzetti, Inoue14; θ = log10_mass, tau_v), 8 mock
objects at 5% photometry, and the three gradient-powered tools:

1. `fisher_forecast`: Cramér–Rao bounds before any fitting;
2. `fit_catalogue_map`: MAP + Laplace error bars for the whole catalogue;
3. `fit_observation_hmc`: an exact-likelihood HMC posterior of object 0.

The fitters set the simulator's `_mega_off` for their calls, so the
photometry takes the plain, differentiable route on the card; the kernels
have no gradient. Each stage prints its seconds; the last line is one JSON
object with the results.

Size knobs (the JAX example's values by default):
    SYNFERENCE_GRADFIT_MAP_STEPS   Adam steps of the MAP fit (400)
    SYNFERENCE_GRADFIT_WARMUP      HMC warmup steps (100)
    SYNFERENCE_GRADFIT_SAMPLES     HMC samples per chain (200)
    SYNFERENCE_GRADFIT_LEAPFROG    leapfrog steps per HMC step (8)

Run from anywhere: python examples/gradient_fitting_torch.py
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

MAP_STEPS = int(os.environ.get("SYNFERENCE_GRADFIT_MAP_STEPS", 400))
WARMUP = int(os.environ.get("SYNFERENCE_GRADFIT_WARMUP", 100))
SAMPLES = int(os.environ.get("SYNFERENCE_GRADFIT_SAMPLES", 200))
LEAPFROG = int(os.environ.get("SYNFERENCE_GRADFIT_LEAPFROG", 8))


def main(device: str) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu to run "
                             "without a card)")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024,
                                  lam_min=300.0)
    filters = tt.FilterSet([
        tt.tophat_filter("F115W", 11500.0, 2600.0),
        tt.tophat_filter("F200W", 20000.0, 4600.0),
        tt.tophat_filter("F277W", 27700.0, 7000.0),
        tt.tophat_filter("F444W", 44400.0, 10200.0),
    ])
    sim = tt.BatchSEDSimulator(
        grid=grid, filters=filters, param_names=("log10_mass", "tau_v"),
        fixed_params={"redshift": 1.5, "peak_age": 3e8, "tau": 0.5,
                      "log10_metallicity": -2.5},
        sfh="lognormal", zdist="delta",
        emission=tt.EmissionConfig(igm="inoue14"), device=dev)
    prior = tt.BoxUniform(low=[8.0, 0.0], high=[11.0, 2.0],
                          names=("log10_mass", "tau_v"), device=dev)

    # mock catalogue: 8 objects, 5% photometry
    rng = np.random.default_rng(1)
    truths = np.stack([rng.uniform(8.5, 10.5, 8),
                       rng.uniform(0.1, 1.5, 8)], 1).astype(np.float32)
    with torch.no_grad():
        flux = sim.photometry(torch.as_tensor(truths, device=dev))
    sigma = 0.05 * flux
    obs = flux + sigma * torch.as_tensor(
        rng.standard_normal(tuple(flux.shape)).astype(np.float32), device=dev)
    times = {}

    # 1. forecast before any fitting: what is measurable at this depth?
    t0 = time.perf_counter()
    fr = tt.fisher_forecast(sim, truths, sigma)
    sync()
    times["fisher_s"] = time.perf_counter() - t0
    cr = fr["cramer_rao_sigma"].cpu().numpy()
    print("Fisher / Cramér-Rao 1σ bounds (median over catalogue):")
    for i, name in enumerate(fr["param_names"]):
        print(f"  {name}: {np.median(cr[:, i]):.4f}")

    # 2. whole-catalogue MAP + Laplace
    t0 = time.perf_counter()
    out = tt.fit_catalogue_map(sim, obs, sigma, prior,
                               torch.Generator(device=dev).manual_seed(0),
                               n_steps=MAP_STEPS)
    sync()
    times["map_s"] = time.perf_counter() - t0
    theta_map = out["theta_map"].cpu().numpy()
    lap = out["laplace_sigma"].cpu().numpy()
    err = theta_map - truths
    print("\nMAP residuals (mass dex):", np.round(err[:, 0], 3))
    print("Laplace σ (mass, median):", round(float(np.nanmedian(lap[:, 0])), 4))

    # 3. full HMC posterior for the first object
    t0 = time.perf_counter()
    samples, _, acc = tt.fit_observation_hmc(
        sim, obs[0], sigma[0], prior,
        torch.Generator(device=dev).manual_seed(1), n_chains=8,
        n_warmup=WARMUP, n_samples=SAMPLES, n_leapfrog=LEAPFROG)
    acc = float(acc)
    times["hmc_s"] = time.perf_counter() - t0
    samples = samples.cpu().numpy()
    med, std = np.median(samples, axis=0), samples.std(axis=0)
    print(f"\nHMC object 0: truth {truths[0]}, posterior {np.round(med, 3)} "
          f"± {np.round(std, 3)}, acceptance {acc:.2f}")
    print("HMC width vs Cramér-Rao:", np.round(std / cr[0], 2))
    for k, v in times.items():
        print(f"[time] {k[:-2]}: {v:.2f} s", flush=True)
    return {"device": dev.type, "map_steps": MAP_STEPS,
            "hmc_steps": [WARMUP, SAMPLES, LEAPFROG],
            "cramer_rao_median": np.median(cr, axis=0).tolist(),
            "map_residual_abs_max": np.abs(err).max(axis=0).tolist(),
            "laplace_sigma_median": np.nanmedian(lap, axis=0).tolist(),
            "hmc_median": med.tolist(), "hmc_std": std.tolist(),
            "hmc_acceptance": acc,
            "hmc_width_over_cramer_rao": (std / cr[0]).tolist(),
            "truth_0": truths[0].tolist(), **times}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device)))
