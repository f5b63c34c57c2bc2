"""Paper-scale end-to-end run of the PyTorch port: the reference paper's
63-filter survey configuration (VISTA + HSC + MegaCam + Euclid + HST +
JWST NIRCam/MIRI + IRAC) through the whole pipeline on one NVIDIA card:
a realistic-size multi-axis grid -> a 10⁵-SED library (the paper's size) ->
depth-scattered asinh features over all 63 bands -> NSF NPE -> calibration
(TARP, PIT).

The twin of `examples/paper63_e2e.py` through `synference_tpu_torch`'s
public names: the same grid (64 ages × 12 metallicities × 10⁴ λ from 150 Å,
the ionisation axis fixed at log U = −2, built in memory), all 63
`load_instrument_filters()` curves, `EmissionConfig(reprocessed_types=
("total",))`, prior, `generate(n, seed=0)` (device-resident z-sort, window
body "auto"), asinh features at the survey depths (126 dimensions), NSF
69 × 15 at batch 2048 and learning rate 7e-4, `evaluate_model(256, 512)`
and, with two or more members, `evaluate_members`; the same knobs and PASS
rule (TARP < 0.05). Products are fp32 with TF32 off. The last line printed
is the result JSON.

Run from anywhere: python examples/paper63_e2e_torch.py [--n 100000]
(`--device cpu` runs without a card, at a small `--n`).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import synference_tpu_torch as tt
from synference_tpu_torch.ops import fused_sed


def realistic_grid():
    """The north-star grid: 3 × 64 × 12 × 10⁴ λ at log U = −2."""
    return tt.make_synthetic_multiaxis_grid(
        n_u=3, n_ages=64, n_mets=12, n_wav=10_000, lam_min=150.0
    ).fix_axes({"ionisation_parameter": -2.0})


def survey_depths(codes):
    """Plausible 5σ AB depths per facility."""
    def depth(code):
        c = code.lower()
        if "nircam" in c:
            return 29.0
        if "miri" in c:
            return 25.5
        if "irac" in c or "spitzer" in c:
            return 24.5
        if "euclid" in c or "vista" in c:
            return 25.0
        if "hst" in c or "acs" in c or "wfc3" in c:
            return 27.5
        return 26.0  # ground-based optical (HSC/MegaCam)
    return tuple(depth(c) for c in codes)


def main(n_library: int, out: str | None, device: str, grid=None,
         max_epochs: int = 40, n_nets: int = 1, stop_after: int = 8) -> dict:
    dev = torch.device(device)
    card = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu to run "
                             "without a card)")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(card, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.time()

    t_start = clock()
    timings = {}
    grid = grid if grid is not None else realistic_grid()
    filters = tt.load_instrument_filters()  # all 63 survey curves
    sim = tt.BatchSEDSimulator(
        grid, filters,
        ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
         "tau_v"),
        sfh="lognormal", zdist="delta",
        emission=tt.EmissionConfig(reprocessed_types=("total",)), device=dev)
    n_f = len(filters)
    timings["setup_s"] = round(clock() - t_start, 1)
    print(f"[{timings['setup_s']}s] setup: {n_f} filters, grid "
          f"{grid.n_ages}x{grid.n_mets}x{grid.n_wav}", flush=True)

    t0 = clock()
    gen = tt.LibraryGenerator(sim, {
        "log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
        "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
        "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0),
    }, unlog_keys=["log10_peak_age"], device=dev)
    k1_before = fused_sed.fused_window_photometry.launches
    lib = gen.generate(n=n_library, seed=0)
    k1_launches = fused_sed.fused_window_photometry.launches - k1_before
    timings["generation_s"] = round(clock() - t0, 1)
    print(f"[{timings['generation_s']}s] generated {n_library:,} x {n_f} "
          f"band fluxes ({k1_launches} K1 launches; kernel build "
          "included)", flush=True)

    t0 = clock()
    fitter = tt.SBIFitter.from_library(lib, device=dev)
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(fitter.filter_codes), unit="asinh",
        depths_ab=survey_depths(fitter.filter_codes), n_scatters=1,
        include_errors=True))
    timings["features_s"] = round(clock() - t0, 1)
    print(f"[{timings['features_s']}s] features {fitter.features.shape}",
          flush=True)

    t0 = clock()
    res = fitter.run_single_sbi(
        model_type="nsf", hidden_features=69, num_transforms=15,
        n_nets=n_nets,
        train_config=tt.TrainConfig(max_epochs=max_epochs,
                                    stop_after_epochs=stop_after,
                                    batch_size=2048, learning_rate=7e-4))
    timings["training_s"] = round(clock() - t0, 1)
    print(f"[{timings['training_s']}s] trained NSF 69x15 x{n_nets}: "
          f"{len(res.val_losses)} epochs, best val "
          f"{float(np.min(res.val_losses)):.3f}", flush=True)

    t0 = clock()
    report = fitter.evaluate_model(n_samples=256, max_objects=512)
    members = (fitter.evaluate_members(n_samples=256, max_objects=512)
               if n_nets > 1 else None)
    timings["evaluation_s"] = round(clock() - t0, 1)
    timings["total_s"] = round(clock() - t_start, 1)

    result = {
        "n_library": n_library,
        "n_filters": n_f,
        "feature_dim": int(fitter.features.shape[1]),
        "device": str(dev),
        "card": card,
        "epochs": len(res.val_losses),
        "k1_launches": int(k1_launches),
        "timings": timings,
        "tarp_deviation": report["tarp_deviation"],
        "pit_ks": [round(v, 4) for v in report["pit_ks"]],
        "mean_log_prob": report["mean_log_prob"],
        "r2": [round(v, 3) for v in report["point"]["r2"]],
    }
    if members is not None:
        # seed-to-seed spread across the ensemble's members
        result["tarp_ci"] = {k: members["tarp_deviation"][k]
                             for k in ("mean", "std", "ci95", "per_member")}
        result["pit_ks_max_ci"] = {k: members["pit_ks_max"][k]
                                   for k in ("mean", "std", "ci95")}
        result["r2_members_mean"] = members["r2"]["mean"]
        result["r2_members_std"] = members["r2"]["std"]
        result["n_members"] = n_nets
    result["pass"] = bool(result["tarp_deviation"] < 0.05)
    print(f"total {timings['total_s']}s "
          f"({'PASS' if result['pass'] else 'check'} TARP within ~1 sigma)",
          flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--out", type=str, default="paper63_result_torch.json")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--n-nets", type=int, default=1)
    ap.add_argument("--stop-after", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()
    main(args.n, args.out, args.device, max_epochs=args.epochs,
         n_nets=args.n_nets, stop_after=args.stop_after)
