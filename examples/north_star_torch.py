"""North-star run of the PyTorch port: generate a 2^20-SED JWST/NIRCam mock
library and train an 8-member NSF NPE to calibrated posteriors, end to end on
one NVIDIA card, timing every phase.

The twin of `examples/north_star.py` through `synference_tpu_torch`'s public
names: the same prior, forward model (64 × 12 × 10⁴ λ synthetic grid with the
ionisation axis fixed at log U = −2, 7 NIRCam curves), feature configuration,
NSF 69 × 15 with 8 members, training configuration, evaluation sizes, result
JSON and PASS rule (member TARP mean + ci95 < 0.05). The grid is built in
memory. Products are fp32 with TF32 off.

Run from anywhere: python examples/north_star_torch.py [--n 1048576]
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

CODES = ["JWST/NIRCam.F090W", "JWST/NIRCam.F115W", "JWST/NIRCam.F150W",
         "JWST/NIRCam.F200W", "JWST/NIRCam.F277W", "JWST/NIRCam.F356W",
         "JWST/NIRCam.F444W"]


def main(n_library: int, out: str, device: str, max_epochs: int):
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
        return time.time()

    t_start = clock()
    timings = {}

    # -- forward model: real-size grid + realistic filter curves ---------
    grid = tt.make_synthetic_multiaxis_grid(
        n_u=3, n_ages=64, n_mets=12, n_wav=10_000, lam_min=150.0
    ).fix_axes({"ionisation_parameter": -2.0})
    sim = tt.BatchSEDSimulator(
        grid, tt.load_instrument_filters(CODES),
        ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
         "tau_v"),
        sfh="lognormal", zdist="delta",
        emission=tt.EmissionConfig(reprocessed_types=("total",)), device=dev)
    timings["setup_s"] = round(clock() - t_start, 1)

    # -- the library -------------------------------------------------------
    t0 = clock()
    gen = tt.LibraryGenerator(sim, {
        "log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
        "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
        "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0),
    }, unlog_keys=["log10_peak_age"], device=dev)
    lib = gen.generate(n=n_library, seed=0)
    timings["generation_s"] = round(clock() - t0, 1)
    print(f"[{timings['generation_s']}s] generated {n_library:,} SEDs "
          f"(kernel build included)", flush=True)

    # -- features + NSF NPE ---------------------------------------------
    t0 = clock()
    fitter = tt.SBIFitter(
        photometry=lib["photometry"].T, parameters=lib["parameters"].T,
        parameter_names=lib["parameter_names"],
        filter_codes=lib["filter_codes"], device=dev)
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(fitter.filter_codes), unit="asinh",
        depths_ab=(29.5,) * 7, n_scatters=1, include_errors=True))
    timings["features_s"] = round(clock() - t0, 1)
    print(f"[{timings['features_s']}s] features {fitter.features.shape}",
          flush=True)

    t0 = clock()
    # 8 members trained as one set of batched weights; their spread gives
    # the seed-to-seed error bar on every calibration metric below
    n_nets = 8
    res = fitter.run_single_sbi(
        model_type="nsf", hidden_features=69, num_transforms=15,
        n_nets=n_nets,
        train_config=tt.TrainConfig(max_epochs=max_epochs,
                                    stop_after_epochs=10, batch_size=2048,
                                    learning_rate=7e-4))
    timings["training_s"] = round(clock() - t0, 1)
    n_epochs = len(res.val_losses)
    print(f"[{timings['training_s']}s] trained NSF 69x15 x{n_nets}: "
          f"{n_epochs} epochs, best val "
          f"{float(np.min(res.val_losses)):.3f}", flush=True)

    # -- calibration ------------------------------------------------------
    t0 = clock()
    report = fitter.evaluate_model(n_samples=256, max_objects=512)
    # member CIs at half size: the CI measures seed-to-seed spread, which
    # 256 objects × 128 draws resolve
    members = fitter.evaluate_members(n_samples=128, max_objects=256)
    timings["evaluation_s"] = round(clock() - t0, 1)
    timings["total_s"] = round(clock() - t_start, 1)

    result = {
        "n_library": n_library,
        "timings": timings,
        "n_epochs": n_epochs,
        "tarp_deviation": report["tarp_deviation"],
        "pit_ks": [round(v, 4) for v in report["pit_ks"]],
        "mean_log_prob": report["mean_log_prob"],
        "r2": [round(v, 3) for v in report["point"]["r2"]],
        # seed-to-seed CIs across the independently seeded members
        "tarp_ci": {k: members["tarp_deviation"][k]
                    for k in ("mean", "std", "ci95", "per_member")},
        "pit_ks_max_ci": {k: members["pit_ks_max"][k]
                          for k in ("mean", "std", "ci95")},
        "r2_members_mean": members["r2"]["mean"],
        "r2_members_std": members["r2"]["std"],
        "n_members": n_nets,
        "n_devices": 1,
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(result, indent=2), flush=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    # the pass criterion is the member CI, not a single-seed point: mean +
    # ci95 must stay inside the < 0.05 band
    tarp_hi = result["tarp_ci"]["mean"] + result["tarp_ci"]["ci95"]
    print(f"total {timings['total_s']}s "
          f"({'PASS' if tarp_hi < 0.05 else 'check'} "
          f"TARP {result['tarp_ci']['mean']:.4f} ± "
          f"{result['tarp_ci']['ci95']:.4f} across {n_nets} seeds)",
          flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2**20)
    ap.add_argument("--out", type=str, default="north_star_torch_result.json")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--max-epochs", type=int, default=36)
    args = ap.parse_args()
    main(args.n, args.out, args.device, args.max_epochs)
