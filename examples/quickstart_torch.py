"""Quickstart of the PyTorch port: mock library -> NSF NPE -> coverage ->
catalogue fit, end to end on one NVIDIA card (or the CPU).

The twin of `examples/quickstart.py` through `synference_tpu_torch`'s public
names: the same forward model (48 ages × 8 metallicities × 2048 λ synthetic
grid, 7 tophat NIRCam widebands, lognormal SFH, delta-Z, the default
emission), LHC priors, supplementary quantities, feature configuration
(asinh, depth 29, two scatters, errors), NSF 50 × 8 and training
configuration, evaluation and 50-object catalogue fit. It prints each
stage's seconds and, last, one JSON line with the results; the TARP
deviation passes below 0.05 (the rule of `examples/paper63_e2e.py`).

Where h5py is installed the library goes through an HDF5 file
(`generate(out_path=...)` -> `SBIFitter.init_from_hdf5`); where it is not,
the library dict goes to the fitter directly and the script says so.

Size knobs (as in the JAX example):
    SYNFERENCE_QUICKSTART_N       library size (default 10000)
    SYNFERENCE_QUICKSTART_EPOCHS  max training epochs (default 60)

Run from anywhere: python examples/quickstart_torch.py [--device cpu]
[--out-dir DIR]
"""

import argparse
import importlib.util
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

N_LIBRARY = int(os.environ.get("SYNFERENCE_QUICKSTART_N", 10_000))
MAX_EPOCHS = int(os.environ.get("SYNFERENCE_QUICKSTART_EPOCHS", 60))
CENTERS = [9000.0, 11500.0, 15000.0, 20000.0, 27700.0, 35600.0, 44400.0]
WIDTHS = [2000.0, 2600.0, 3300.0, 4600.0, 7000.0, 7800.0, 10200.0]
CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
         "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
         "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
SUPPLEMENTARY = ("m_uv", "sfr_100", "mass_weighted_age", "t50")


def main(device: str, out_dir: str) -> dict:
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
    os.makedirs(out_dir, exist_ok=True)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    seconds = {}
    t = clock()

    # -- 1. forward model --------------------------------------------------
    grid = tt.make_synthetic_grid(n_ages=48, n_mets=8, n_wav=2048)
    filters = tt.FilterSet([tt.tophat_filter(c, ctr, w)
                            for c, ctr, w in zip(CODES, CENTERS, WIDTHS)])
    sim = tt.BatchSEDSimulator(
        grid, filters, ("log10_mass", "redshift", "peak_age", "tau",
                        "log10_metallicity", "tau_v"),
        sfh="lognormal", zdist="delta", emission=tt.EmissionConfig(),
        device=dev)
    seconds["model"] = clock() - t

    # -- 2. library ----------------------------------------------------------
    t = clock()
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              supplementary=SUPPLEMENTARY, device=dev)
    have_h5py = importlib.util.find_spec("h5py") is not None
    path = os.path.join(out_dir, "quickstart_library.h5")
    lib = gen.generate(n=N_LIBRARY, batch_size=min(4096, N_LIBRARY),
                       out_path=path if have_h5py else None)
    if have_h5py:
        fitter = tt.SBIFitter.init_from_hdf5(path, device=dev)
        print(f"library written: {path}", flush=True)
    else:
        fitter = tt.SBIFitter.from_library(lib, name="quickstart_library",
                                           device=dev)
        print("h5py is not installed: the library goes to the fitter as a "
              "dict, no HDF5 file is written", flush=True)
    seconds["library"] = clock() - t

    # -- 3. features + training ------------------------------------------------
    t = clock()
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(fitter.filter_codes), unit="asinh",
        depths_ab=(29.0,) * 7, n_scatters=2, include_errors=True))
    seconds["features"] = clock() - t
    t = clock()
    res = fitter.run_single_sbi(
        model_type="nsf", hidden_features=50, num_transforms=8,
        train_config=tt.TrainConfig(max_epochs=MAX_EPOCHS,
                                    stop_after_epochs=12, batch_size=512,
                                    learning_rate=5e-4))
    seconds["training"] = clock() - t
    best_val = float(np.min(res.val_losses))
    print(f"trained: best val loss {best_val:.3f} after "
          f"{len(res.val_losses)} epochs", flush=True)

    # -- 4. evaluation + catalogue fit -------------------------------------------
    t = clock()
    report = fitter.evaluate_model(n_samples=256, max_objects=256)
    seconds["evaluation"] = clock() - t
    print("TARP deviation:", report["tarp_deviation"])
    print("PIT KS per param:", np.round(report["pit_ks"], 3))

    # 50 noiseless library SEDs as a mock catalogue (raw rows, not the
    # scatter-duplicated feature rows)
    t = clock()
    mock_obs = fitter.photometry[:50]
    table = tt.fit_catalogue(fitter, mock_obs, 0.05 * mock_obs, "nJy",
                             n_samples=500, ood_methods=("mahalanobis",))
    seconds["catalogue"] = clock() - t
    z50 = table["redshift_q50"]
    z_true = fitter.parameters[:50][:, fitter.parameter_names.index(
        "redshift")]
    z_r = float(np.corrcoef(z50, z_true)[0, 1])
    print("redshift recovery r =", round(z_r, 3))

    model = os.path.join(out_dir, "quickstart_model.pkl")
    fitter.save_state(model)
    print(f"model saved: {model}")
    seconds["total"] = sum(seconds.values())
    print("seconds by stage:",
          {k: round(v, 3) for k, v in seconds.items()}, flush=True)
    tarp = float(report["tarp_deviation"])
    return {"n_library": N_LIBRARY, "max_epochs": MAX_EPOCHS,
            "epochs": len(res.val_losses), "best_val_loss": best_val,
            "tarp_deviation": tarp, "tarp_pass": bool(tarp < 0.05),
            "pit_ks": [float(v) for v in report["pit_ks"]],
            "redshift_r": z_r, "hdf5": have_h5py, "seconds": seconds,
            "device": str(dev)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args()
    print(json.dumps(main(args.device, args.out_dir)))
