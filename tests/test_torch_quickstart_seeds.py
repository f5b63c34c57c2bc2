"""The quickstart's fit quality across training seeds, both packages on the
CPU: is the gap between the port's and the JAX package's redshift r on the
50-object fit more than the spread between trainings?

One library (the port's host sampler at the quickstart's size,
SYNFERENCE_QUICKSTART_N rows, default 10⁴, with its four supplementary
columns, so rows are in sampler order) goes to both packages' `SBIFitter`.
For each seed s the features' noise, the training and the catalogue fit
draw from seed s (features s, training 42 + s, fit s, evaluation 1: seed 0
is the quickstart's own defaults), with the quickstart's feature and
training configuration (SYNFERENCE_QUICKSTART_EPOCHS, default 60). Each
run records the best validation loss (on its own package's features), the
mean negative log posterior density on one shared held-out set (the JAX
package's features of the library with key 1000, test split, evaluated by
each package's own posterior), the TARP deviation, and the redshift r of
the posterior medians on the quickstart's 50 objects (rows 0-49, 5%
errors) and on 1000 objects (rows 0-999), whose r moves less between
trainings. Results go to `quickstart_seeds.json` in
SYNFERENCE_SEEDS_OUT (default the test's temporary directory) and to
standard output.

The gate: the packages' mean r over 1000 objects differ by less than three
standard errors of that difference (the seeds' spread) plus 0.02.

SYNFERENCE_SEEDS_N sets the number of seeds per package (default 4, seeds
0 to N-1). Runs about 18 minutes at 4 seeds on 8 CPU cores; marked slow:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quickstart_seeds.py \\
        -m slow -s
"""

import json
import os
import pathlib

import numpy as np
import pytest

N_LIBRARY = int(os.environ.get("SYNFERENCE_QUICKSTART_N", 10_000))
MAX_EPOCHS = int(os.environ.get("SYNFERENCE_QUICKSTART_EPOCHS", 60))
SEEDS = tuple(range(int(os.environ.get("SYNFERENCE_SEEDS_N", 4))))
CENTERS = [9000.0, 11500.0, 15000.0, 20000.0, 27700.0, 35600.0, 44400.0]
WIDTHS = [2000.0, 2600.0, 3300.0, 4600.0, 7000.0, 7800.0, 10200.0]
CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
         "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
         "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
SUPPLEMENTARY = ("m_uv", "sfr_100", "mass_weighted_age", "t50")
FEATURES = dict(unit="asinh", depths_ab=(29.0,) * 7, n_scatters=2,
                include_errors=True)
TRAIN = dict(max_epochs=MAX_EPOCHS, stop_after_epochs=12, batch_size=512,
             learning_rate=5e-4)
N_OBJECTS = (50, 1000)


def _library():
    import synference_tpu_torch as tt

    sim = tt.BatchSEDSimulator(
        tt.make_synthetic_grid(n_ages=48, n_mets=8, n_wav=2048),
        tt.FilterSet([tt.tophat_filter(c, ctr, w)
                      for c, ctr, w in zip(CODES, CENTERS, WIDTHS)]),
        ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
         "tau_v"), sfh="lognormal", zdist="delta",
        emission=tt.EmissionConfig(), device="cpu")
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              supplementary=SUPPLEMENTARY, device="cpu")
    return gen.generate(n=N_LIBRARY, batch_size=min(4096, N_LIBRARY), seed=0)


def _shared_heldout(lib):
    """(θ, x) of the test split of the JAX package's features (key 1000)."""
    import jax

    import synference_tpu as st
    from synference_tpu.features import FeatureConfig

    f = st.SBIFitter(lib["photometry"].T, lib["parameters"].T,
                     lib["parameter_names"], lib["filter_codes"])
    f.create_feature_array(FeatureConfig(
        filter_codes=tuple(f.filter_codes), **FEATURES),
        key=jax.random.PRNGKey(1000))
    f.split_dataset(0.1)
    idx = f._split["test"]
    return np.asarray(f.feature_params[idx]), np.asarray(f.features[idx])


def _r(table, fitter, n):
    z_true = fitter.parameters[:n][:, list(fitter.parameter_names).index(
        "redshift")]
    return float(np.corrcoef(table["redshift_q50"][:n], z_true)[0, 1])


def _run_jax(lib, seed):
    import jax

    import synference_tpu as st
    from synference_tpu.features import FeatureConfig
    from synference_tpu.train import TrainConfig

    f = st.SBIFitter(lib["photometry"].T, lib["parameters"].T,
                     lib["parameter_names"], lib["filter_codes"])
    f.create_feature_array(FeatureConfig(
        filter_codes=tuple(f.filter_codes), **FEATURES),
        key=jax.random.PRNGKey(seed))
    res = f.run_single_sbi(model_type="nsf", hidden_features=50,
                           num_transforms=8,
                           train_config=TrainConfig(**TRAIN),
                           key=jax.random.PRNGKey(42 + seed))
    report = f.evaluate_model(n_samples=256, max_objects=256)
    obs = f.photometry[:max(N_OBJECTS)]
    table = st.fit_catalogue(f, obs, 0.05 * obs, "nJy", n_samples=500,
                             ood_methods=("mahalanobis",),
                             key=jax.random.PRNGKey(seed))
    return res, report, table, f


def _run_port(lib, seed):
    import torch

    import synference_tpu_torch as tt

    def g(s):
        return torch.Generator().manual_seed(s)

    f = tt.SBIFitter(lib["photometry"].T, lib["parameters"].T,
                     lib["parameter_names"], lib["filter_codes"],
                     device="cpu")
    f.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(f.filter_codes), **FEATURES), generator=g(seed))
    res = f.run_single_sbi(model_type="nsf", hidden_features=50,
                           num_transforms=8,
                           train_config=tt.TrainConfig(**TRAIN),
                           generator=g(42 + seed))
    report = f.evaluate_model(n_samples=256, max_objects=256)
    obs = f.photometry[:max(N_OBJECTS)]
    table = tt.fit_catalogue(f, obs, 0.05 * obs, "nJy", n_samples=500,
                             ood_methods=("mahalanobis",), generator=g(seed))
    return res, report, table, f


@pytest.mark.slow
def test_redshift_r_gap_is_within_training_spread(tmp_path):
    lib = _library()
    theta_s, x_s = _shared_heldout(lib)
    runs = []
    for package, run in (("jax", _run_jax), ("port", _run_port)):
        for seed in SEEDS:
            res, report, table, fitter = run(lib, seed)
            row = {"package": package, "seed": seed,
                   "epochs": len(res.val_losses),
                   "best_val_loss": float(np.min(res.val_losses)),
                   "heldout_nll": -float(np.mean(np.asarray(
                       fitter.posterior.log_prob(theta_s, x_s)))),
                   "tarp_deviation": float(report["tarp_deviation"])}
            for n in N_OBJECTS:
                row[f"r{n}"] = _r(table, fitter, n)
            runs.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for package in ("jax", "port"):
        for key in ("r50", "r1000", "tarp_deviation", "best_val_loss",
                    "heldout_nll"):
            v = np.array([r[key] for r in runs if r["package"] == package])
            summary[f"{package}_{key}"] = [float(v.mean()),
                                           float(v.std(ddof=1))]
    print(json.dumps(summary), flush=True)
    out = pathlib.Path(os.environ.get("SYNFERENCE_SEEDS_OUT", tmp_path))
    out.mkdir(parents=True, exist_ok=True)
    (out / "quickstart_seeds.json").write_text(json.dumps(
        {"n_library": N_LIBRARY, "max_epochs": MAX_EPOCHS, "runs": runs,
         "mean_std": summary}, indent=1))
    assert all(np.isfinite(list(r.values())[2:]).all() for r in runs)
    (mj, sj), (mp, sp) = summary["jax_r1000"], summary["port_r1000"]
    se = np.sqrt((sj ** 2 + sp ** 2) / len(SEEDS))
    assert abs(mp - mj) < 3 * se + 0.02, (mp, mj, se)
