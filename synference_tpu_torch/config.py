"""Config-file-driven training in the reference's YAML schema.

Counterpart of `synference_tpu/config.py`. `run_from_config` takes the
reference schema (`train_args` with `fixed_params` such as `model_choice`,
`learning_rate`, `training_batch_size`, `stop_after_epochs`,
`clip_max_norm`, `<model>_hidden_features`) plus the native top-level keys
`library` (an HDF5 library), `features` (`FeatureConfig` arguments),
`engine`, `n_nets`, `max_epochs` and `output` (a `save_state` path), and
trains on an explicit device.

`train_args.epochs_per_dispatch` (epochs fused into one TPU program) is
accepted and ignored: the port's trainer has no dispatch to amortise. An
`optuna:` block under `train_args` with `skip_optimization: False` runs the
HPO study (`hpo.optimize_sbi`: `n_trials`, `pruner` {type "Median",
`n_startup_trials`, `n_warmup_steps`}, an optional `search_space`,
`study.storage`) and, unless `build_final_model: False`, retrains the best
trial's configuration. YAML is imported only for YAML files.

Command line: ``synference-tpu-torch-train config.yaml [--device cuda]``.
"""

from __future__ import annotations

import json

import torch

__all__ = ["load_config", "main", "run_from_config"]


def load_config(path: str) -> dict:
    """A JSON (by its ``.json`` suffix) or YAML config file -> dict."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    import yaml

    return yaml.safe_load(text)


def _model_kwargs_from_fixed(fixed: dict, model: str) -> dict:
    """Reference key style ('<model>_hidden_features', ...) -> kwargs."""
    out = {}
    prefix = model + "_"
    for k, v in fixed.items():
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
        elif k in ("hidden_features", "num_transforms", "num_components",
                   "num_bins", "embedding_dim"):
            out[k] = v
    return out


def run_from_config(config, fitter=None, *, device):
    """Train per a reference-style config on `device`.

    Args:
        config: path to a YAML or JSON file, or the loaded dict.
        fitter: a prebuilt `SBIFitter` (its own device is used); else the
            config's `library` names an HDF5 library loaded onto `device`.
    Returns:
        the trained fitter.
    """
    from .fitter import SBIFitter
    from .train import TrainConfig

    cfg = load_config(config) if isinstance(config, str) else dict(config)
    ta = dict(cfg.get("train_args", {}))
    if fitter is None:
        lib = cfg.get("library")
        if not lib:
            raise ValueError("config needs a 'library' path (or pass fitter=)")
        fitter = SBIFitter.init_from_hdf5(lib, device=device)

    feat = cfg.get("features")
    if feat is not None:
        from .features import FeatureConfig

        feat = dict(feat)
        feat.setdefault("filter_codes", tuple(fitter.filter_codes))
        feat["filter_codes"] = tuple(feat["filter_codes"])
        if isinstance(feat.get("depths_ab"), list):
            feat["depths_ab"] = tuple(feat["depths_ab"])
        fitter.create_feature_array(FeatureConfig(**feat))

    fixed = dict(ta.get("fixed_params", {}))
    model = str(fixed.get("model_choice", cfg.get("model_type", "nsf"))).lower()
    train_config = TrainConfig(
        learning_rate=float(fixed.get("learning_rate", 3e-4)),
        batch_size=int(fixed.get("training_batch_size",
                                 fixed.get("batch_size", 256))),
        stop_after_epochs=int(fixed.get("stop_after_epochs", 20)),
        clip_max_norm=float(fixed.get("clip_max_norm", 5.0)),
        max_epochs=int(cfg.get("max_epochs", ta.get("max_epochs", 100))),
        validation_fraction=float(ta.get("validation_fraction", 0.1)),
    )
    engine = str(cfg.get("engine", "npe")).lower()
    n_nets = int(cfg.get("n_nets", 1))
    if not bool(ta.get("skip_optimization", True)) and "optuna" in ta:
        _optimize(fitter, cfg, dict(ta["optuna"]), model, engine, n_nets,
                  train_config)
    else:
        fitter.run_single_sbi(
            model_type=model, engine=engine, n_nets=n_nets,
            train_config=train_config,
            **_model_kwargs_from_fixed(fixed, model))

    out = cfg.get("output")
    if out:
        fitter.save_state(str(out))
    return fitter


def _optimize(fitter, cfg: dict, opt: dict, model: str, engine: str,
              n_nets: int, train_config) -> None:
    """The config's `optuna:` block: the HPO study on `fitter`
    (`fitter.hpo_study`), then the best trial retrained unless
    `build_final_model` is False."""
    from .hpo import MedianPruner, optimize_sbi
    from .train import TrainConfig

    pruner_cfg = dict(opt.get("pruner", {}))
    pruner = MedianPruner(
        n_startup_trials=int(pruner_cfg.get("n_startup_trials", 5)),
        n_warmup_steps=int(pruner_cfg.get("n_warmup_steps", 3)),
    ) if str(pruner_cfg.get("type", "Median")).lower() == "median" else None
    # YAML lists become the ("int", lo, hi) / ("categorical", [..]) tuples
    # SearchSpace takes
    space = opt.get("search_space")
    if space is not None:
        space = {k: tuple(v) if isinstance(v, (list, tuple)) else v
                 for k, v in dict(space).items()}
    study, best = optimize_sbi(
        fitter, model_type=model, search_space=space,
        n_trials=int(opt.get("n_trials", 20)),
        max_epochs=train_config.max_epochs,
        storage=(dict(opt.get("study", {})).get("storage") or None),
        pruner=pruner, verbose=bool(cfg.get("verbose", True)))
    fitter.hpo_study = study
    if not bool(opt.get("build_final_model", True)):
        return
    best = dict(best)
    lr = best.pop("learning_rate", train_config.learning_rate)
    bs = best.pop("batch_size", train_config.batch_size)
    # "zoo" searches the family itself: retrain the winning model
    final_model = best.pop("model_type", model)
    fitter.run_single_sbi(
        model_type=final_model, engine=engine, n_nets=n_nets,
        train_config=TrainConfig(
            learning_rate=float(lr), batch_size=int(bs),
            max_epochs=train_config.max_epochs,
            stop_after_epochs=train_config.stop_after_epochs),
        **{k: v for k, v in best.items()
           if not isinstance(v, (list, dict))})


def main(argv=None) -> int:
    """CLI: train from a config, then print the held-out TARP deviation.
    `--device` defaults to cuda, which raises where there is no card."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="synference-tpu-torch-train",
        description="Train an SBI model from a reference-style YAML/JSON "
                    "config (see synference_tpu_torch.config).")
    ap.add_argument("config", help="path to the YAML/JSON config")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    fitter = run_from_config(args.config, device=device)
    report = fitter.evaluate_model(n_samples=128, max_objects=128)
    print("TARP deviation:", report["tarp_deviation"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
