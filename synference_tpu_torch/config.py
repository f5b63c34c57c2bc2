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
`optuna:` block with `skip_optimization: False` asks for the HPO study,
which is not ported yet (ROADMAP M14 item 5): it raises
NotImplementedError. YAML is imported only for YAML files.

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
    if not bool(ta.get("skip_optimization", True)) and "optuna" in ta:
        raise NotImplementedError(
            "the config's optuna block (hyper-parameter search) needs hpo.py,"
            " which is not ported yet (ROADMAP M14 item 5)")
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
    fitter.run_single_sbi(
        model_type=model, engine=str(cfg.get("engine", "npe")).lower(),
        n_nets=int(cfg.get("n_nets", 1)), train_config=train_config,
        **_model_kwargs_from_fixed(fixed, model))

    out = cfg.get("output")
    if out:
        fitter.save_state(str(out))
    return fitter


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
