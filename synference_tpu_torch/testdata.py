"""Local test-asset generation.

Counterpart of `synference_tpu/testdata.py`: it writes the same two assets
on an explicit device, without any download —

- `test_grid.hdf5`: the synthetic SPS grid (32 ages × 5 metallicities ×
  1024 λ, seed 0) in the Synthesizer layout, the JAX package's grid value
  for value;
- `sbi_test_library.hdf5`: a mock library in the reference schema from the
  batch simulator (7 NIRCam-like tophats, lognormal SFH, Inoue14 IGM),
  with a Model group.

The library's θ are drawn as `LibraryGenerator.generate` draws them (here
by the device sampler, a `torch.Generator`), so its rows are not the JAX
package's; its schema is.

Usage: ``synference-tpu-torch-testdata [--out DIR] [--n 2000] [--seed 0]
[--device cuda]``.
"""

from __future__ import annotations

import argparse
import os

import torch

__all__ = ["generate_test_data", "main"]

_CENTERS = [9000.0, 11500.0, 15000.0, 20000.0, 27700.0, 35600.0, 44400.0]
_WIDTHS = [2000.0, 2600.0, 3300.0, 4600.0, 7000.0, 7800.0, 10200.0]
_CODES = ["JWST/NIRCam.F090W", "JWST/NIRCam.F115W", "JWST/NIRCam.F150W",
          "JWST/NIRCam.F200W", "JWST/NIRCam.F277W", "JWST/NIRCam.F356W",
          "JWST/NIRCam.F444W"]


def generate_test_data(out_dir: str, n: int = 2000, seed: int = 0,
                       verbose: bool = True, *, device) -> dict:
    """Write `test_grid.hdf5` and `sbi_test_library.hdf5` under `out_dir`,
    simulating on `device`. Returns {"grid": path, "library": path}."""
    from .filters import FilterSet, tophat_filter
    from .grids import make_synthetic_grid
    from .library import LibraryGenerator
    from .sed import BatchSEDSimulator, EmissionConfig

    os.makedirs(out_dir, exist_ok=True)
    grid_path = os.path.join(out_dir, "test_grid.hdf5")
    lib_path = os.path.join(out_dir, "sbi_test_library.hdf5")

    grid = make_synthetic_grid(n_ages=32, n_mets=5, n_wav=1024, seed=0)
    grid.to_hdf5(grid_path)
    if verbose:
        print(f"wrote {grid_path} "
              f"({grid.n_ages}x{grid.n_mets}x{grid.n_wav})", flush=True)

    filters = FilterSet([tophat_filter(code, c, w)
                         for code, c, w in zip(_CODES, _CENTERS, _WIDTHS)])
    sim = BatchSEDSimulator(
        grid=grid, filters=filters,
        param_names=("log10_mass", "redshift", "peak_age", "tau",
                     "log10_metallicity", "tau_v"),
        sfh="lognormal", zdist="delta",
        emission=EmissionConfig(igm="inoue14"), device=device)
    gen = LibraryGenerator(sim, {
        "log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
        "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
        "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0),
    }, unlog_keys=["log10_peak_age"], device=device)
    gen.generate(n=n, seed=seed, out_path=lib_path)
    if verbose:
        print(f"wrote {lib_path} ({n} SEDs x {len(filters)} bands)",
              flush=True)
    return {"grid": grid_path, "library": lib_path}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="synference-tpu-torch-testdata",
        description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="synference_tpu_test_data",
                    help="output directory (created if absent)")
    ap.add_argument("--n", type=int, default=2000,
                    help="number of mock SEDs in the test library")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to simulate on (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    generate_test_data(args.out, n=args.n, seed=args.seed, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
