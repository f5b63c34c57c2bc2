#!/usr/bin/env python3
"""The port's two window bodies, timed against each other on one NVIDIA card
at the north-star model (7 NIRCam bands) and the paper-63 model (the same
grid and physics with all 63 survey bands of `examples/paper63_e2e.py`).

For each model: 4 × 65536 rows drawn on the device, z-sorted and planned as
`LibraryGenerator.generate` plans them; then one warm batch through the
staged body and through K1 (`csrc/fused_window.cu`), by CUDA events, three
times, with `library._probe_bodies` (the probe of `zsorted_fused="auto"`),
and the fused body's photometry against the staged body's on that batch.
The paper-63 model is built with `photometry_variant="interp"`, the
variant the window bodies run on; "auto" would pick the table-free conv
engine there, which is not ported.
Prints the card's name and power limit first.

Run from the repository root on a machine with a card:

    python3 scripts/window_bodies_torch.py
"""

import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

REPS = 3


def bodies(tt, name: str, codes, variant: str = "auto") -> None:
    from synference_tpu_torch import library as tl

    dev = torch.device("cuda")
    grid = tt.make_synthetic_multiaxis_grid(
        n_u=3, n_ages=64, n_mets=12, n_wav=10_000, lam_min=150.0
    ).fix_axes({"ionisation_parameter": -2.0})
    sim = tt.BatchSEDSimulator(
        grid, tt.load_instrument_filters(codes), smoke.PNAMES,
        sfh="lognormal", zdist="delta",
        emission=tt.EmissionConfig(reprocessed_types=("total",)),
        photometry_variant=variant, device=dev)
    gen = tt.LibraryGenerator(sim, smoke.PRIOR, unlog_keys=["log10_peak_age"],
                              device=dev)
    smoke.check(sim._window_mega_supported(), f"{name}: K1 does not run it")
    theta, sub, bs, kc, w_cols = gen._draw_sorted(4 * smoke.BATCH,
                                                  smoke.BATCH, seed=0)
    batch = theta[:bs]
    records = [tl._probe_bodies(sim, batch, sub, kc, w_cols)
               for _ in range(REPS)]
    fused = sim.photometry_zsorted_device(batch, sub_chunk=sub, kc=kc,
                                          w_cols=w_cols, fused=True)
    staged = sim.photometry_zsorted_device(batch, sub_chunk=sub, kc=kc,
                                           w_cols=w_cols, fused=False)
    med, p99, mx, _ = smoke.rel_stats(fused, staged)
    staged_ms = [r["staged_ms"] for r in records]
    fused_ms = [r["fused_ms"] for r in records]
    print(f"[{name}] {len(sim.filters)} bands, batch {bs}, sub {sub}, kc "
          f"{kc}, w_cols {w_cols}: staged body ms {staged_ms}, fused body "
          f"(K1) ms {fused_ms}, staged/fused "
          f"{min(staged_ms) / min(fused_ms):.2f}; fused vs staged rel "
          f"median {med:.3e} p99 {p99:.3e} max {mx:.3e}", flush=True)


def main() -> None:
    smoke.check(torch.cuda.is_available(), "no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    import synference_tpu_torch as tt

    bodies(tt, "north-star", smoke.CODES)
    # "auto" would pick the table-free conv variant at 63 bands (not
    # ported); both window bodies run on the interp tables
    bodies(tt, "paper-63", None, variant="interp")


if __name__ == "__main__":
    main()
