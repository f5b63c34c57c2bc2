#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (`synference_tpu_torch`).

Drives the port's paths once on one NVIDIA card. The mock-library path and
the inference paths on top of it (features, NSF ensemble training, posterior
sampling, calibration metrics, a saved model) run at the north-star width (64 ages × 12 metallicities × 10⁴ λ grid, 7
NIRCam bands, lognormal SFH, delta-Z, Calzetti screen, Inoue14 IGM); the
dense simulator path at `bench.py`'s headline width (48 ages × 8
metallicities × 2048 λ from 300 Å, 7 tophat bands, the same physics, 65536
unsorted θ):

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles every kernel in `synference_tpu_torch/csrc/` (K1, K2,
   K3), one nvcc process per source, all started together;
3. K1 vs plain: K1 against its plain PyTorch version and against the
   exact first product (float64, rounded once; the exact gate) on
   main-path sub-chunks (orders 1 and 3) and, in its one-launch form, on a
   whole main-path batch of 64 sub-chunks, with both timings per batch
   beside the sum of the sub-chunks' bounds (fp32 FMA, and a 3xTF32
   route's for comparison) and the cuBLAS first product, and a check that
   both bounds reject the plain version with a TF32 or a bf16 first
   product (the three-call 3xTF32 emulation's reading printed beside);
4. main path: `LibraryGenerator.generate(n=2^20, zsorted_fused=True)`,
   checking that K1 ran once per 65536-row batch, that the photometry is
   finite and non-negative, and that one sub-chunk agrees with the staged
   window body;
5. features: asinh features with depth noise and errors;
6. dense photometry: `sim.photometry(θ)` on the headline model launches K2
   once; K2 against its plain version and the exact first product (and
   the power check), the result against the plain `_photometry_fused`
   route, with times and both bounds;
7. K2 at the north-star width: one unsorted batch, K2 against its plain
   version and the exact first product, both bounds, and both routes'
   times (the card's crossover record);
8. exact spectra: `simulate(θ, want_spectra=True)` with the "roll" and
   "bank" variants launches K3 once; the whole call's time; K3 against its
   plain version at the headline batch, on row- and column-sliced views of
   the flux, at 16 bands, on sorted rows and at a wide shape whose table
   slab does not fit in shared memory (the north-star grid's 10⁴ columns);
   its row keys against their plain version; two runs bitwise equal, and
   each row's bits independent of the rest of the batch; roll equal to
   bank; 1024 rows of each route against an exact filter integral;
9. train: `SBIFitter.run_single_sbi("nsf", hidden_features=69,
   num_transforms=15, n_nets=8)` for 5 epochs at batch 2048 on every fourth
   row of the phase-4 library (2^18 rows; depth is cut, width is not),
   fp32 with TF32 off: every loss finite; for each member the best
   validation loss of epochs 2-5 below that of epoch 1, the training loss
   falling, and the best validation loss kept equal to its path's minimum;
   the ensemble's mean validation loss falling; the members different; and
   no call inside an epoch that waits for the card (the trainer runs its
   epochs under the sync debug mode "error"; a loss that reads a value back
   must raise there). Prints the seconds per epoch from the per-epoch
   callback, the ms of one step alone and of one validation pass alone
   (host clock), steps/s, and the host's CPU, load and time per launch of
   a one-element kernel;
10. posterior: `evaluate_model(256, max_objects=512)` and
   `evaluate_members(128, max_objects=256)` with raw draws/s; every sample
   inside the prior box and acceptance 1.0 (support-aware flow); the flow's
   inverse then forward recovers the base normals to 1e-4; the ensemble's
   `log_prob` on the card against the same parameters on the CPU to 1e-4 on
   256 objects; `save_state` → `load_saved_model` gives the same `log_prob`
   bits. TARP, PIT-KS and R² after 5 epochs are readings, not gates.

11. library file: `LibraryGenerator.generate(65536, supplementary=(m_uv,
   sfr_100, mass_weighted_age, t50), device_sampling=False)` on the
   headline model, SEDs/s; θ equal bit for bit to a numpy recomputation of
   the host sampler (scipy's Latin hypercube); the supplementary columns
   finite and, on 256 rows, within the CPU tests' end-to-end bounds of the
   same rows on the CPU; where h5py imports, `save` → `init_from_hdf5` →
   `simulator_from_library` (else one line says the HDF5 step did not run);
12. defaults and resume: `generate(2^20)` at the defaults on the
   north-star model launches K1 once per batch and equals phase 4's bits;
   a 2-batch run at the defaults launches K1 twice; a 4-batch run interrupted after batch 2 by a deliberate exception resumes
   from its chunk files to the bits of an uninterrupted run;
13. features: normalisation by a filter, `missing_fraction=0.1` with flag
   columns and one colour on the phase-4 library on the card, and
   `transform_observations(missing_mask=...)` on 1024 rows, each against
   the CPU with the card's masks passed in;
14. catalogue: on phase 9's fitter, `fit_catalogue` of 1024 noised library
   rows and 16 garbage rows with the five native OOD methods and the
   north-star simulator (K2 launches counted), `recover_seds=True` on 64
   objects, and 256 objects with two bands masked through
   `MissingPhotometryHandler` over the 2^18-row library (nmc 16): quantile
   columns finite and ordered, every garbage row flagged, seconds per 1000
   objects for each step.
15. families and particles: `generate(2^18, zsorted_fused=True)` through
   K1 (4 launches each) of the north-star model with a delayed-τ SFH and a
   normal metallicity distribution, and of the main-path model with 100
   star particles per galaxy (SFZH rows mostly zeros); on each, K1 against
   its plain version on one batch and the first sub-chunk against the
   staged body; the particle SFZHs bitwise equal across two batchings; K2
   against its plain version on 65536 unsorted headline rows of each;
16. paper-63 width (phase 1's grid with all 63 survey bands): "auto" picks
   interp (a knot matrix of a few hundred MiB); `photometry()` (K2) and the
   fused window engine (K1) each answer one 65536-row batch, counted with
   the counts set to 0 just before; `conv` answers it through
   `photometry()` and through the window engine, within the JAX package's
   conv/interp bound of interp (K2); each route's time; K1 (grouped) and
   K2 at F8 64, which run in thread-block clusters of `cluster_size(64)`
   band groups, against their plain versions (phase 7's bound: cuBLAS sums
   the plain first product in another order at these shapes) and the
   exact first product, two runs bitwise equal and bitwise equal to the
   kernel on each 8-band slice of the tables, with times, both bounds and
   shares;
17. spectral path at the spectroscopic twin's width: `generate(30000,
   want_spectra=True)` through the R = 100 `SpectralFeaturePipeline`
   (the pipeline on 256 spectra against the CPU, max relative < 1e-5),
   features from the raw spectra with a `SpectralNoiseModel`, an NSF 64 × 8
   with a 128-wide embedding net to 32 features trained 3 epochs, and its
   evaluation (readings);
18. noise models and lines: `create_noise_models_from_catalogue` on a seeded
   10^5-object catalogue (general models with upper limits), features with
   them on the phase-4 library, their HDF5 round trip where h5py imports,
   and `line_quantities` on 65536 young-burst rows against the CPU
   (relative < 2e-3: one float32 ulp of max_age moves a burst's bins).
   Phase 16 also times K1 and K2 alone at this width beside their bounds
   (`k1_bound` summed over the sub-chunks, `bound` for K2).
19. flow zoo: every registry name of the JAX package (maf, made, nsf,
   realnvp, affine_coupling, nice, mdn, gaussian, ncsf, naf, unaf, sospf,
   gf, cnf) at the widths of `scripts/zoo_sweep.py`, as NPE (support-aware)
   on every 16th row of the phase-4 library (65536 rows, 14 features), 2
   members, 2 epochs at batch 2048: every loss finite; `log_prob` card vs
   CPU < 1e-4 on 256 rows; every draw inside the prior box; inverse then
   forward of the flow proper recovers its base draws (maf, nsf, realnvp,
   nice, ncsf: fp64 max and fp32 p99.9 < 1e-4; naf, unaf, sospf by
   bisection: fp64 max < 1e-4; gf a reading); ms per step and raw draws/s;
20. NLE and NRE: `run_single_sbi("nsf", engine="nle"|"nre",
   hidden_features=69, num_transforms=15, n_nets=8)` 3 epochs on phase 9's
   2^18 rows; `sample_posterior` of 256 held-out objects x 256 draws by
   batched MCMC (64 walkers, burn-in 256, thin 2): draws inside the box,
   acceptance in (0, 1), R-hat and ESS finite, s per 1000 objects and
   likelihood rows/s; the loop's sync guard raises on a readback; a 16-step
   chain on 8 objects from the same draws, card vs CPU; `save_state` ->
   `load_saved_model` gives the same `_loglike` bits; `fit_catalogue` has
   the three MCMC columns; TARP, PIT-KS and the share of R-hat > 1.1 are
   readings;
21. online engines: `run_online_sbi` "snpe", "snle", "snre" with the
   headline model's `photometry()` (K2) and asinh features as the
   simulator, 2 rounds of 4096, NSF 32 x 4 (MLP 32 for snre), one member:
   K2 launches in every round, every round's loss finite, the posterior's
   draws for x_obs inside the box; seconds per round.
22. gradient fitters: the north-star simulator under `_mega_off` (its
   plain route), a mock catalogue of 1024 box-uniform draws through
   `photometry()` (one K2 launch) with depth-29.5 noise. K1, K2 and K3
   refuse an input that requires grad and a forward-AD dual; the
   log-posterior gradient on 256 rows is finite, card against CPU (the same
   simulator on the CPU with the card's tables) < 1e-4 of each row's
   largest entry; `fisher_forecast` on 65536 rows finite and symmetric,
   card against CPU on 64 rows < 1e-4; `fit_catalogue_map` (4 restarts,
   400 steps) and `fit_catalogue_vi` on all 1024 objects finite and inside
   the box; `fit_catalogue_hmc` of 256 objects × 8 chains at the JAX
   defaults under sync debug mode "error", acceptance in (0, 1), samples
   inside the box; a short HMC from the same draws on the card and the CPU;
   `posterior_crosscheck` of phase 9's NPE on 8 objects, C2ST in [0, 1];
   `model_comparison` against phase 15's delayed-τ model on 4 objects,
   log Z finite. No fitter call launches a kernel, and `_mega_off` is back
   to False after each. Readings: s per 1000 objects, gradient rows/s, MAP
   pulls, split-R̂, HMC σ / Cramér-Rao σ, C2ST, Bayes factors;
23. diagnostics on phase 9's fitter: `fitter.lc2st` (1000 calibration
   pairs, 20 null classifiers, 200 epochs), card against CPU from the same
   draws; `detect_misspecification` (a 5-epoch marginal maf) flags every
   garbage row; `feature_importance`, `shapley_feature_importance` (Σφ =
   v(all) − v(none) to 1e-4); `calculate_map` of 64 objects inside the
   box; `restricted_prior_from_simulations` on 65536 library θ, invalid in
   one corner, puts < 2% of 10⁴ draws there. Phases 22-23 print their
   seconds and their launches of K1, K2 and K3;
24. AGN: the AGN twin's model at full width (`AGNGridSimulator` on a 6 × 4
   × 2048 AGN grid, 7 NIRCam tophats): `generate(2^18)` timed (host
   sampler, the plain dense route), finite and non-negative; NSF 50 x 8 on
   its first 20 000 rows for 5 epochs (cut from 60) with the live loss
   plot drawn into a StringIO, the best later validation loss below epoch
   1's; `evaluate_model(256, 256)` and `fit_catalogue` of 50 rows
   (readings: TARP, PIT-KS, recovery r); both AGN simulators'
   `photometry()` of 4096 rows against the same route on the CPU (the
   phase-6 route bound); no K1, K2 or K3 launch in the whole phase;
25. composite: the headline stellar model plus an `AGNGridSimulator` on
   its filters, `photometry()` of 65536 rows launches K2 exactly once and
   equals the sum of the components' plain routes (the phase-6 route
   bound), timed beside each component alone; `agn_fraction` of phase-4
   stellar θ with phase-24 AGN θ on the card against a float64 host
   integral; `combine_libraries` of the phase-4 and phase-24 libraries
   around z = 2 (a cell against a hand sum) and matched on 4096 rows;
   `run_from_config` of a JSON config with `fitter=`;
26. simformer: `run_single_simformer` (d_model 128, 4 layers × 4 heads,
   the 20 tokens of phase 9's θ and features) for 3 epochs on 2^16 rows,
   ms per eager step; the 500-step `sample_batch` of 64 objects × 256 draws
   as one captured CUDA graph per step against the eager steps (same bits,
   or within 1e-6), draws/s; card against CPU from the same weights for the
   score (1e-4) and `log_prob` by 20 PF-ODE steps on 256 rows (1e-3
   absolute), the graphed ODE equal to the eager one; `save_state` →
   `load_saved_model` draws the same; no kernel launch;
27. HPO: `optimize_sbi` of 4 trials × ≤ 3 epochs (NSF 32 × 4) on every
   16th row of the phase-4 library with a median pruner, the later trials
   (learning rate 1e-7) cut mid-run; `sweep_learning_rates` at 4 rates as
   one 4-member `train_ensemble` call; `run_from_config` with an `optuna:`
   block; no kernel launch;
28. paper-63 twin: `examples/paper63_e2e_torch.py`'s `main` at full width
   (phase 1's grid, all 63 curves, 126 features, NSF 69 × 15) on 2^16 rows,
   2 epochs, one member: its stage timings, "auto"'s choice and its K1
   launches (readings: TARP, R²);
29. parallel: a one-rank NCCL group: `sharded_generate(2^18)` z-sorted
   equals `generate(..., device_sampling=False)` bit for bit (K1 launches
   counted) and dense equals `photometry()` per batch (K2); the sharded
   photometry of 65536 headline rows launches K2 once and equals
   `photometry()`; the sharded NSF 69 × 15 step (NCCL `all_reduce` over
   "data") equals the trainer's step bit for bit over 3 steps; ragged
   objects padded for sampling; a directory checkpoint read back;
30. birth cloud: K1 and K2 with Charlot & Fall (2000) dust (the ISM and
   the birth cloud over the grid's 300 young cells) at the north-star
   bands (F8 8) and all 63 (F8 64) on 65536 rows: against their plain
   versions and the exact gate, bitwise across two runs and against their
   8-band slices, with τ_BC = 0 bitwise the one-screen kernel; each timed
   beside its bound and beside the one-screen kernel on the same rows.
31. Pacman: K1 and K2 with a per-row escape fraction (fesc a θ column:
   the incident table escapes unscreened, the total table sits behind the
   ISM screen; a fifth of the rows at fesc 0 or 1) at F8 8 and F8 64 on
   65536 rows: against their plain versions and the exact gate, bitwise
   across two runs and against their 8-band slices, with fesc = 0 bitwise
   the one-screen kernel on the total table; each timed beside its bound
   at 4·C·W FLOPs a row and beside the one-screen kernel on the same rows.
32. SFZH: the lognormal × delta-Z SFZH kernel (`csrc/sfzh.cu`) on a
   main-path batch of 65536 rows at the north-star width (64 ages × 12
   metallicities, C 768): bit for bit the plain `_sfzh` (`_mega_off`),
   SFZH and age marginal; timed alone, as the whole `_sfzh` (with its
   PyTorch prologue) and as the plain `_sfzh`, beside its bound (one
   write of the SFZH and one read of its inputs); phase 4 launched it
   once a batch.

Run from the repository root: `python3 chip_smoke.py`. Any failed phase
exits non-zero. The line before the last is a JSON summary of every kernel
on the path (with its launches on the main path and on phases 16 and
19-29 by phase, each kernel's share of its bound, `first_product_ms`:
the fp32 first product alone as one cuBLAS `torch.matmul` with TF32 off, a
yardstick for the kernels' core that the port never calls, and for K1 and
K2 `paper63`: their time, bound and share at F8 64 and the cluster size
they ran with, `birth_cloud`: phase 30's at F8 8 and 64, and `pacman`:
phase 31's; the SFZH kernel's row, phase 32's); the last line
is `{"ok": true, "device": {...}}`.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_LIBRARY = 2**20
BATCH = 65536  # rows per generation batch: one K1 launch each
CODES = ["JWST/NIRCam.F090W", "JWST/NIRCam.F115W", "JWST/NIRCam.F150W",
         "JWST/NIRCam.F200W", "JWST/NIRCam.F277W", "JWST/NIRCam.F356W",
         "JWST/NIRCam.F444W"]
PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
         "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
         "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
# Relative differences on fluxes above 1e-3 of their row maximum.
# K1 against its plain version: the same fp32 first product and bf16 knot
# product on one card, so max < 1e-5 (measured max 3.6e-7 on an H100).
TOL_KERNEL_MAX = 1e-5
# the fused window body against the staged one, which applies dλ/λ after the
# screen: its fp32 rounding can flip a bf16 rounding of the knot product's
# input (measured p99 2.7e-7, max 4.1e-5 on an H100). The same bound holds
# the dense K2 route against the plain `_photometry_fused` route.
TOL_STAGED_P99, TOL_STAGED_MAX = 1e-5, 1e-3
# The dense path's headline model (bench.py's `bench_generation`).
HEADLINE_BATCH = 65536
HEADLINE_CENTERS = [9000., 11500., 15000., 20000., 27700., 35600., 44400.]
HEADLINE_WIDTHS = [2000., 2600., 3300., 4600., 7000., 7800., 10200.]
WIDE_ROWS = 16384  # K3's wide shape: rows of the north-star grid's width
# The exact routes against a float64 filter integral at the true shift, as
# tests/test_pallas_kernel.py::test_matches_xla_path bounds them: |Δ| below
# these fractions of the row's largest flux (1/8-column snapping for roll
# and bank, whole-column lerp of the filter table for xla).
TOL_EXACT_SNAP, TOL_EXACT_LERP = 2.5e-2, 6e-2
# H100 SXM peaks (NVIDIA datasheet, dense, 700 W) for the bounds
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
# TF32 tensor cores: the ceiling of a 3xTF32 first product, which the
# kernels do not take (the three-call emulation fails the exact gate below)
PEAK_TF32_FLOP_S = 495e12
# The NPE path: the north-star model at full width, cut in depth.
TRAIN_STRIDE = 4  # every fourth library row: 2^18 rows spanning all z
# the fewest epochs after which every member's best later validation loss
# lies a nat below its first (the early path moves by ~1 nat per epoch)
TRAIN_EPOCHS = 5
N_NETS = 8
# inverse∘forward of the flow on base normals (in fp64 every value, in fp32
# the 99.9th percentile: a few fp32 spline inversions are ill-conditioned,
# in the JAX package too), and the ensemble's fp32 log_prob on the card
# against the CPU
TOL_FLOW = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_stats(out, ref):
    """(median, p99, max) relative difference on significant fluxes, and
    the max absolute difference."""
    out, ref = out.detach().cpu().numpy(), ref.detach().cpu().numpy()
    check(out.shape == ref.shape, f"shape {out.shape} vs {ref.shape}")
    check(bool(np.isfinite(out).all()), "non-finite kernel output")
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)
    sig = rel[ref > 1e-3 * ref.max(axis=1, keepdims=True)]
    return (float(np.median(sig)), float(np.quantile(sig, 0.99)),
            float(sig.max()), float(np.abs(out - ref).max()))


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_model(tt, dev):
    grid = tt.make_synthetic_multiaxis_grid(
        n_u=3, n_ages=64, n_mets=12, n_wav=10_000, lam_min=150.0
    ).fix_axes({"ionisation_parameter": -2.0})
    sim = tt.BatchSEDSimulator(
        grid, tt.load_instrument_filters(CODES), PNAMES, sfh="lognormal",
        zdist="delta", emission=tt.EmissionConfig(reprocessed_types=("total",)),
        device=dev)
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              device=dev)
    return sim, gen


def k1_bound(a: dict) -> dict:
    """K1's bound for one sub-chunk's keyword arguments."""
    b, c = a["sfzh"].shape
    w = a["sed_w"].shape[1]
    kf = a["kc"] * a["f8"]
    return bound(flops_fp32=2.0 * b * c * w, flops_bf16=2.0 * b * w * kf,
                 nbytes=4 * (b * c + c * w + w + kf + 3 * b + b * a["f8"])
                 + 2 * w * kf)


def first_product_ms(sfzh, sed, reps: int = 10) -> float:
    """The fp32 first product alone, one cuBLAS call with TF32 off (the
    yardstick for the kernels' core; the port never calls it)."""
    return time_ms(lambda: torch.matmul(sfzh, sed), reps=reps)


def kernel_vs_plain(sim, gen, k1):
    """K1 and its plain version on the main path's own inputs: the first
    sub-chunk of the run and one from its middle (one launch each), then a
    whole 65536-row batch in one launch, orders 1 and 3."""
    theta, sub, bs, kc, w_cols, _ = gen._draw_sorted(N_LIBRARY, BATCH,
                                                     seed=0)
    calls = []
    for start in (0, theta.shape[0] // 2):
        chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(
            theta[start:start + sub], sub, kc, w_cols)
        calls.append(next(sim._window_calls(chunk, sub, w_cols, kc, k0, l0)))
    a0 = calls[0][3]
    log(f"[kernel] main-path sub-chunk: B={a0['sfzh'].shape[0]} "
        f"C={a0['sfzh'].shape[1]} W={a0['sed_w'].shape[1]} kc={kc} "
        f"F8={a0['f8']} delta={a0['delta']}")
    worst = {"max_abs_err": 0.0}
    for order in (1, 3):
        for i, (_, _, _, a) in enumerate(calls):
            a = dict(a, order=order)
            out = k1.fused_window_photometry(**a)
            torch.cuda.synchronize()
            ref = k1.fused_window_photometry_reference(**a)
            med, p99, mx, abs_err = rel_stats(out, ref)
            log(f"[kernel] order={order} sub-chunk {i}: rel median={med:.3e} "
                f"p99={p99:.3e} max={mx:.3e} (tol max<{TOL_KERNEL_MAX}); "
                f"max abs err={abs_err:.4e} nJy")
            check(mx < TOL_KERNEL_MAX,
                  f"K1 disagrees with its plain version (order {order})")
            exact_gate(k1, "kernel", f"K1 order={order} sub-chunk {i}", out,
                       k1.fused_window_photometry_exact(**a), ref)
            worst["max_abs_err"] = max(worst["max_abs_err"], abs_err)
    a = dict(a0, order=3)
    bound_has_power(k1, a, "K1")
    sub_ms = time_ms(lambda: k1.fused_window_photometry(**a))
    log(f"[kernel] one sub-chunk in its own launch (order 3): K1 "
        f"{sub_ms:.4f} ms, bound {k1_bound(a)['bound_ms']:.4f} ms")

    # a whole main-path batch (the middle one), as the main path launches it
    mid = (theta.shape[0] // bs // 2) * bs
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(
        theta[mid:mid + bs], sub, kc, w_cols)
    g = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
    for order in (1, 3):
        out = k1.fused_window_photometry_grouped(**dict(g, order=order))
        torch.cuda.synchronize()
        ref = k1.fused_window_photometry_grouped_reference(
            **dict(g, order=order))
        med, p99, mx, abs_err = rel_stats(out, ref)
        log(f"[kernel] order={order} batch of {len(k0)} sub-chunks in one "
            f"launch: rel median={med:.3e} p99={p99:.3e} max={mx:.3e} (tol "
            f"max<{TOL_KERNEL_MAX}); max abs err={abs_err:.4e} nJy")
        check(mx < TOL_KERNEL_MAX,
              f"grouped K1 disagrees with its plain version (order {order})")
        exact_gate(k1, "kernel", f"grouped K1 order={order}", out,
                   k1.fused_window_photometry_grouped_reference(
                       **dict(g, order=order),
                       first_product=k1.exact_first_product), ref)
        worst["max_abs_err"] = max(worst["max_abs_err"], abs_err)
    check(torch.equal(out, k1.fused_window_photometry_grouped(**g)),
          "two K1 runs differ")
    subs = [a for *_, a in sim._window_calls(chunk, sub, w_cols, kc, k0, l0)]
    bounds = [k1_bound(a) for a in subs]
    worst["bound_ms"] = sum(b["bound_ms"] for b in bounds)
    worst["tf32x3_bound_ms"] = sum(b["tf32x3_bound_ms"] for b in bounds)
    worst["bound_by"] = ("operations" if all(
        b["bound_by"] == "operations" for b in bounds) else "bytes")
    worst["ms"] = time_ms(lambda: k1.fused_window_photometry_grouped(**g),
                          reps=10)
    worst["plain_ms"] = time_ms(
        lambda: k1.fused_window_photometry_grouped_reference(**g), reps=3)
    worst["first_product_ms"] = first_product_ms(
        g["sfzh"], g["tables"]["sed"][:, :w_cols])
    log(f"[kernel] K1 per batch of {bs} rows ({len(k0)} sub-chunks, one "
        f"launch, order 3): {worst['ms']:.4f} ms, plain "
        f"{worst['plain_ms']:.4f} ms; sum of the sub-chunks' bounds "
        f"{worst['bound_ms']:.4f} ms ({worst['bound_by']}; fp32 FMA, the "
        f"kernel's arithmetic), share {worst['bound_ms'] / worst['ms']:.3f};"
        f" a 3xTF32 route's bound {worst['tf32x3_bound_ms']:.4f} ms; cuBLAS fp32 "
        f"first product of the batch's shape {worst['first_product_ms']:.4f}"
        f" ms (CUDA events); two runs bitwise equal")
    return worst, calls[0]


def bound_has_power(k1, a, name: str = "kernel") -> None:
    """The bounds must reject the shortcuts a kernel could take in its first
    product: the plain version with one TF32 product, and with bf16 inputs,
    miss both the fp32 plain bound and the exact gate. The three-call
    3xTF32 emulation (`tf32x3_first_product`, TF32 tensor cores) is read
    against the exact gate too. `a` holds K1's plain version's arguments
    (K2's plain version is K1's over the whole tables)."""
    ref = k1.fused_window_photometry_reference(**a)
    exact = k1.fused_window_photometry_exact(**a)

    def tf32(x, y):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return x @ y
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    for low, fp in (("TF32", tf32),
                    ("bf16", lambda x, y: x.bfloat16().float()
                     @ y.bfloat16().float()),
                    ("three-call 3xTF32", k1.tf32x3_first_product)):
        out = k1.fused_window_photometry_reference(**a, first_product=fp)
        med, p99, mx, _ = rel_stats(out, ref)
        g = k1.exact_gate(out, exact, ref)
        log(f"[{name}] plain with a {low} first product: vs plain rel "
            f"median={med:.3e} p99={p99:.3e} max={mx:.3e}; vs exact "
            f"p99={g['p99']:.3e} max={g['max']:.3e} share>1e-5="
            f"{g['share']:.3e} (gate share<={2 * g['share_plain'] + 1e-4:.3e}"
            f"): {'passes' if g['ok'] else 'fails'} the exact gate")
        if low != "three-call 3xTF32":
            check(mx > TOL_KERNEL_MAX and not g["ok"],
                  f"the {name} bounds do not reject a {low} first product")


def main_path(sim, gen, k1, kc: int, w_cols: int):
    """The timed main-path run, with K1's and the SFZH kernel's launch
    counts read around it."""
    from synference_tpu_torch.ops import sfzh as sfzh_op

    gen.generate(n=65536, seed=1, zsorted_fused=True)  # warm-up, not counted
    torch.cuda.synchronize()
    k1.fused_window_photometry.launches = 0
    sfzh_before = sfzh_op.lognormal_delta_sfzh.launches
    t0 = time.perf_counter()
    lib = gen.generate(n=N_LIBRARY, seed=0, zsorted_fused=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.fused_window_photometry.launches
    sfzh_launches = sfzh_op.lognormal_delta_sfzh.launches - sfzh_before
    phot = lib["photometry"]
    n_batch = int(np.ceil(N_LIBRARY / BATCH))
    log(f"[main] generate(n={N_LIBRARY}) {wall:.3f} s = "
        f"{N_LIBRARY / wall:,.0f} SEDs/s; K1 launches {launches}, SFZH "
        f"kernel launches {sfzh_launches}")
    check(launches == n_batch and sfzh_launches == n_batch,
          f"K1 launched {launches} times and the SFZH kernel "
          f"{sfzh_launches}, expected {n_batch} each")
    check(phot.shape == (len(CODES), N_LIBRARY), f"photometry {phot.shape}")
    check(bool(np.isfinite(phot).all()), "non-finite photometry")
    check(bool((phot >= 0).all()), "negative photometry")
    z = lib["parameters"][PNAMES.index("redshift")]
    check(bool(np.all(np.diff(z) >= 0)), "library rows not sorted by z")
    # the run's first sub-chunk again, through the staged (plain torch) body
    staged = sim.photometry_zsorted_device(
        lib["parameters"][:, :1024].T.copy(), sub_chunk=1024, kc=kc,
        w_cols=w_cols, fused=False)
    med, p99, mx, _ = rel_stats(torch.as_tensor(phot[:, :1024].T), staged)
    log(f"[main] first sub-chunk vs staged body: rel median={med:.3e} "
        f"p99={p99:.3e} max={mx:.3e} (tol p99<{TOL_STAGED_P99} "
        f"max<{TOL_STAGED_MAX})")
    check(p99 < TOL_STAGED_P99 and mx < TOL_STAGED_MAX,
          "main path disagrees with the staged window body")
    return lib, launches, sfzh_launches


def features(tt, lib, dev):
    t0 = time.perf_counter()
    fp = tt.FeaturePipeline(tt.FeatureConfig(
        filter_codes=tuple(CODES), unit="asinh", depths_ab=(29.5,) * 7,
        n_scatters=1, include_errors=True))
    feats = fp.build(torch.Generator(device=dev).manual_seed(0),
                     torch.as_tensor(lib["photometry"].T, device=dev),
                     parameters=lib["parameters"].T)
    log(f"[features] {feats.features.shape} in "
        f"{time.perf_counter() - t0:.2f} s")
    n = lib["photometry"].shape[1]
    check(feats.features.shape == (n, 2 * len(CODES)),
          f"features {feats.features.shape}")
    check(bool(np.isfinite(feats.features).all()), "non-finite features")


def bound(flops_fp32: float, flops_bf16: float, nbytes: float) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate of their type. Also
    "tf32x3_bound_ms": the same with the fp32 first product as three TF32
    products on the tensor cores, a route the kernels do not take, printed
    beside the bound as the ceiling it would have had."""
    t_ops = (flops_fp32 / PEAK_FP32_FLOP_S + flops_bf16 / PEAK_BF16_FLOP_S)
    t_tf32 = 3 * flops_fp32 / PEAK_TF32_FLOP_S + flops_bf16 / PEAK_BF16_FLOP_S
    t_bytes = nbytes / PEAK_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tf32x3_bound_ms": 1e3 * max(t_tf32, t_bytes)}


def exact_gate(k1, tag: str, what: str, out, exact, plain) -> dict:
    """A kernel's output against the exact first product (`exact_gate`:
    p99 < 1e-5, max < 1e-3, and at most twice the fp32 plain version's
    share of fluxes off by more than 1e-5, plus 1e-4); fails the run if it
    misses."""
    g = k1.exact_gate(out, exact, plain)
    log(f"[{tag}] {what} vs the exact first product: p99={g['p99']:.3e} "
        f"max={g['max']:.3e} share>1e-5={g['share']:.3e} (fp32 plain "
        f"{g['share_plain']:.3e}; gate p99<1e-5 max<1e-3 share<="
        f"{2 * g['share_plain'] + 1e-4:.3e})")
    check(g["ok"], f"{what} misses the exact gate")
    return g


def headline_model(tt, dev, variant: str, backend: str = "auto"):
    """bench.py's headline dense model on the card."""
    grid = tt.make_synthetic_grid(n_ages=48, n_mets=8, n_wav=2048,
                                  lam_min=300.0)
    filters = tt.FilterSet([
        tt.tophat_filter(f"F{i}", c, w)
        for i, (c, w) in enumerate(zip(HEADLINE_CENTERS, HEADLINE_WIDTHS))])
    return tt.BatchSEDSimulator(
        grid, filters, PNAMES, sfh="lognormal", zdist="delta",
        emission=tt.EmissionConfig(igm="inoue14"),
        photometry_variant=variant, photometry_backend=backend, device=dev)


def headline_theta(dev, n: int = HEADLINE_BATCH, seed: int = 0):
    """bench.py's unsorted θ draws (numpy, seeded), on the card."""
    rng = np.random.default_rng(seed)
    theta = np.stack([
        rng.uniform(7.5, 11, n), rng.uniform(0.05, 10, n),
        rng.uniform(5e7, 1e9, n), rng.uniform(0.1, 1.2, n),
        rng.uniform(-3.9, -1.5, n), rng.uniform(0, 3, n)], axis=1)
    return torch.as_tensor(theta, dtype=torch.float32, device=dev)


def k2_args(sim, theta) -> dict:
    """K2's arguments for a batch, as `_photometry_mega` passes them, in
    the keyword form of K1's plain version (kc = n_knots, s_rel = s)."""
    em = sim.emission
    params = sim.theta_dict(theta)
    sfzh, _ = sim._sfzh(params)
    z = params["redshift"]
    t = sim._mega_tables
    return dict(sfzh=sfzh, s_rel=sim._shift_of_z(z), tau_v=params["tau_v"],
                scale=sim._scale_of_z(z), sed_w=t["sed"], curve_w=t["curve"],
                knot_w=t["knot"], den_w=t["den"], kc=sim._n_knots,
                delta=sim._knot_delta, f8=sim._f8, order=sim._interp_order,
                fesc=0.0 if em.reprocessed_types else float(em.fesc))


def k2_call(k1, a: dict):
    """K2 through its wrapper, from K1-style keyword arguments."""
    tables = dict(sed=a["sed_w"], curve=a["curve_w"], knot=a["knot_w"],
                  den=a["den_w"])
    if a.get("sed_inc") is not None:
        tables["inc"] = a["sed_inc"]
    return k1.fused_sed_photometry(
        a["sfzh"], a["s_rel"], a["tau_v"], a["scale"], tables, a["kc"],
        a["delta"], a["f8"], order=a["order"], fesc=a["fesc"],
        tau_bc=a.get("tau_bc"), n_young=a.get("n_young", 0),
        fesc_row=a.get("fesc_row"))


def k2_vs_plain(k1, sim, theta, name: str, reps: int,
                tol_p99: float = 0.0, tol_max: float = TOL_KERNEL_MAX):
    """K2 against its plain version on one batch (relative differences:
    p99 < tol_p99 when it is set, max < tol_max), with both times and K2's
    bound (4 knot rows of F8 bands per galaxy)."""
    a = k2_args(sim, theta)
    out = k2_call(k1, a)
    torch.cuda.synchronize()
    ref = k1.fused_window_photometry_reference(**a)
    med, p99, mx, abs_err = rel_stats(out, ref)
    b, c = a["sfzh"].shape
    n_l = a["sed_w"].shape[1]
    log(f"[{name}] B={b} C={c} L_sup={n_l} n_knots={a['kc']} F8={a['f8']} "
        f"delta={a['delta']}: K2 vs plain rel median={med:.3e} "
        f"p99={p99:.3e} max={mx:.3e} (tol "
        f"{f'p99<{tol_p99} ' if tol_p99 else ''}max<{tol_max}); max abs "
        f"err={abs_err:.4e} nJy")
    check(mx < tol_max and (not tol_p99 or p99 < tol_p99),
          f"K2 disagrees with its plain version ({name})")
    exact_gate(k1, name, "K2", out, k1.fused_window_photometry_exact(**a),
               ref)
    check(torch.equal(out, k2_call(k1, a)),
          f"two K2 runs differ ({name})")
    stats = {"max_abs_err": abs_err,
             "ms": time_ms(lambda: k2_call(k1, a), reps=reps),
             "plain_ms": time_ms(
                 lambda: k1.fused_window_photometry_reference(**a),
                 reps=max(3, reps // 4)),
             "first_product_ms": first_product_ms(a["sfzh"], a["sed_w"])}
    stats.update(bound(
        flops_fp32=2.0 * b * c * n_l, flops_bf16=2.0 * b * n_l * 4 * a["f8"],
        nbytes=4 * (b * c + c * n_l + n_l + a["kc"] * a["f8"] + 3 * b
                    + b * a["f8"]) + 2 * n_l * a["kc"] * a["f8"]))
    log(f"[{name}] K2 {stats['ms']:.4f} ms, plain {stats['plain_ms']:.4f} ms"
        f" per batch (CUDA events); bound {stats['bound_ms']:.4f} ms "
        f"({stats['bound_by']}; fp32 FMA, the kernel's arithmetic), share "
        f"{stats['bound_ms'] / stats['ms']:.3f}; a 3xTF32 route's bound "
        f"{stats['tf32x3_bound_ms']:.4f} ms; cuBLAS fp32 first product "
        f"{stats['first_product_ms']:.4f} ms; two runs bitwise equal")
    return stats, a


def route_times(sim, theta, name: str, reps: int) -> tuple:
    """End-to-end ms of `photometry(θ)` (the K2 route) and of the plain
    `_photometry_fused` route on the same batch."""
    def plain_route():
        res = sim._core(theta, False, fused=True)
        return sim._photometry_fused(res["_lnu"], res["_z"])

    ms = time_ms(lambda: sim.photometry(theta), reps=reps)
    plain_ms = time_ms(plain_route, reps=max(3, reps // 4))
    log(f"[{name}] photometry() {ms:.4f} ms = "
        f"{theta.shape[0] / ms * 1e3:,.0f} SEDs/s; plain _photometry_fused "
        f"route {plain_ms:.4f} ms = {theta.shape[0] / plain_ms * 1e3:,.0f} "
        f"SEDs/s")
    return plain_route, ms, plain_ms


def dense_photometry(tt, k1, dev):
    """Phase 6: the dense path at the headline width through K2."""
    sim = headline_model(tt, dev, "auto")
    check(sim.photometry_backend == "pallas" and sim._mega_supported(),
          "the headline model does not take K2")
    theta = headline_theta(dev)
    sim.photometry(theta[:1024])  # warm-up, not counted
    torch.cuda.synchronize()
    k1.fused_sed_photometry.launches = 0
    phot = sim.photometry(theta)
    torch.cuda.synchronize()
    launches = k1.fused_sed_photometry.launches
    log(f"[dense] photometry({theta.shape[0]} unsorted rows): K2 launches "
        f"{launches}")
    check(launches == 1, f"K2 launched {launches} times, expected 1")
    check(tuple(phot.shape) == (theta.shape[0], len(sim.filters)),
          f"photometry {tuple(phot.shape)}")
    check(bool(torch.isfinite(phot).all()), "non-finite dense photometry")
    check(bool((phot >= 0).all()), "negative dense photometry")
    stats, a = k2_vs_plain(k1, sim, theta, "dense", reps=20)
    bound_has_power(k1, a, "K2")
    plain_route, ms, plain_ms = route_times(sim, theta, "dense", reps=20)
    med, p99, mx, _ = rel_stats(phot, plain_route())
    log(f"[dense] photometry() vs plain _photometry_fused route: rel "
        f"median={med:.3e} p99={p99:.3e} max={mx:.3e} (tol "
        f"p99<{TOL_STAGED_P99} max<{TOL_STAGED_MAX})")
    check(p99 < TOL_STAGED_P99 and mx < TOL_STAGED_MAX,
          "dense K2 route disagrees with the plain _photometry_fused route")
    stats["launches"] = launches
    return stats


def k2_north_star(k1, sim, gen, dev):
    """Phase 7: K2 at the north-star width on one unsorted batch. At this
    width cuBLAS sums the plain version's first product in another order
    than K2 (measured median 9.8e-8 on an H100, where the headline width
    gives 0), so bf16 roundings of the knot product's input flip: the bound
    is the staged-body one, p99 < 1e-5 and max < 1e-3."""
    g = torch.Generator(device=dev).manual_seed(7)
    theta = gen.sample_parameters_device(HEADLINE_BATCH, g)
    check(sim._mega_supported(), "the north-star model does not take K2")
    k2_vs_plain(k1, sim, theta, "north-star", reps=10,
                tol_p99=TOL_STAGED_P99, tol_max=TOL_STAGED_MAX)
    log(f"[north-star] K2 row order: {knot_spans(k1, sim, theta)}")
    route_times(sim, theta, "north-star", reps=8)


def knot_spans(k1, sim, theta) -> str:
    """How many knots the 128-row blocks of K2's row order span: the passes
    of 8 knots each block makes."""
    z = theta[:, PNAMES.index("redshift")]
    s = sim._shift_of_z(z)
    rows = k1.k2_row_order(s, sim._n_knots, sim._knot_delta).long()
    c = torch.clamp(s[rows], 0.0, (sim._n_knots - 1) * sim._knot_delta
                    - 1.0e-3) / sim._knot_delta
    first = torch.clamp(torch.floor(c) - 1, min=0)
    n = first.shape[0] // k1.TILE_ROWS * k1.TILE_ROWS
    blocks = first[:n].reshape(-1, k1.TILE_ROWS)
    span = (blocks.max(dim=1).values - blocks.min(dim=1).values).cpu()
    passes = span.div(5, rounding_mode="floor") + 1  # passes start 5 apart
    return (f"first-knot span per block max {int(span.max())}, mean "
            f"{float(span.float().mean()):.2f}; blocks with one pass "
            f"{float((passes == 1).float().mean()):.4f}")


def exact_reference(sim, fnu, z):
    """(B, F) float64 filter integral of f_ν at the true shift (the filter
    curve evaluated at λ_rest·(1+z)), as the JAX package's kernel test."""
    fnu = fnu.double().cpu().numpy()
    lam = sim.grid.lam
    wlam = np.gradient(lam) / lam
    ref = np.zeros((fnu.shape[0], len(sim.filters)))
    for b, zb in enumerate(z.double().cpu().numpy()):
        for f, filt in enumerate(sim.filters.filters):
            t = np.interp(lam * (1.0 + zb), filt.lam, filt.transmission,
                          left=0.0, right=0.0) * wlam
            ref[b, f] = (fnu[b] * t).sum() / max(t.sum(), 1e-30)
    return ref


def k3_bounds(fw, table) -> dict:
    """K3's bound: the flux slab, the table, the shifts and the result
    moved once, against 2·B·F8·L fp32 operations."""
    b, n_l = fw.shape
    f8 = table.shape[1]
    return bound(flops_fp32=2.0 * b * f8 * n_l, flops_bf16=0.0,
                 nbytes=4 * (b * n_l + table.numel() + b + b * f8))


def k3_vs_plain(pk, fw, table, s4, n_f: int, name: str, reps: int = 0):
    """K3 against its plain version on one batch (max relative difference
    < TOL_KERNEL_MAX on fluxes above 1e-3 of the row maximum); with `reps`,
    both times (the kernel's with its key kernel and sort) and the bound."""
    out = pk.shift_photometry_num(fw, table, s4)
    torch.cuda.synchronize()
    ref = pk.shift_photometry_num_reference(fw, table, s4)
    med, p99, mx, abs_err = rel_stats(out[:, :n_f], ref[:, :n_f])
    log(f"[exact] K3 vs plain, {name} (B={fw.shape[0]} L={fw.shape[1]} "
        f"F8={table.shape[1]} table cols={table.shape[2]}, row stride "
        f"{fw.stride(0)}, base % 16 = {fw.data_ptr() % 16}): rel "
        f"median={med:.3e} p99={p99:.3e} max={mx:.3e} (tol "
        f"max<{TOL_KERNEL_MAX}); max abs err={abs_err:.4e}")
    check(mx < TOL_KERNEL_MAX,
          f"K3 disagrees with its plain version ({name})")
    stats = {"max_abs_err": abs_err, "out": out}
    if reps:
        stats["ms"] = time_ms(lambda: pk.shift_photometry_num(fw, table, s4),
                              reps=reps)
        order_ms = time_ms(lambda: pk.shift_row_order(
            s4, fw.shape[1], table.shape[2]), reps=reps)
        stats["plain_ms"] = time_ms(
            lambda: pk.shift_photometry_num_reference(fw, table, s4), reps=5)
        stats.update(k3_bounds(fw, table))
        stats["first_product_ms"] = None  # K3 has no first product
        log(f"[exact] K3, {name}: {stats['ms']:.4f} ms per batch, of which "
            f"the row keys and their sort {order_ms:.4f} ms; plain "
            f"{stats['plain_ms']:.4f} ms (CUDA events); bound "
            f"{stats['bound_ms']:.4f} ms ({stats['bound_by']}), share "
            f"{stats['bound_ms'] / stats['ms']:.3f}")
    return stats


def k3_properties(pk, fw, table, s4, n_f: int) -> None:
    """K3 beyond the headline call: views of the flux, 16 bands, sorted
    rows, the row keys, and the bits of two runs and of a row alone."""
    out = pk.shift_photometry_num(fw, table, s4)
    check(torch.equal(out, pk.shift_photometry_num(fw, table, s4)),
          "two K3 runs differ")
    n_l, n_cols = fw.shape[1], table.shape[2]
    n_m = n_cols - n_l + 1
    check(torch.equal(pk._shift_row_keys(s4, n_m),
                      pk.shift_row_keys_reference(s4, n_m)),
          "K3's row keys differ from their plain version")
    # already sorted rows: the same rows give the same bits in any order
    order, _ = pk.shift_row_order(s4, n_l, n_cols)
    sub = order[::8].contiguous()  # 8192 rows in shift order
    got = k3_vs_plain(pk, fw[sub], table, s4[sub], n_f, "sorted rows")["out"]
    check(torch.equal(got, out[sub]),
          "a K3 row's bits depend on the rest of the batch")
    # a row-sliced view (16-byte copies, row stride 2·L) and a column-sliced
    # one (rows not 16-byte aligned: the 4-byte copies)
    rows = slice(0, 16384, 2)
    got = k3_vs_plain(pk, fw[rows], table, s4[rows].contiguous(), n_f,
                      "row-sliced view")["out"]
    check(torch.equal(got, out[rows]), "K3 differs on a row-sliced view")
    cols = fw[:8192, 1:n_l - 3]  # L − 4 columns from byte 4 of each row
    got = k3_vs_plain(pk, cols, table, s4[:8192], n_f,
                      "column-sliced view")["out"]
    check(torch.equal(got, pk.shift_photometry_num(cols.contiguous(), table,
                                                   s4[:8192])),
          "K3's 4-byte and 16-byte copies give different bits")
    table16 = torch.cat([table, table.flip(1)], dim=1).contiguous()
    got = k3_vs_plain(pk, fw[:8192], table16, s4[:8192], 16,
                      "16 bands")["out"]
    check(torch.equal(got[:, :8], out[:8192]),
          "K3's first band group differs at 16 bands")
    # what a later kernel could skip: flux columns that meet only table
    # columns where every band is zero
    nz = (table != 0).any(dim=1)  # (N_SUB, table columns)
    cols = torch.arange(n_cols, device=table.device)
    lo = torch.where(nz, cols, n_cols).min(dim=1).values
    hi = torch.where(nz, cols + 1, 0).max(dim=1).values
    m, rs = pk._shift_parts(s4, n_l, n_cols)
    met = (torch.clamp(hi[rs] - m, max=n_l)
           - torch.clamp(lo[rs] - m, min=0)).clamp(min=0)
    log(f"[exact] the table's nonzero columns span [{int(lo.min())}, "
        f"{int(hi.max())}) of {n_cols}; {float(met.sum()) / s4.numel() / n_l:.4f}"
        f" of this batch's flux columns meet one (K3 reads them all, as its "
        f"plain version does)")
    log("[exact] K3: two runs bitwise equal; row keys equal their plain "
        "version; sorted, row-sliced, column-sliced and 16-band runs give "
        "each row the same bits")


def k3_wide(pk, sim, dev) -> None:
    """K3 at the north-star grid's width: an rs slab of the table (L +
    max_shift columns of 8 bands) does not fit in a block's shared memory,
    so the kernel stages column bands. Seeded flux, shifts from the
    north-star prior's redshift range."""
    n_l = sim.grid.n_wav
    table = pk.build_subshift_table(sim.filters, sim.grid.lam,
                                    sim._filter_dlog, sim._max_shift, n_l,
                                    dev)
    g = torch.Generator(device=dev).manual_seed(11)
    fw = torch.rand(WIDE_ROWS, n_l, generator=g, device=dev)
    lo, hi = PRIOR["redshift"]
    z = lo + (hi - lo) * torch.rand(WIDE_ROWS, generator=g, device=dev)
    s4 = pk.shift_decompose(sim._shift_of_z(z), sim._max_shift)
    check(table.shape[2] * 32 > 227 * 1024, "the wide slab fits after all")
    st = k3_vs_plain(pk, fw, table, s4, len(sim.filters), "wide shape",
                     reps=10)
    check(torch.equal(st["out"], pk.shift_photometry_num(fw, table, s4)),
          "two K3 runs differ (wide shape)")
    log("[exact] K3 wide shape: two runs bitwise equal")


def exact_spectra(tt, pk, dev, north_star_sim):
    """Phase 8: the exact routes through K3, with spectra."""
    theta = headline_theta(dev, seed=1)
    outs, stats, sims = {}, {}, {}
    for variant in ("roll", "bank"):
        sim = sims[variant] = headline_model(tt, dev, variant)
        sim.simulate(theta[:256], want_spectra=True)  # warm-up, not counted
        torch.cuda.synchronize()
        pk.shift_photometry_num.launches = 0
        outs[variant] = sim.simulate(theta, want_spectra=True)
        torch.cuda.synchronize()
        launches = pk.shift_photometry_num.launches
        log(f"[exact] simulate({theta.shape[0]}, want_spectra=True), "
            f"variant {variant}: K3 launches {launches}")
        check(launches == 1, f"K3 launched {launches} times, expected 1")
        stats["launches"] = stats.get("launches", 0) + launches
        phot = outs[variant]["photometry_njy"]
        check(bool(torch.isfinite(phot).all()) and bool((phot >= 0).all()),
              f"non-finite or negative {variant} photometry")
        for key in ("fnu_njy", "lnu", "lnu_intrinsic", "sfh_mass", "sfzh"):
            check(bool(torch.isfinite(outs[variant][key]).all()),
                  f"non-finite {key}")
    check(all(torch.equal(outs["roll"][k], outs["bank"][k])
              for k in outs["roll"]), "roll and bank outputs differ")
    log("[exact] roll and bank outputs are identical")
    sim = sims["roll"]
    whole_ms = time_ms(lambda: sim.simulate(theta, want_spectra=True), reps=5)
    # K3 on the run's own inputs
    res = outs["roll"]
    z = theta[:, PNAMES.index("redshift")]
    fw = res["fnu_njy"] * sim._wlam
    s4 = pk.shift_decompose(sim._shift_of_z(z), sim._max_shift)
    table = sim._subshift_table
    n_f = len(sim.filters)
    stats.update(k3_vs_plain(pk, fw, table, s4, n_f, "headline batch",
                             reps=20))
    log(f"[exact] simulate({theta.shape[0]}, want_spectra=True), variant "
        f"roll: {whole_ms:.4f} ms per call (CUDA events), of which K3 with "
        f"its row order {stats['ms']:.4f} ms = {stats['ms'] / whole_ms:.3f}")
    k3_properties(pk, fw, table, s4, n_f)
    k3_wide(pk, north_star_sim, dev)
    # 1024 rows of each route against the float64 filter integral
    sim_x = headline_model(tt, dev, "auto", backend="xla")
    rows = slice(0, 1024)
    xla = sim_x.photometry(theta[rows]).cpu().numpy()
    exact = exact_reference(sim, res["fnu_njy"][rows], z[rows])
    scale = np.abs(exact).max(axis=1, keepdims=True)
    for name, got, tol in (("roll", res["photometry_njy"][rows].cpu().numpy(),
                            TOL_EXACT_SNAP), ("xla", xla, TOL_EXACT_LERP)):
        worst = float((np.abs(got - exact) / scale).max())
        log(f"[exact] {name} route vs float64 filter integral, 1024 rows: "
            f"max |Δ|/row max={worst:.3e} (tol {tol})")
        check(worst <= tol, f"the {name} route misses the exact integral")
    return stats


def host_reading(dev) -> str:
    """What the host can do for a launch-bound loop: its CPU, its load, and
    the host-clock time per launch of a one-element kernel (20000 launches
    between two synchronisations)."""
    cpu = {}
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                cpu.setdefault(key.strip(), value.strip())
    model = (f"CPU model {cpu.get('model name', 'not given')!r} at "
             f"{cpu.get('cpu MHz', 'unknown')} MHz")
    one = torch.zeros(1, device=dev)
    for reps in (2000, 20000):  # the first loop warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            one.add_(1.0)
        torch.cuda.synchronize()
        us = 1e6 * (time.perf_counter() - t0) / reps
    return (f"{model}, {os.cpu_count()} cores, load average "
            f"{os.getloadavg()[0]:.2f}; {us:.3f} us per launch of a "
            f"one-element kernel")


def training_parts(flow, theta, x, n_val: int, n_nets: int = N_NETS):
    """One optimiser step and one validation pass over `n_val` rows of an
    `n_nets`-member ensemble of `flow` (the north-star one by default), as
    `train_ensemble` runs them, on freshly initialised members: (step,
    validate, state)."""
    from synference_tpu_torch import train as tr

    dev = flow.device
    cfg = tr.TrainConfig(batch_size=2048, learning_rate=7e-4)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    state = tr._new_state(flow, theta, x, cfg, n_nets, g)
    loss_fn = tr._npe_loss(flow)
    rows = torch.randint(0, theta.shape[0], (n_nets, cfg.batch_size),
                         generator=g, device=dev)

    def step():
        state.train_step(loss_fn, theta[rows], x[rows])

    def validate():
        with torch.no_grad():
            tr._validation_loss(loss_fn, state.params, theta[:n_val],
                                x[:n_val])

    return step, validate, state


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of `fn` between two synchronisations."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def train(tt, lib, dev):
    """Phase 9: the north-star NSF ensemble, TRAIN_EPOCHS epochs on 2^18
    rows."""
    from synference_tpu_torch.train import train_ensemble

    fitter = tt.SBIFitter(
        photometry=lib["photometry"].T[::TRAIN_STRIDE],
        parameters=lib["parameters"].T[::TRAIN_STRIDE],
        parameter_names=lib["parameter_names"],
        filter_codes=lib["filter_codes"], device=dev)
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(CODES), unit="asinh", depths_ab=(29.5,) * 7,
        n_scatters=1, include_errors=True))
    stamps = [time.perf_counter()]

    def stamp(epoch, tr, va):
        stamps.append(time.perf_counter())  # after the epoch's readback
        return False

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fitter.run_single_sbi(
        "nsf", hidden_features=69, num_transforms=15, n_nets=N_NETS,
        train_config=tt.TrainConfig(batch_size=2048, learning_rate=7e-4,
                                    max_epochs=TRAIN_EPOCHS),
        epoch_callback=stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = res.history["steps_per_epoch"]
    epochs = len(res.val_losses)
    # the first epoch carries warm-up (cuBLAS handles, allocator growth)
    per_epoch = np.diff(stamps)
    epoch_ms = 1e3 * float(per_epoch[1:].mean())
    log(f"[train] NSF 69x15 x{N_NETS}, batch 2048, fp32 (TF32 off), "
        f"{fitter.features.shape[0]} rows: {epochs} epochs of {steps} steps "
        f"in {wall:.2f} s with split and init; epochs "
        f"{[round(float(t), 3) for t in per_epoch]} s")
    # the step and the validation pass each alone, on the same flow, rows
    # and validation size, beside what the host can do
    tr_idx = fitter._split["train"]
    n_val = int(len(tr_idx) * tt.TrainConfig().validation_fraction)
    step, validate, _ = training_parts(
        fitter.flow, fitter.feature_params[tr_idx], fitter.features[tr_idx],
        n_val)
    step()
    validate()
    ms_step = host_ms(lambda: [step() for _ in range(20)], 3) / 20
    ms_val = host_ms(validate, 3)
    log(f"[train] one step alone {ms_step:.3f} ms = {1e3 / ms_step:.2f} "
        f"steps/s (host clock, median of 3 runs of 20 steps); one "
        f"validation pass over {n_val} rows {ms_val:.3f} ms; {steps} steps "
        f"+ 1 pass = {steps * ms_step + ms_val:.1f} ms against "
        f"{epoch_ms:.1f} ms per epoch after the first, whose remainder is "
        f"the epoch's shuffle and minibatch gathers")
    log(f"[train] host: {host_reading(dev)}")
    for name, hist in (("train", res.train_losses), ("val", res.val_losses)):
        log(f"[train] {name} loss per epoch (rows) and member: "
            f"{np.round(hist.astype(float), 3).tolist()}")
    check(epochs == TRAIN_EPOCHS, f"{epochs} epochs ran")
    check(bool(np.isfinite(res.train_losses).all()
               and np.isfinite(res.val_losses).all()), "non-finite loss")
    # A member's validation loss at the end of an epoch is one point of a
    # noisy path this early (it moves by ~1 nat between epochs, measured),
    # so each member is held by the best of its later epochs against its
    # first, and by its training loss, an epoch's mean
    check(bool((res.val_losses[1:].min(axis=0) < res.val_losses[0]).all()),
          "a member's validation loss never fell below its first epoch's")
    check(bool((res.train_losses[-1] < res.train_losses[0]).all()),
          "a member's training loss did not fall")
    check(float(res.val_losses[-1].mean()) < float(res.val_losses[0].mean()),
          "the ensemble's mean validation loss did not fall")
    check(bool(np.array_equal(np.float32(res.history["best_val"]),
                              np.float32(res.val_losses.min(axis=0)))),
          "a member's best validation loss is not its path's minimum")
    w = res.params["flow"]["blocks"][0][0]["w"]
    check(w.shape[0] == N_NETS and all(
        not torch.equal(w[0], w[i]) for i in range(1, N_NETS)),
        "ensemble members do not differ")
    check(abs(float(np.std(res.val_losses[-1]))) > 0,
          "every member has the same validation loss")

    # the guard that makes a readback inside an epoch raise is live
    def reads_back(p, tb, xb):
        loss = -fitter.flow.log_prob(p, tb, xb).mean(dim=-1)
        float(loss.detach().sum())  # waits for the card
        return loss

    raised = False
    try:
        train_ensemble(fitter.flow, fitter.feature_params[:4096],
                       fitter.features[:4096],
                       config=tt.TrainConfig(batch_size=1024, max_epochs=1),
                       n_nets=2, loss_fn=reads_back)
    except RuntimeError as e:
        raised = "synchroniz" in str(e)
    check(raised, "a readback inside an epoch did not raise")
    log("[train] no call inside an epoch waited for the card (sync debug "
        "mode \"error\" around every epoch; a loss that reads back raises)")
    return fitter


def posterior(tt, fitter, dev):
    """Phase 10: sampling, calibration metrics, CPU agreement, saved model."""
    per = -(-256 // N_NETS)
    for name, fn, raw in (
            ("evaluate_model(256, max_objects=512)",
             lambda: fitter.evaluate_model(256, max_objects=512),
             N_NETS * 512 * 4 * per),
            ("evaluate_members(128, max_objects=256)",
             lambda: fitter.evaluate_members(128, max_objects=256),
             N_NETS * 256 * 4 * 128)):
        fn()  # warm-up, not timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[posterior] {name}: {dt:.3f} s, {raw} raw draws = "
            f"{raw / dt:,.0f} draws/s with the metric chain")
        if "point" in rep:
            report = rep
        else:
            members = rep
    log(f"[posterior] ensemble after {TRAIN_EPOCHS} epochs (readings): TARP "
        f"{report['tarp_deviation']:.4f}, PIT-KS "
        f"{np.round(report['pit_ks'], 3).tolist()}, R2 "
        f"{np.round(report['point']['r2'], 3).tolist()}, mean log-prob "
        f"{report['mean_log_prob']:.3f}")
    log(f"[posterior] members: TARP {members['tarp_deviation']['mean']} ± "
        f"{members['tarp_deviation']['ci95']} (ci95), R2 mean "
        f"{members['r2']['mean']}")
    check(report["sampling_acceptance_min"] == 1.0
          and members["sampling_acceptance_min"]["mean"] == 1.0,
          "a support-aware flow leaked outside the prior box")
    for v in (report["tarp_deviation"], report["mean_log_prob"],
              *report["pit_ks"], *report["point"]["r2"],
              *members["tarp_deviation"]["per_member"]):
        check(bool(np.isfinite(v)), "non-finite metric")

    idx = fitter._split["test"][:512]
    xs, truths = fitter.features[idx], fitter.feature_params[idx]
    t0 = time.perf_counter()
    draws = fitter.sample_posterior(xs, 256)
    dt = time.perf_counter() - t0
    log(f"[posterior] sample_posterior(512 objects, 256): {dt:.3f} s to the "
        f"host = {512 * 256 / dt:,.0f} kept draws/s")
    lo, hi = fitter.prior.low.cpu().numpy(), fitter.prior.high.cpu().numpy()
    check(draws.shape == (512, 256, len(PNAMES)), f"draws {draws.shape}")
    check(bool(np.isfinite(draws).all() and (draws >= lo).all()
               and (draws <= hi).all()), "a sample lies outside the prior")

    # inverse then forward of the flow proper (standardised, unbounded
    # space) on base normals, in fp32 and fp64; through the box transform
    # as a reading
    flow, params = fitter.flow, fitter.train_result.params
    g = torch.Generator(device=dev).manual_seed(3)
    n_dim = len(PNAMES)
    base = torch.randn((N_NETS, 256, 64, n_dim), generator=g, device=dev)
    flat_base = base.reshape(N_NETS, -1, n_dim)
    with torch.no_grad():
        ctx = flow._context(params, xs[:256]).unsqueeze(2).expand(
            -1, -1, 64, -1).reshape(N_NETS, 256 * 64, -1)

        def round_trip(dtype):
            from synference_tpu_torch.flows.base import tree_map
            net = tree_map(lambda a: a.to(dtype), params["flow"])
            u = flow._net.inverse(net, flat_base.to(dtype), ctx.to(dtype))
            back, _ = flow._net.forward(net, u, ctx.to(dtype))
            return (back - flat_base).abs().flatten()

        err, err64 = round_trip(torch.float32), round_trip(torch.float64)
        theta = flow.sample_batch(params, xs[:256], 64, base=base)
        x_rep = torch.as_tensor(xs[:256], device=dev).repeat_interleave(
            64, dim=0)
        err_box = (flow.to_base(params, theta.reshape(N_NETS, -1, n_dim),
                                x_rep) - flat_base).abs()
    p999 = float(err.kthvalue(int(0.999 * err.numel())).values)
    log(f"[posterior] inverse then forward on {flat_base.numel() // n_dim} "
        f"base normals: fp64 max |Δ| {float(err64.max()):.3e}, fp32 p99.9 "
        f"{p999:.3e} (both tol {TOL_FLOW}), fp32 max {float(err.max()):.3e};"
        f" through the prior-box transform too: max "
        f"{float(err_box.max()):.3e}, median {float(err_box.median()):.3e} "
        f"(readings: the logit loses bits near the box faces)")
    check(float(err64.max()) < TOL_FLOW and p999 < TOL_FLOW,
          "the flow's inverse then forward misses the base normals")

    # the ensemble's log_prob on the card against the CPU
    cpu = torch.device("cpu")
    from synference_tpu_torch.flows.base import (ConditionalFlow,
                                                 params_from_numpy,
                                                 params_to_numpy)
    post_cpu = tt.EnsemblePosterior(
        ConditionalFlow.from_spec(flow.spec(), cpu),
        params_from_numpy(params_to_numpy(params), cpu),
        tt.BoxUniform.from_dict(fitter.prior.to_dict(), cpu))
    with torch.no_grad():
        lp = fitter.posterior.log_prob(truths[:256], xs[:256])
        lp_cpu = post_cpu.log_prob(truths[:256], xs[:256])
    check(bool(torch.isfinite(lp).all()), "non-finite log_prob of a truth")
    d = float((lp.cpu() - lp_cpu).abs().max())
    log(f"[posterior] ensemble log_prob, card vs CPU, 256 objects: max |Δ| "
        f"{d:.3e} (tol {TOL_FLOW})")
    check(d < TOL_FLOW, "log_prob on the card disagrees with the CPU")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.pkl")
        fitter.save_state(path)
        size = os.path.getsize(path)
        loaded = tt.SBIFitter.load_saved_model(path, device=dev)
    with torch.no_grad():
        same = torch.equal(loaded.posterior.log_prob(truths[:256], xs[:256]),
                           lp)
    log(f"[posterior] save_state ({size} bytes) -> load_saved_model: "
        f"log_prob bitwise equal: {same}")
    check(same, "a saved and reloaded model gives another log_prob")
    flux = fitter.photometry[:8]
    feats = loaded.features_from_observations(flux, 0.1 * np.abs(flux) + 1.0)
    check(feats.shape == (8, xs.shape[1]) and bool(np.isfinite(feats).all()),
          "features_from_observations of the loaded model")


SUPP = ("m_uv", "sfr_100", "mass_weighted_age", "t50")
SUPP_MAGS = ("m_uv",)
# the CPU tests' end-to-end bounds for supplementary quantities of one θ on
# two devices (tests/test_torch_supplementary.py): medians 1e-4 relative
# (1e-4 mag), 95th percentiles 2e-3 relative (5e-3 mag)
TOL_SUPP_MED, TOL_SUPP_P95, TOL_SUPP_MAG_P95 = 1e-4, 2e-3, 5e-3
# features on the card against the CPU with the same masks: float32
# rounding, 1e-6 relative, 1e-5 mag absolute (tests/test_torch_features.py)
TOL_FEAT_REL, TOL_FEAT_ABS = 1e-6, 1e-5
CATALOGUE_ROWS, GARBAGE_ROWS = 1024, 16
OOD_NATIVE = ("mahalanobis", "ecod", "hbos", "knn", "pca")


class Interrupt(Exception):
    """Raised on purpose inside a generation run to test its resume."""


def host_lhc(n: int, seed: int) -> np.ndarray:
    """(n, P) θ of the host sampler recomputed with numpy and scipy alone:
    scipy's Latin hypercube below 10^5 rows, mapped onto PRIOR, the peak age
    un-logged, in PNAMES order."""
    from scipy.stats import qmc

    u = qmc.LatinHypercube(d=len(PRIOR),
                           rng=np.random.default_rng(seed)).random(n)
    cols = {}
    for i, (key, (lo, hi)) in enumerate(PRIOR.items()):
        vals = (lo + (hi - lo) * u[:, i]).astype(np.float32)
        if key == "log10_peak_age":
            key, vals = "peak_age", (10.0**vals).astype(np.float32)
        cols[key] = vals
    return np.stack([cols[p] for p in PNAMES], axis=1)


def supp_stats(got, ref, name):
    """(median, p95) of |Δ| (magnitudes) or |Δ|/|ref| (the rest)."""
    d = np.abs(got - ref)
    if name not in SUPP_MAGS:
        d = d / np.maximum(np.abs(ref), 1e-30)
    return float(np.median(d)), float(np.quantile(d, 0.95))


def library_file(tt, dev):
    """Phase 11: a host-sampler library with supplementary quantities on
    the headline model, and its HDF5 round trip."""
    import importlib.util

    sim = headline_model(tt, dev, "auto")
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              supplementary=SUPP, device=dev)
    gen.generate(4096, seed=1, device_sampling=False)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib = gen.generate(HEADLINE_BATCH, seed=0, device_sampling=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[library] generate({HEADLINE_BATCH}, supplementary={SUPP}) on "
        f"the host sampler: {wall:.3f} s = {HEADLINE_BATCH / wall:,.0f} "
        f"SEDs/s (one batch of {HEADLINE_BATCH}: dense simulate with "
        f"spectra, then the supplementary quantities)")
    theta = lib["parameters"].T
    check(np.array_equal(theta, host_lhc(HEADLINE_BATCH, 0)),
          "host-sampler θ differs from the numpy recomputation")
    log("[library] θ equals the numpy/scipy recomputation bit for bit")
    supp = lib["supplementary_parameters"]
    check(supp.shape == (len(SUPP), HEADLINE_BATCH)
          and bool(np.isfinite(supp).all()), "supplementary columns")
    cpu = headline_model(tt, "cpu", "auto")
    rows = torch.as_tensor(theta[:256])
    ref = tt.compute_supplementary(SUPP, cpu, rows, cpu.simulate(
        rows, want_spectra=True)).numpy().T
    for j, name in enumerate(SUPP):
        med, p95 = supp_stats(supp[j, :256], ref[j], name)
        tol95 = TOL_SUPP_MAG_P95 if name in SUPP_MAGS else TOL_SUPP_P95
        log(f"[library] {name}: card vs CPU on 256 rows, median {med:.3e} "
            f"p95 {p95:.3e} ({'mag' if name in SUPP_MAGS else 'relative'};"
            f" tol {TOL_SUPP_MED}, {tol95})")
        check(med < TOL_SUPP_MED and p95 < tol95,
              f"supplementary {name} disagrees with the CPU")
    if importlib.util.find_spec("h5py") is None:
        log("[library] h5py is not installed on this machine: the HDF5 "
            "round trip did not run here (the CPU tests hold it)")
        return
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "library.h5")
        written = gen.generate(HEADLINE_BATCH, seed=0, device_sampling=False,
                               out_path=path)
        fitter = tt.SBIFitter.init_from_hdf5(path, device=dev)
        back = tt.simulator_from_library(path, grid=sim.grid, device=dev)
    check(np.array_equal(written["photometry"], lib["photometry"])
          and np.array_equal(fitter.parameters, theta)
          and np.array_equal(fitter.supplementary, supp.T)
          and fitter.supplementary_names == list(SUPP),
          "HDF5 round trip of the library")
    check(torch.equal(back.photometry(rows.to(dev)),
                      sim.photometry(rows.to(dev))),
          "simulator_from_library photometry")
    log("[library] save -> init_from_hdf5 -> simulator_from_library: the "
        "same arrays and the same photometry bits")


def auto_and_resume(tt, sim, gen, k1, lib4):
    """Phase 12: generate at the defaults on the north-star library, and
    chunk resume."""
    n_batch = int(np.ceil(N_LIBRARY / BATCH))
    with tempfile.TemporaryDirectory() as tmp:
        k1.fused_window_photometry.launches = 0
        t0 = time.perf_counter()
        lib = gen.generate(n=N_LIBRARY, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1.fused_window_photometry.launches
        log(f"[auto] generate(n={N_LIBRARY}) at the defaults {wall:.3f} s, "
            f"K1 launches {launches}")
        check(launches == n_batch, f"K1 launched {launches} times, not "
              f"once for each of {n_batch} batches")
        check(all(np.array_equal(lib[k], lib4[k])
                  for k in ("parameters", "photometry")),
              "generate at the defaults differs from phase 4's bits")
        log("[auto] θ and photometry equal phase 4's bits")
        k1.fused_window_photometry.launches = 0
        gen.generate(n=2 * BATCH, seed=7)
        torch.cuda.synchronize()
        check(k1.fused_window_photometry.launches == 2,
              f"a 2-batch run at the defaults launched K1 "
              f"{k1.fused_window_photometry.launches} times")
        log("[auto] a 2-batch run at the defaults: K1 launches 2")

        args = dict(n=4 * BATCH, seed=5)
        whole = gen.generate(**args)
        prefix = os.path.join(tmp, "resume")
        calls = [0]

        def interrupted(*a, **kw):
            calls[0] += 1
            if calls[0] == 3:
                raise Interrupt
            return type(sim).photometry_zsorted_device(sim, *a, **kw)

        sim.photometry_zsorted_device = interrupted
        try:
            gen.generate(resume_path=prefix, **args)
            check(False, "the interrupted run was not interrupted")
        except Interrupt:
            pass
        finally:
            del sim.photometry_zsorted_device
        files = sorted(f for f in os.listdir(tmp) if f.startswith("resume"))
        check(len(files) == 2, f"chunk files after batch 2: {files}")
        resumed = gen.generate(resume_path=prefix, **args)
        check(all(np.array_equal(resumed[k], whole[k])
                  for k in ("parameters", "photometry")),
              "the resumed run differs from the uninterrupted one")
        check(not any(f.startswith("resume") for f in os.listdir(tmp)),
              "chunk files left after the run")
        log("[auto] a 4-batch run interrupted after batch 2 resumed from "
            f"{len(files)} chunk files to the uninterrupted run's bits")
    return launches


def features_on_card(tt, lib, dev):
    """Phase 13: the rest of the feature configuration on the card."""
    cfg = tt.FeatureConfig(
        filter_codes=tuple(CODES), unit="asinh",
        normalize_method=CODES[4], missing_fraction=0.1, include_flags=True,
        extra_features=("F115W - F200W",))
    phot = torch.as_tensor(lib["photometry"].T, device=dev)
    pipe = tt.FeaturePipeline(cfg)
    gen = torch.Generator(device=dev).manual_seed(13)
    pipe.build(gen, phot[:4096])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.build(gen, phot, parameters=lib["parameters"].T,
                     parameter_names=PNAMES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = phot.shape[0]
    flags = res.features[:, 6:12]
    log(f"[features] normalised by {CODES[4]}, missing_fraction=0.1 with "
        f"flags, one colour: {res.features.shape} in {dt:.3f} s; missing "
        f"share {flags.mean():.4f}; columns {res.feature_names}")
    check(res.features.shape == (n, 14) and bool(
        np.isfinite(res.features).all()), "features on the card")
    check(abs(float(flags.mean()) - 0.1) < 0.005, "missing share")
    rows = 4096
    ref = tt.FeaturePipeline(cfg).build(
        torch.Generator().manual_seed(0), lib["photometry"].T[:rows],
        missing_mask=flags[:rows]).features
    got = res.features[:rows]
    err = np.abs(got - ref)
    log(f"[features] card vs CPU on {rows} rows with the card's mask: max "
        f"|Δ| {err.max():.3e} (tol {TOL_FEAT_ABS} absolute or "
        f"{TOL_FEAT_REL} relative)")
    check(bool((err <= TOL_FEAT_ABS + TOL_FEAT_REL * np.abs(ref)).all()),
          "features on the card disagree with the CPU")
    flux = lib["photometry"].T[:1024] * 1.05
    mask = (np.random.default_rng(13).uniform(size=flux.shape) < 0.1
            ).astype(np.float32)
    outs = [pipe.transform_observations(flux, None, missing_mask=mask,
                                        device=d) for d in (dev, "cpu")]
    err = np.abs(outs[0] - outs[1])
    log(f"[features] transform_observations(missing_mask) on 1024 rows, "
        f"card vs CPU: max |Δ| {err.max():.3e}")
    check(outs[0].shape == (1024, 14) and bool(
        (err <= TOL_FEAT_ABS + TOL_FEAT_REL * np.abs(outs[1])).all()),
        "transform_observations on the card disagrees with the CPU")


def catalogue(tt, fitter, sim, k1, dev):
    """Phase 14: catalogue fitting on phase 9's fitter."""
    from synference_tpu_torch.catalogue import MissingPhotometryHandler

    rng = np.random.default_rng(14)
    sigma = tt.DepthNoiseModel(29.5).sigma_njy
    idx = rng.choice(fitter.photometry.shape[0], CATALOGUE_ROWS,
                     replace=False)
    clean = fitter.photometry[idx]
    flux = (clean + sigma * rng.standard_normal(clean.shape)).astype(
        np.float32)
    garbage = (rng.uniform(1e5, 1e7, (GARBAGE_ROWS, len(CODES)))
               * rng.choice([-1.0, 1.0], (GARBAGE_ROWS, len(CODES))))
    flux = np.concatenate([flux, garbage.astype(np.float32)])
    err = np.full_like(flux, sigma)
    m = flux.shape[0]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def ordered(out):
        for name in fitter.parameter_names:
            q = [out[f"{name}_q{p}"] for p in (16, 50, 84)]
            check(all(bool(np.isfinite(c).all()) for c in q)
                  and bool((q[0] <= q[1]).all() and (q[1] <= q[2]).all()),
                  f"quantile columns of {name}")

    k1.fused_sed_photometry.launches = 0
    out, dt = timed(lambda: tt.fit_catalogue(
        fitter, flux, err, n_samples=256, ood_methods=OOD_NATIVE,
        simulator=sim))
    launches = k1.fused_sed_photometry.launches
    want = -(-m * 64 // 16384)
    log(f"[catalogue] fit_catalogue({m} objects: {CATALOGUE_ROWS} noised "
        f"library rows + {GARBAGE_ROWS} garbage; OOD {OOD_NATIVE} over "
        f"{fitter.features.shape[0]} training rows; 256 draws; reconstructed "
        f"photometry of 64 draws each): {dt:.3f} s = "
        f"{1e3 * dt / m:.3f} s per 1000 objects; K2 launches {launches}")
    check(launches == want, f"K2 launched {launches} times, expected {want}")
    ordered(out)
    flagged = out["flag_ood"]
    log(f"[catalogue] OOD: {int(flagged[:CATALOGUE_ROWS].sum())} of "
        f"{CATALOGUE_ROWS} library rows and {int(flagged[-GARBAGE_ROWS:].sum())}"
        f" of {GARBAGE_ROWS} garbage rows flagged; votes of the garbage "
        f"{out['ood_votes'][-GARBAGE_ROWS:].tolist()}")
    check(bool(flagged[-GARBAGE_ROWS:].all()), "a garbage row was not flagged")
    recon = out["_recon_photometry"][:CATALOGUE_ROWS]
    check(bool(np.isfinite(recon).all()), "reconstructed photometry")
    z = fitter.parameter_names.index("redshift")
    truth = fitter.parameters[idx][:, z]
    r = float(np.corrcoef(out["redshift_q50"][:CATALOGUE_ROWS], truth)[0, 1])
    log(f"[catalogue] redshift median vs truth on the library rows: r "
        f"{r:.3f} (a reading: {TRAIN_EPOCHS} epochs)")

    seds, dt = timed(lambda: tt.fit_catalogue(
        fitter, flux[:64], err[:64], n_samples=256, check_ood=False,
        simulator=sim, recover_seds=True))
    q = seds["_recovered_seds"]["fnu_quantiles"]
    log(f"[catalogue] recover_seds=True on 64 objects (32 draws each, "
        f"{q.shape[-1]} λ): {dt:.3f} s = {1e3 * dt / 64:.3f} s per 1000 "
        f"objects")
    check(q.shape == (64, 3, sim.grid.n_wav) and bool(np.isfinite(q).all())
          and bool((q[:, 0] <= q[:, 1]).all() and (q[:, 1] <= q[:, 2]).all()),
          "recovered SED bands")

    n_miss = 256
    mask = np.zeros((n_miss, len(CODES)), np.float32)
    for i in range(n_miss):
        mask[i, rng.choice(len(CODES), 2, replace=False)] = 1.0
    handler = MissingPhotometryHandler(fitter.photometry, k_neighbors=64,
                                       nmc=16, device=dev)
    miss, dt = timed(lambda: tt.fit_catalogue(
        fitter, np.where(mask == 1.0, np.nan, flux[:n_miss]), err[:n_miss],
        missing_mask=mask, n_samples=256, check_ood=False,
        missing_data_handler=handler))
    log(f"[catalogue] {n_miss} objects with two bands masked, imputed over "
        f"{fitter.photometry.shape[0]} library rows (k 64, nmc 16): "
        f"{dt:.3f} s = {1e3 * dt / n_miss:.3f} s per 1000 objects")
    ordered(miss)
    check(bool((miss["n_missing"] == 2).all()), "missing-band counts")
    return launches


# -- phases 15-18: the forward model's families and the spectral front end --
# Phase 15's family models: delayed-τ SFH (τ in years) with a normal
# metallicity distribution, and the lognormal main-path model with 100 star
# particles per galaxy.
FAMILY_PNAMES = ("log10_mass", "redshift", "tau", "log10_metallicity",
                 "tau_v")
FAMILY_PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
                "tau": (5e7, 3e9), "log10_metallicity": (-3.9, -1.6),
                "tau_v": (0.0, 2.0)}
FAMILY_ROWS = 2**18
N_PARTICLES = 100
# conv against interp at the paper-63 width: the JAX package's own bound
# (tests/test_pallas_kernel.py), on bands above 1e-2 of the row maximum
TOL_CONV_MED, TOL_CONV_P99 = 2e-3, 2e-2
# the spectral pipeline, card against CPU on the same f_ν: max relative on
# values above 1e-3 of the row maximum (the appended log10 norm absolute)
TOL_PIPE = 1e-5
# line quantities, card against CPU from the same θ (relative). A burst's
# bin masses are Φ((x − x_b)/σ) differences with x = max_age − t: float32
# subtracts ~1e9-1e10 yr to reach ~1e6 yr, so one ulp of max_age (512-1024
# yr, and the two devices' age tables differ by about that) moves them by
# ~5e-4 of σ (measured 5.25e-4 on an H100; JAX against the port on the CPU
# 1.5e-4)
TOL_LINES = 2e-3
SPEC_N = 30_000
SPEC_EPOCHS = 3
NOISE_CATALOGUE = 100_000


def family_models(tt, sim):
    """Phase 15's two north-star models on phase 1's grid and bands."""
    em = tt.EmissionConfig(reprocessed_types=("total",))
    fam = tt.BatchSEDSimulator(sim.grid, sim.filters, FAMILY_PNAMES,
                               sfh="delayed_tau", zdist="normal", emission=em,
                               device=sim.device)
    part = tt.BatchSEDSimulator(sim.grid, sim.filters, PNAMES,
                                sfh="lognormal", zdist="delta", emission=em,
                                n_particles=N_PARTICLES, particle_seed=3,
                                device=sim.device)
    return ((fam, tt.LibraryGenerator(fam, FAMILY_PRIOR, device=sim.device)),
            (part, tt.LibraryGenerator(part, PRIOR,
                                       unlog_keys=["log10_peak_age"],
                                       device=sim.device)))


def families_and_particles(tt, k1, sim, dev):
    """Phase 15: the new SFZH inputs through K1 (a 2¹⁸-row library each) and
    K2 (65536 unsorted headline rows each), each held to its plain version;
    one sub-chunk against the staged body; the particle realization bitwise
    equal across two batchings. Returns {kernel: launches in this phase}."""
    launches = {"K1": 0, "K2": 0}
    models = family_models(tt, sim)
    for name, (fsim, fgen) in zip(("delayed_tau+normal", "particles"),
                                  models):
        fgen.generate(n=BATCH, seed=1, zsorted_fused=True)  # warm-up
        torch.cuda.synchronize()
        k1.fused_window_photometry.launches = 0
        t0 = time.perf_counter()
        lib = fgen.generate(n=FAMILY_ROWS, seed=0, zsorted_fused=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_k1 = k1.fused_window_photometry.launches
        launches["K1"] += n_k1
        phot = lib["photometry"]
        log(f"[families] {name}: generate({FAMILY_ROWS}) {wall:.3f} s = "
            f"{FAMILY_ROWS / wall:,.0f} SEDs/s; K1 launches {n_k1}")
        check(n_k1 == FAMILY_ROWS // BATCH,
              f"K1 launched {n_k1} times for {name}")
        check(bool(np.isfinite(phot).all()) and bool((phot >= 0).all()),
              f"{name} photometry not finite and non-negative")
        theta, sub, bs, kc, w_cols, _ = fgen._draw_sorted(FAMILY_ROWS,
                                                          BATCH, seed=0)
        mid = (theta.shape[0] // bs // 2) * bs
        chunk, sub, kc, w_cols, k0, l0 = fsim._plan_windows(
            theta[mid:mid + bs], sub, kc, w_cols)
        g = fsim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0,
                                      row_offset=mid)
        if name == "particles":
            c = g["sfzh"].shape[1]
            zeros = float((g["sfzh"] == 0).float().mean())
            log(f"[families] particle SFZH rows: {zeros:.3f} of the {c} "
                f"cells empty (at most {N_PARTICLES} filled)")
        out = k1.fused_window_photometry_grouped(**g)
        torch.cuda.synchronize()
        ref = k1.fused_window_photometry_grouped_reference(**g)
        med, p99, mx, abs_err = rel_stats(out, ref)
        ms = time_ms(lambda: k1.fused_window_photometry_grouped(**g), reps=5)
        log(f"[families] {name}: K1 vs plain on one batch: rel median="
            f"{med:.3e} p99={p99:.3e} max={mx:.3e} (tol max<"
            f"{TOL_KERNEL_MAX}); max abs err={abs_err:.4e} nJy; K1 {ms:.4f} "
            f"ms per batch")
        check(mx < TOL_KERNEL_MAX, f"K1 disagrees with its plain version "
              f"on the {name} SFZHs")
        rows = lib["parameters"][:, :1024].T.copy()
        staged = fsim.photometry_zsorted_device(rows, sub_chunk=1024, kc=kc,
                                                w_cols=w_cols, fused=False)
        med, p99, mx, _ = rel_stats(torch.as_tensor(phot[:, :1024].T),
                                    staged)
        log(f"[families] {name}: first sub-chunk vs staged body: rel "
            f"median={med:.3e} p99={p99:.3e} max={mx:.3e}")
        check(p99 < TOL_STAGED_P99 and mx < TOL_STAGED_MAX,
              f"{name} library disagrees with the staged window body")
    # the particle realization is a function of (seed, row index, θ) alone
    psim = models[1][0]
    theta = headline_theta(dev, n=8192, seed=5)
    whole, _ = psim._sfzh(psim.theta_dict(theta, row_offset=1000))
    parts = torch.cat([psim._sfzh(psim.theta_dict(
        theta[i:i + 3000], row_offset=1000 + i))[0]
        for i in range(0, 8192, 3000)])
    check(torch.equal(whole, parts),
          "particle SFZHs differ between batchings")
    log("[families] particle SFZHs of 8192 rows: one batch and batches of "
        "3000 bitwise equal")
    # K2 on unsorted headline rows with the same families
    head = headline_model(tt, dev, "auto")
    for name, kw, names in (
            ("delayed_tau+normal", dict(sfh="delayed_tau", zdist="normal"),
             FAMILY_PNAMES),
            ("particles", dict(sfh="lognormal", zdist="delta",
                               n_particles=N_PARTICLES), PNAMES)):
        hsim = tt.BatchSEDSimulator(head.grid, head.filters, names,
                                    emission=head.emission, device=dev, **kw)
        theta = headline_theta(dev)
        if names is FAMILY_PNAMES:  # τ in years for delayed-τ
            theta = torch.stack([theta[:, 0], theta[:, 1],
                                 1e8 + 2e9 * theta[:, 3], theta[:, 4],
                                 theta[:, 5]], dim=1)
        check(hsim._mega_supported(), f"the {name} headline model skips K2")
        k1.fused_sed_photometry.launches = 0
        phot = hsim.photometry(theta)
        torch.cuda.synchronize()
        n_k2 = k1.fused_sed_photometry.launches
        launches["K2"] += n_k2
        check(n_k2 == 1 and bool(torch.isfinite(phot).all()),
              f"K2 on the {name} headline rows")
        k2_vs_plain(k1, hsim, theta, f"families {name}", reps=5)
    return launches


def paper63(tt, k1, pk, sim, dev):
    """Phase 16: the paper-63 width (phase 1's grid, all 63 survey bands):
    "auto" picks interp; interp's `photometry()` (K2) and fused window
    engine (K1) answer one 65536-row batch each, counted from 0; conv
    answers it through `photometry()` and the window engine, within the JAX
    package's conv/interp bound; each route's time; K1 and K2 alone
    (`paper63_bounds`). Returns {"counts": (K1, K2, K3) launches of the
    driven path, "K1": stats, "K2": stats}."""
    filters = tt.load_instrument_filters()
    t0 = time.perf_counter()
    auto = tt.BatchSEDSimulator(sim.grid, filters, PNAMES, sfh="lognormal",
                                zdist="delta", emission=sim.emission,
                                device=dev)
    torch.cuda.synchronize()
    knot_mib = auto._knot_matrix.numel() * 4 / 2**20
    log(f"[paper63] {len(filters)} bands, F8 {auto._f8}: \"auto\" built in "
        f"{time.perf_counter() - t0:.1f} s, variant {auto._variant}, knot "
        f"matrix {knot_mib:.0f} MiB (the JAX package switches to conv above "
        f"64 MiB)")
    check(auto._variant == "interp" and knot_mib > 64,
          "\"auto\" at the paper-63 width")
    t0 = time.perf_counter()
    conv = tt.BatchSEDSimulator(sim.grid, filters, PNAMES, sfh="lognormal",
                                zdist="delta", emission=sim.emission,
                                photometry_variant="conv", device=dev)
    torch.cuda.synchronize()
    log(f"[paper63] conv built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(16)
    gen = tt.LibraryGenerator(auto, PRIOR, unlog_keys=["log10_peak_age"],
                              device=dev)
    theta = gen.sample_parameters_device(HEADLINE_BATCH, g)
    z = theta[:, PNAMES.index("redshift")]
    sorted_theta = theta[torch.sort(z, stable=True).indices]
    _zero_counts(k1, pk)
    interp = auto.photometry(theta)
    auto.photometry_zsorted_device(sorted_theta, sub_chunk=1024, fused=True)
    torch.cuda.synchronize()
    counts = _counts(k1, pk)
    log(f"[paper63] interp photometry() and fused window engine: launches "
        f"(K1, K2, K3) {counts}")
    check(counts == (1, 1, 0), f"the paper-63 path launched {counts}, "
          "expected one K1 and one K2")
    dense = conv.photometry(theta)
    window = conv.photometry_zsorted_device(sorted_theta, sub_chunk=1024)
    torch.cuda.synchronize()
    for name, out, ref in (("conv photometry()", dense, interp),
                           ("conv window engine",
                            window, auto.photometry(sorted_theta))):
        out_np, ref_np = out.cpu().numpy(), ref.cpu().numpy()
        check(bool(np.isfinite(out_np).all()), f"{name} not finite")
        scale = np.abs(ref_np).max(axis=1, keepdims=True)
        rel = np.abs(out_np - ref_np) / np.maximum(np.abs(ref_np),
                                                   1e-3 * scale)
        rel = rel[np.abs(ref_np) > 1e-2 * scale]
        med, p99 = float(np.median(rel)), float(np.quantile(rel, 0.99))
        log(f"[paper63] {name} vs interp (K2): rel median={med:.3e} "
            f"p99={p99:.3e} (tol median<{TOL_CONV_MED} p99<{TOL_CONV_P99})")
        check(med < TOL_CONV_MED and p99 < TOL_CONV_P99,
              f"{name} disagrees with interp")
    times = {
        "interp photometry() (K2)": time_ms(lambda: auto.photometry(theta),
                                            reps=5),
        "conv photometry()": time_ms(lambda: conv.photometry(theta), reps=3,
                                     warmup=1),
        "conv window engine (staged)": time_ms(
            lambda: conv.photometry_zsorted_device(sorted_theta,
                                                   sub_chunk=1024),
            reps=3, warmup=1),
        "interp window engine (K1)": time_ms(
            lambda: auto.photometry_zsorted_device(sorted_theta,
                                                   sub_chunk=1024,
                                                   fused=True), reps=5)}
    for name, ms in times.items():
        log(f"[paper63] {name}: {ms:.3f} ms per {HEADLINE_BATCH} rows = "
            f"{HEADLINE_BATCH / ms * 1e3:,.0f} SEDs/s (CUDA events)")
    return dict(paper63_bounds(k1, auto, theta, sorted_theta),
                counts=counts)


def spectral_path(tt, dev):
    """Phase 17: the spectroscopic twin's path at its width: a library of
    spectra through the instrument pipeline, raw-spectra features with a
    SpectralNoiseModel, an embedding NSF for 3 epochs and its evaluation;
    the pipeline card against CPU on 256 spectra."""
    grid = tt.make_synthetic_grid(n_ages=48, n_mets=8, n_wav=2048)
    sims = {}
    for d in (dev, "cpu"):
        s = tt.BatchSEDSimulator(
            grid, tt.FilterSet([tt.tophat_filter("F200W", 20000.0, 4600.0)]),
            PNAMES, sfh="lognormal", zdist="delta",
            emission=tt.EmissionConfig(), device=d)
        obs = tt.generate_constant_r_grid(100, 6000.0, 53000.0)
        pipe = tt.SpectralFeaturePipeline(grid.lam, obs, instrument_r=100.0,
                                          norm_window=(20000.0, 30000.0),
                                          device=d)
        sims[str(d)] = (s, pipe)
    sim, pipe = sims[str(dev)]
    prior = {"log10_mass": (8.0, 11.0), "redshift": (0.5, 6.0),
             "log10_peak_age": (7.8, 9.2), "tau": (0.1, 1.0),
             "log10_metallicity": (-3.5, -1.8), "tau_v": (0.0, 1.5)}
    gen = tt.LibraryGenerator(sim, prior, unlog_keys=["log10_peak_age"],
                              spectral_pipeline=pipe, device=dev)
    gen.generate(8192, batch_size=8192, want_spectra=True, seed=1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lib = gen.generate(SPEC_N, batch_size=8192, want_spectra=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_pix = len(obs)
    log(f"[spectra] generate({SPEC_N}, want_spectra, R=100 pipeline): "
        f"{wall:.3f} s = {SPEC_N / wall:,.0f} spectra/s; {n_pix} pixels + "
        f"the norm")
    check(lib["spectra"].shape == (n_pix + 1, SPEC_N)
          and bool(np.isfinite(lib["spectra"]).all()), "library spectra")
    # the pipeline, card against CPU on the same f_ν
    theta = lib["parameters"][:, :256].T.copy()
    fnu = sim.simulate(theta, want_spectra=True)["fnu_njy"]
    z = torch.as_tensor(theta[:, 1])
    card = pipe(fnu, z.to(dev)).cpu().numpy()
    ref = sims["cpu"][1](fnu.cpu(), z).numpy()
    norm_err = float(np.abs(card[:, -1] - ref[:, -1]).max())
    card, ref = card[:, :-1], ref[:, :-1]
    sig = ref > 1e-3 * ref.max(axis=1, keepdims=True)
    rel = float((np.abs(card - ref) / np.abs(ref))[sig].max())
    log(f"[spectra] pipeline card vs CPU on 256 spectra: max rel {rel:.3e} "
        f"(tol {TOL_PIPE}), log10 norm max |Δ| {norm_err:.3e}")
    check(rel < TOL_PIPE and norm_err < TOL_PIPE, "pipeline card vs CPU")
    fitter = tt.SBIFitter.from_library(lib, name="spectra", device=dev)
    t0 = time.perf_counter()
    spec = fitter.spectra[:, :n_pix]
    feats = fitter.create_feature_array_from_raw_spectra(
        noise_model=tt.SpectralNoiseModel(0.02 * np.median(spec, axis=0)),
        crop=(0, n_pix), normalize=("bandpass", 20000.0, 30000.0))
    torch.cuda.synchronize()
    log(f"[spectra] raw-spectra features {feats.shape} in "
        f"{time.perf_counter() - t0:.3f} s")
    check(feats.shape[1] == n_pix + 1 and feats.shape[0] > 0.99 * SPEC_N,
          "raw-spectra features")
    t0 = time.perf_counter()
    res = fitter.run_single_sbi(
        "nsf", hidden_features=64, num_transforms=8, embedding_dim=32,
        embedding_hidden=128,
        train_config=tt.TrainConfig(max_epochs=SPEC_EPOCHS, batch_size=512,
                                    stop_after_epochs=5))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    val = np.asarray(res.val_losses)
    log(f"[spectra] embedding NSF 64 x 8 (embedding 32, hidden 128): "
        f"{len(val)} epochs in {train_s:.1f} s; validation losses "
        f"{np.round(val.ravel(), 3).tolist()}")
    check(bool(np.isfinite(val).all()) and len(val) == SPEC_EPOCHS,
          "embedding NSF training")
    t0 = time.perf_counter()
    report = fitter.evaluate_model(n_samples=128, max_objects=512)
    torch.cuda.synchronize()
    log(f"[spectra] evaluation (128 draws, 512 objects) "
        f"{time.perf_counter() - t0:.2f} s: TARP "
        f"{report['tarp_deviation']:.4g}, PIT-KS max "
        f"{max(report['pit_ks']):.3f}, z-R2 {report['point']['r2'][1]:.3f} "
        f"(readings after {SPEC_EPOCHS} epochs, not gates)")
    check(np.isfinite(report["tarp_deviation"]), "spectral evaluation")


def noise_and_lines(tt, lib, dev):
    """Phase 18: empirical noise models from a 10⁵-object catalogue,
    features with them on phase 4's 2²⁰ rows, their HDF5 round trip, and
    `line_quantities` on 65536 rows, card against CPU."""
    import importlib.util

    rng = np.random.default_rng(18)
    cat_f, cat_e = {}, {}
    for j, code in enumerate(CODES):
        flux = 10 ** rng.uniform(0, 4, NOISE_CATALOGUE)
        err = (5.0 + j + 0.05 * flux) * rng.lognormal(0, 0.2, NOISE_CATALOGUE)
        cat_f[code], cat_e[code] = flux + err * rng.normal(
            size=NOISE_CATALOGUE), err
    t0 = time.perf_counter()
    models = tt.create_noise_models_from_catalogue(
        cat_f, cat_e, "general", upper_limits=True,
        treat_as_upper_limits_below=2.0)
    log(f"[noise] create_noise_models_from_catalogue({NOISE_CATALOGUE} "
        f"objects x {len(CODES)} bands, general, upper limits): "
        f"{time.perf_counter() - t0:.3f} s")
    pipe = tt.FeaturePipeline(tt.FeatureConfig(
        filter_codes=tuple(CODES), unit="asinh", include_errors=True),
        noise_models=models)
    phot = torch.as_tensor(lib["photometry"].T, device=dev)
    g = torch.Generator(device=dev).manual_seed(18)
    pipe.build(g, phot[:4096])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.build(g, phot)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"[noise] features with the empirical models on {phot.shape[0]} "
        f"rows: {res.features.shape} in {dt:.3f} s")
    check(bool(np.isfinite(res.features).all()), "empirical-noise features")
    if importlib.util.find_spec("h5py") is None:
        log("[noise] h5py is not installed on this machine: the HDF5 round "
            "trip did not run here (the CPU tests hold it)")
    else:
        import h5py

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "noise.h5")
            with h5py.File(path, "w") as f:
                for code, m in models.items():
                    tt.save_noise_model_hdf5(m, f.create_group(code))
            with h5py.File(path, "r") as f:
                back = {c: tt.load_noise_model_hdf5(f[c]) for c in models}
        x = phot[:4096, 0]
        draws = {k: torch.rand(x.shape, generator=g, device=dev)
                 for k in models[CODES[0]].DRAWS}
        a = models[CODES[0]].apply(None, x, draws=draws)
        b = back[CODES[0]].apply(None, x, draws=draws)
        check(all(torch.equal(u, v) for u, v in zip(a, b)),
              "noise model HDF5 round trip")
        log("[noise] HDF5 round trip: the same noisy fluxes bit for bit")
    # line quantities, card against CPU, on young bursts (the setting of
    # tests/test_lines.py): the lines of a history without young stars come
    # from CDF differences near 1 in its youngest bins, float32 rounding
    # noise in both packages (ROADMAP queue 3)
    grid = tt.make_synthetic_grid(n_ages=24, n_mets=4, n_wav=4096,
                                  line_strength=50.0)
    rng = np.random.default_rng(18)
    n = HEADLINE_BATCH
    theta = torch.as_tensor(np.stack([
        rng.uniform(8, 10.5, n), rng.uniform(0.5, 4.0, n),
        rng.uniform(3e6, 8e6, n), rng.uniform(5e5, 2e6, n),
        rng.uniform(-3.5, -1.6, n), rng.uniform(0.0, 1.0, n)], axis=1),
        dtype=torch.float32, device=dev)

    out = {}
    for d in ("cpu", dev):
        lsim = tt.BatchSEDSimulator(
            grid, tt.FilterSet([tt.tophat_filter("F200W", 20000.0, 4600.0)]),
            ("log10_mass", "redshift", "burst_age", "sigma",
             "log10_metallicity", "tau_v"), sfh="gaussian_burst",
            emission=tt.EmissionConfig(reprocessed_types=("total",)),
            device=d)
        if str(d) != "cpu":
            lsim.line_quantities(theta[:1024])  # warm-up
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[str(d)] = lsim.line_quantities(theta.to(d))
    log(f"[lines] line_quantities({n} rows, {len(out['cpu']['ids'])} lines, "
        f"young bursts) on the card {time.perf_counter() - t0:.3f} s")
    card, cpu = out[str(dev)], out["cpu"]
    worst, n_small, small_err = 0.0, 0, 0.0
    for k in ("luminosity", "flux", "ew_rest", "ew_obs"):
        check(bool(np.isfinite(card[k]).all()), f"line {k} not finite")
        # relative where a value reaches 1e-3 of its line's largest
        floor = 1e-3 * np.abs(cpu[k]).max(axis=0, keepdims=True)
        sig = np.abs(cpu[k]) > floor
        diff = np.abs(card[k] - cpu[k])
        worst = max(worst, float((diff[sig] / np.abs(cpu[k][sig])).max()))
        n_small += int((~sig).sum())
        small_err = max(small_err, float(
            (diff / np.maximum(floor, 1e-300))[~sig].max(initial=0.0)))
    log(f"[lines] card vs CPU: max rel {worst:.3e} on values above 1e-3 of "
        f"their line's largest; the {n_small} values below it differ by at "
        f"most {small_err:.3e} of that floor (tol {TOL_LINES})")
    check(worst < TOL_LINES and small_err < TOL_LINES,
          "line quantities card vs CPU")


# -- phases 19-21: the flow zoo, the NLE/NRE engines, the online engines ----
# Phase 19: every registry name at the widths of scripts/zoo_sweep.py
# (MODELS; "affine_coupling" at realnvp's), as NPE on every 16th row of the
# phase-4 library. "gaussian" is not among the names whose width
# run_single_sbi sets (the JAX package's rule), so it keeps the default 50.
ZOO_MODELS = {
    "nsf": dict(hidden_features=50, num_transforms=8),
    "maf": dict(hidden_features=50, num_transforms=8),
    "mdn": dict(hidden_features=64, num_components=8),
    "gaussian": dict(),
    "made": dict(hidden_features=64),
    "realnvp": dict(hidden_features=50, num_transforms=8),
    "affine_coupling": dict(hidden_features=50, num_transforms=8),
    "nice": dict(hidden_features=50, num_transforms=8),
    "ncsf": dict(hidden_features=50, num_transforms=8),
    "naf": dict(hidden_features=40, num_transforms=3),
    "unaf": dict(hidden_features=40, num_transforms=3),
    "sospf": dict(hidden_features=40, num_transforms=3),
    "gf": dict(hidden_features=40, num_transforms=4),
    "cnf": dict(hidden_features=64, num_steps=12),
}
ZOO_STRIDE, ZOO_NETS, ZOO_EPOCHS = 16, 2, 2
ZOO_CLOSED_FORM = ("maf", "nsf", "realnvp", "nice", "ncsf")
ZOO_BISECTION = ("naf", "unaf", "sospf")
# inverse then forward of the bisection families: 50 halvings of [-512, 512]
# end within 1024/2^50 of the root in exact arithmetic, so what is left is
# the float rounding of T near its flat spots: held, in fp64, to 1e-4 like
# the closed-form inverses (the fp32 round trip is a reading)
TOL_BISECT = 1e-4
# Phase 20: NLE and NRE at the north-star width on phase 9's 2^18 rows
ENGINE_EPOCHS = 3
MCMC_OBJECTS, MCMC_DRAWS = 256, 256
# a 16-step chain on 8 objects from the same draws, card against CPU: the
# log-density differs in its last float32 bits between the devices, so an
# accept decision within that distance of its uniform can go the other way
# and the walker's object diverges from then on; the states of every object
# whose chains did not branch agree to 1e-4, and at most one of the 8 may
# branch
TOL_CHAIN = 1e-4
# Phase 21: the online engines on the headline model's photometry
ONLINE_SIMS, ONLINE_ROUNDS = 4096, 2


def zoo_round_trip(flow, params, xs, dev, dtype, n: int = 64):
    """|base − forward(inverse(base))| of the flow proper on `n` draws for
    each of `xs`'s contexts, in `dtype` (torus distance for ncsf)."""
    from synference_tpu_torch.flows.base import tree_map

    k = params["theta_mean"].shape[0]
    g = torch.Generator(device=dev).manual_seed(19)
    with torch.no_grad():
        ctx = flow._context(params, xs).unsqueeze(2).expand(
            -1, -1, n, -1).reshape(k, xs.shape[0] * n, -1).to(dtype)
        base = flow._net.draw_base(g, (k, ctx.shape[1])).to(dtype)
        net = tree_map(lambda a: a.to(dtype), params["flow"])
        back, _ = flow._net.forward(net, flow._net.inverse(net, base, ctx),
                                    ctx)
    d = back - base
    if flow.model == "ncsf":
        tb = flow._net.tail_bound
        d = torch.remainder(d + tb, 2.0 * tb) - tb
    return d.abs().flatten()


def flow_zoo(tt, lib, dev):
    """Phase 19: every registry name as NPE on north-star features."""
    from synference_tpu_torch.flows.base import (ConditionalFlow,
                                                 params_from_numpy,
                                                 params_to_numpy)

    fitter = tt.SBIFitter(
        photometry=lib["photometry"].T[::ZOO_STRIDE],
        parameters=lib["parameters"].T[::ZOO_STRIDE],
        parameter_names=lib["parameter_names"],
        filter_codes=lib["filter_codes"], device=dev)
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(CODES), unit="asinh", depths_ab=(29.5,) * 7,
        n_scatters=1, include_errors=True))
    fitter.create_priors()
    idx = fitter.split_dataset()["test"][:256]
    xs = torch.as_tensor(fitter.features[idx], device=dev)
    truths = fitter.feature_params[idx]
    lo, hi = fitter.prior.low.cpu().numpy(), fitter.prior.high.cpu().numpy()
    cpu = torch.device("cpu")
    log(f"[zoo] {fitter.features.shape[0]} rows x "
        f"{fitter.features.shape[1]} features, {len(PNAMES)} θ; "
        f"{ZOO_NETS} members, {ZOO_EPOCHS} epochs at batch 2048, fp32 (TF32 "
        f"off)")
    for model, kw in ZOO_MODELS.items():
        t0 = time.perf_counter()
        res = fitter.run_single_sbi(
            model, n_nets=ZOO_NETS, train_config=tt.TrainConfig(
                batch_size=2048, learning_rate=7e-4, max_epochs=ZOO_EPOCHS),
            **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flow, params = fitter.flow, res.params
        check(bool(np.isfinite(res.train_losses).all()
                   and np.isfinite(res.val_losses).all()),
              f"{model}: non-finite loss")
        # one optimiser step alone, as train_ensemble runs it
        tr_idx = fitter._split["train"]
        step, _, _ = training_parts(flow, fitter.feature_params[tr_idx],
                                    fitter.features[tr_idx], 2048,
                                    n_nets=ZOO_NETS)
        step()
        ms_step = host_ms(lambda: [step() for _ in range(5)], 3) / 5
        # raw draws/s of the flow alone
        g = torch.Generator(device=dev).manual_seed(19)
        with torch.no_grad():
            flow.sample_batch(params, xs[:8], 64, g)  # warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            draws = flow.sample_batch(params, xs, 64, g)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        n_raw = ZOO_NETS * xs.shape[0] * 64
        d = draws.cpu().numpy()
        check(bool(np.isfinite(d).all() and (d >= lo).all()
                   and (d <= hi).all()),
              f"{model}: a draw lies outside the prior box")
        # log_prob on the card against the same parameters on the CPU
        flow_cpu = ConditionalFlow.from_spec(flow.spec(), cpu)
        with torch.no_grad():
            lp = flow.log_prob(params, truths, xs).cpu()
            lp_cpu = flow_cpu.log_prob(
                params_from_numpy(params_to_numpy(params), cpu), truths,
                xs.cpu())
        check(bool(torch.isfinite(lp).all()), f"{model}: non-finite log_prob")
        lp_err = float((lp - lp_cpu).abs().max())
        check(lp_err < TOL_FLOW, f"{model}: log_prob card vs CPU {lp_err}")
        line = (f"[zoo] {model} {kw}: fit {wall:.2f} s, val "
                f"{np.round(res.val_losses[-1].astype(float), 3).tolist()}; "
                f"{ms_step:.3f} ms per step (host clock); {n_raw} raw draws "
                f"in {dt:.4f} s = {n_raw / dt:,.0f} draws/s; log_prob card "
                f"vs CPU max |Δ| {lp_err:.3e} (tol {TOL_FLOW})")
        if model in ZOO_CLOSED_FORM + ZOO_BISECTION + ("gf",):
            e32 = zoo_round_trip(flow, params, xs[:64], dev, torch.float32)
            e64 = zoo_round_trip(flow, params, xs[:64], dev, torch.float64)
            p999 = float(e32.kthvalue(int(0.999 * e32.numel())).values)
            line += (f"; inverse then forward: fp64 max {float(e64.max()):.3e}"
                     f", fp32 p99.9 {p999:.3e} max {float(e32.max()):.3e}")
            if model in ZOO_CLOSED_FORM:
                check(float(e64.max()) < TOL_FLOW and p999 < TOL_FLOW,
                      f"{model}: inverse then forward misses the base draws")
            elif model in ZOO_BISECTION:
                check(float(e64.max()) < TOL_BISECT,
                      f"{model}: bisection inverse misses the base draws")
        log(line)


def engines(tt, fitter, dev):
    """Phase 20: NLE and NRE at the north-star width, batched MCMC."""
    from synference_tpu_torch import diagnostics as td
    from synference_tpu_torch.flows.base import (ConditionalFlow,
                                                 params_from_numpy,
                                                 params_to_numpy)
    from synference_tpu_torch.mcmc import run_batched_mcmc
    from synference_tpu_torch.ratio import RatioEstimator

    idx = fitter._split["test"][:MCMC_OBJECTS]
    xs, truths = fitter.features[idx], fitter.feature_params[idx]
    lo, hi = fitter.prior.low.cpu().numpy(), fitter.prior.high.cpu().numpy()
    cpu = torch.device("cpu")
    rng = np.random.default_rng(20)
    for engine in ("nle", "nre"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fitter.run_single_sbi(
            "nsf", engine=engine, hidden_features=69, num_transforms=15,
            n_nets=N_NETS, train_config=tt.TrainConfig(
                batch_size=2048, learning_rate=7e-4,
                max_epochs=ENGINE_EPOCHS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        post = fitter.posterior
        check(bool(np.isfinite(res.train_losses).all()
                   and np.isfinite(res.val_losses).all()),
              f"{engine}: non-finite loss")
        log(f"[{engine}] {fitter.flow.spec()['config']} x{N_NETS}: "
            f"{ENGINE_EPOCHS} epochs of {res.history['steps_per_epoch']} "
            f"steps in {wall:.2f} s with split and init; val per epoch "
            f"{[round(float(v), 3) for v in res.val_losses.mean(axis=1)]}"
            f" (member mean)")
        fitter.sample_posterior(xs[:8], 64)  # warm-up, not timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws = fitter.sample_posterior(xs, MCMC_DRAWS)
        dt = time.perf_counter() - t0
        steps = post.burn_in + -(-MCMC_DRAWS // post.n_walkers) * post.thin
        rows = MCMC_OBJECTS * post.n_walkers * (1 + steps)
        check(draws.shape == (MCMC_OBJECTS, MCMC_DRAWS, len(PNAMES))
              and bool(np.isfinite(draws).all() and (draws >= lo).all()
                       and (draws <= hi).all()),
              f"{engine}: a draw lies outside the prior box")
        acc = post.last_acceptance
        check(0.0 < acc < 1.0, f"{engine}: acceptance {acc}")
        rhat, ess = post.last_diagnostics["rhat"], post.last_diagnostics["ess"]
        check(bool(np.isfinite(rhat).all() and np.isfinite(ess).all()),
              f"{engine}: non-finite R-hat or ESS")
        pit = td.pit_values(draws, truths, device=dev)
        pit_ks = td.pit_ks_statistic(pit, device=dev)
        log(f"[{engine}] sample_posterior({MCMC_OBJECTS} objects x "
            f"{MCMC_DRAWS}), {post.n_walkers} walkers, burn-in "
            f"{post.burn_in}, thin {post.thin} ({steps} steps, "
            f"{2 * steps} half-steps): {dt:.3f} s = "
            f"{1e3 * dt / MCMC_OBJECTS:.3f} s per 1000 objects, {rows} "
            f"likelihood rows = {rows / dt:,.0f} rows/s (host clock); "
            f"acceptance {acc:.4f}; R-hat median {np.median(rhat):.3f} max "
            f"{rhat.max():.3f}, share of objects above {post.rhat_warn} "
            f"{float((rhat.max(axis=1) > post.rhat_warn).mean()):.3f}; ESS "
            f"min {ess.min():.1f} median {np.median(ess):.1f}; readings "
            f"after {ENGINE_EPOCHS} epochs: TARP "
            f"{td.tarp_deviation(draws, truths, device=dev):.4f}, PIT-KS "
            f"{[round(float(v), 3) for v in pit_ks]}")

        # the loop's sync guard is live: a log-density that reads back raises
        def reads_back(theta, x):
            ll = post._loglike(theta, x)
            float(ll.sum())  # waits for the card
            return ll

        raised = False
        try:
            run_batched_mcmc(reads_back, fitter.prior, xs[:2], n_walkers=8,
                             n_steps=2, burn_in=0)
        except RuntimeError as e:
            raised = "synchroniz" in str(e)
        check(raised, f"{engine}: a readback inside the MCMC loop did not "
              "raise")

        # a 16-step chain on 8 objects from the same draws, card vs CPU
        m, w, n_steps = 8, post.n_walkers, 16
        half = w // 2
        u = rng.uniform(size=(m, w, len(PNAMES))).astype(np.float32)
        chain_draws = {
            "walkers": lo + u * (hi - lo),
            "stretch": rng.uniform(size=(n_steps, 2, m, half)).astype(
                np.float32),
            "partner": rng.integers(0, half, (n_steps, 2, m, half)),
            "accept": rng.uniform(size=(n_steps, 2, m, half)).astype(
                np.float32)}
        spec = fitter.flow.spec()
        est_cpu = (RatioEstimator.from_spec(spec, cpu) if engine == "nre"
                   else ConditionalFlow.from_spec(spec, cpu))
        params_cpu = params_from_numpy(params_to_numpy(post.params), cpu)
        post_cpu = type(post)(est_cpu, params_cpu,
                              tt.BoxUniform.from_dict(fitter.prior.to_dict(),
                                                      cpu))
        with torch.no_grad():
            s_card, a_card = run_batched_mcmc(
                post._loglike, fitter.prior, xs[:m], n_walkers=w,
                n_steps=n_steps, burn_in=0, thin=1, draws=chain_draws)
            s_cpu, a_cpu = run_batched_mcmc(
                post_cpu._loglike, post_cpu.prior, xs[:m], n_walkers=w,
                n_steps=n_steps, burn_in=0, thin=1, draws=chain_draws)
        per_obj = (s_card.cpu() - s_cpu).abs().amax(dim=(1, 2))
        same = per_obj < TOL_CHAIN
        log(f"[{engine}] 16-step chain on {m} objects from the same draws, "
            f"card vs CPU: max |Δ| per object "
            f"{[float(f'{v:.3e}') for v in per_obj.tolist()]}; acceptance "
            f"{float(a_card):.5f} vs {float(a_cpu):.5f} (tol {TOL_CHAIN} on "
            f"all but at most one object)")
        check(int(same.sum()) >= m - 1, f"{engine}: chains card vs CPU")

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{engine}.pkl")
            fitter.save_state(path)
            loaded = tt.SBIFitter.load_saved_model(path, device=dev)
        th = torch.as_tensor(truths, device=dev)
        xd = torch.as_tensor(xs, device=dev)
        with torch.no_grad():
            same_bits = torch.equal(loaded.posterior._loglike(th, xd),
                                    post._loglike(th, xd))
        log(f"[{engine}] save_state -> load_saved_model: _loglike bitwise "
            f"equal: {same_bits}")
        check(same_bits and loaded.engine == engine,
              f"{engine}: the reloaded model differs")

        sigma = tt.DepthNoiseModel(29.5).sigma_njy
        clean = fitter.photometry[idx]
        flux = (clean + sigma * rng.standard_normal(clean.shape)).astype(
            np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tt.fit_catalogue(fitter, flux, np.full_like(flux, sigma),
                               n_samples=MCMC_DRAWS, check_ood=False)
        dt = time.perf_counter() - t0
        cols = ("mcmc_rhat_max", "mcmc_ess_min", "flag_mcmc_unconverged")
        check(all(c in out and out[c].shape == (MCMC_OBJECTS,) for c in cols),
              f"{engine}: fit_catalogue lacks the MCMC columns")
        log(f"[{engine}] fit_catalogue({MCMC_OBJECTS} objects): {dt:.3f} s = "
            f"{1e3 * dt / MCMC_OBJECTS:.3f} s per 1000 objects; "
            f"{int(out['flag_mcmc_unconverged'].sum())} flagged unconverged")


def online_engines(tt, k1, dev):
    """Phase 21: SNPE, SNLE and SNRE on the headline model's photometry
    followed by asinh features; returns K2's launches over the phase."""
    sim = headline_model(tt, dev, "auto")
    fp = tt.FeaturePipeline(tt.FeatureConfig(
        filter_codes=tuple(f"F{i}" for i in range(7)), unit="asinh",
        depths_ab=(29.5,) * 7, n_scatters=1, include_errors=True))
    lo = [7.5, 0.05, 5e7, 0.1, -3.9, 0.0]
    hi = [11.0, 10.0, 1e9, 1.2, -1.5, 3.0]
    theta_true = torch.tensor([[10.0, 2.0, 3e8, 0.5, -2.5, 0.5]], device=dev)
    g_noise = torch.Generator(device=dev).manual_seed(21)
    calls = []

    def simulate(theta):
        before = k1.fused_sed_photometry.launches
        phot = sim.photometry(theta)
        calls.append((time.perf_counter(),
                      k1.fused_sed_photometry.launches - before))
        return fp.build(g_noise, phot, parameters=theta).features

    x_obs = simulate(theta_true)[0]
    sim.photometry(headline_theta(dev, 1024))  # warm-up
    total = 0
    for engine, model, kw in (
            ("snpe", "nsf", dict(hidden_features=32, num_transforms=4)),
            ("snle", "nsf", dict(hidden_features=32, num_transforms=4)),
            ("snre", "mlp", dict(hidden_features=32))):
        fitter = tt.SBIFitter(np.ones((2, 7)), np.zeros((2, 6)), PNAMES,
                              [f"F{i}" for i in range(7)], device=dev)
        fitter.prior = tt.BoxUniform(lo, hi, PNAMES, device=dev)
        calls.clear()
        k1.fused_sed_photometry.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post, data, hist = fitter.run_online_sbi(
            simulate, x_obs, engine=engine, model_type=model,
            n_rounds=ONLINE_ROUNDS, sims_per_round=ONLINE_SIMS,
            train_config=tt.TrainConfig(batch_size=512, learning_rate=1e-3,
                                        max_epochs=20, stop_after_epochs=5),
            generator=torch.Generator(device=dev).manual_seed(21),
            verbose=False, **kw)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = k1.fused_sed_photometry.launches
        total += launches
        per_round = [c[1] for c in calls]
        stamps = [c[0] for c in calls] + [t_end]
        check(len(per_round) == ONLINE_ROUNDS and min(per_round) >= 1,
              f"{engine}: K2 launches per round {per_round}")
        check(all(np.isfinite(h["best_val"]) for h in hist),
              f"{engine}: a round's loss is not finite")
        s = post.sample(x_obs, 256, torch.Generator(device=dev).manual_seed(3))
        s = s.cpu().numpy()
        spread = data["theta"][1].std(0) / data["theta"][0].std(0)
        check(bool(np.isfinite(s).all() and (s >= np.float32(lo)).all()
                   and (s <= np.float32(hi)).all()),
              f"{engine}: a posterior draw lies outside the box")
        log(f"[online] {engine} ({model} {kw}): {ONLINE_ROUNDS} rounds of "
            f"{ONLINE_SIMS} simulations in {t_end - t0:.2f} s; seconds per "
            f"round from its simulation to the next "
            f"{np.round(np.diff(stamps), 3).tolist()} (host clock); best "
            f"val per round {[round(h['best_val'], 3) for h in hist]}; K2 "
            f"launches per round {per_round}; round-2 θ spread / round-1 "
            f"{[round(float(v), 3) for v in spread]}; posterior median "
            f"{[float(f'{v:.4g}') for v in np.median(s, axis=0)]} vs truth "
            f"{[float(f'{v:.4g}') for v in theta_true[0].tolist()]}")
    return total


def band_slices(k1, launch, tables: dict, n_knots: int, f8: int):
    """The kernel `launch(tables, f8)` on each 8-band slice of `tables`
    (`band_group_tables`), the slices' outputs side by side."""
    return torch.cat([launch(k1.band_group_tables(tables, g, n_knots), 8)
                      for g in range(f8 // 8)], dim=1)


def cluster_check(k1, name: str, launch, plain, exact, tables: dict,
                  n_knots: int, f8: int, bnd: dict, tol_p99: float,
                  tol_max: float, reps: int = 5,
                  tag: str = "paper63") -> dict:
    """A kernel at F8 > 8 (clusters of `cluster_size(F8)` band groups)
    against its plain version (relative differences: p99 < tol_p99, max <
    tol_max) and the exact first product (`exact()`, the exact gate), two
    runs bitwise equal, bitwise equal to its 8-band slices; its time, the
    plain version's and the share of the bound `bnd`."""
    out = launch(tables, f8)
    torch.cuda.synchronize()
    ref = plain()
    med, p99, mx, abs_err = rel_stats(out, ref)
    log(f"[{tag}] {name} vs plain: rel median={med:.3e} p99={p99:.3e} "
        f"max={mx:.3e} (tol p99<{tol_p99} max<{tol_max}); max abs err "
        f"{abs_err:.4e} nJy")
    check(p99 < tol_p99 and mx < tol_max,
          f"{name} disagrees with its plain version")
    exact_gate(k1, tag, name, out, exact(), ref)
    check(torch.equal(out, launch(tables, f8)), f"two {name} runs differ")
    check(torch.equal(out, band_slices(k1, launch, tables, n_knots, f8)),
          f"{name} differs from its 8-band slices")
    stats = dict(bnd, max_abs_err=abs_err, cluster=k1.cluster_size(f8),
                 ms=time_ms(lambda: launch(tables, f8), reps=reps),
                 plain_ms=time_ms(plain, reps=2, warmup=1))
    stats["share_of_bound"] = stats["bound_ms"] / stats["ms"]
    log(f"[{tag}] {name} alone: {stats['ms']:.4f} ms against a bound of "
        f"{stats['bound_ms']:.4f} ms ({stats['bound_by']}; fp32 FMA), share "
        f"{stats['share_of_bound']:.3f}; a 3xTF32 route's bound "
        f"{stats['tf32x3_bound_ms']:.4f} ms; plain {stats['plain_ms']:.4f} ms; "
        f"clusters of {stats['cluster']}; two runs and the {f8 // 8} "
        f"8-band slices bitwise equal (CUDA events)")
    return stats


def paper63_bounds(k1, auto, theta, sorted_theta) -> dict:
    """K1 (grouped) and K2 alone at the paper-63 width (F8 64): against
    their plain versions, bitwise across two runs and against their 8-band
    slices, timed beside their bounds (`k1_bound` summed over the
    sub-chunks, `bound` for K2). Returns {"K1": stats, "K2": stats}."""
    from synference_tpu_torch.ops import _cuda

    f8 = auto._f8
    n = k1.cluster_size(f8)
    resident = ctypes.c_int(0)
    err = _cuda.load_library().k1_max_active_clusters(n,
                                                      ctypes.byref(resident))
    check(err == 0, f"cudaOccupancyMaxActiveClusters failed ({err})")
    log(f"[paper63] F8 {f8}: clusters of {n} band groups, "
        f"{resident.value} resident at once (cudaOccupancyMaxActiveClusters)")
    a = k2_args(auto, theta)
    b, c = a["sfzh"].shape
    n_l = a["sed_w"].shape[1]
    k2b = bound(flops_fp32=2.0 * b * c * n_l,
                flops_bf16=2.0 * b * n_l * 4 * a["f8"],
                nbytes=4 * (b * c + c * n_l + n_l + a["kc"] * a["f8"] + 3 * b
                            + b * a["f8"]) + 2 * n_l * a["kc"] * a["f8"])
    tables = auto._mega_tables

    def k2(t, f):
        return k1.fused_sed_photometry(
            a["sfzh"], a["s_rel"], a["tau_v"], a["scale"], t, a["kc"],
            a["delta"], f, order=a["order"], fesc=a["fesc"])

    # At these shapes, as at the north-star width (phase 7), cuBLAS sums
    # the plain versions' first product over cells in another order than
    # the kernels' FMA chain (measured medians 1.9e-7, where the headline
    # width gives 0), so bf16 roundings of the knot product's input flip,
    # and one flip in a narrow band moves a flux by up to ~1e-4 (measured
    # max 2.2e-5 for K2, 1.7e-4 for K1 on an H100): the bound is phase 7's.
    # Both kernels' bits also equal their 8-band slices', the lone-block
    # kernels that phases 3-7 hold.
    tol = dict(tol_p99=TOL_STAGED_P99, tol_max=TOL_STAGED_MAX)
    log(f"[paper63] K2 at B={b} C={c} L_sup={n_l} n_knots={a['kc']} F8={f8}")
    k2s = cluster_check(k1, "K2", k2,
                        lambda: k1.fused_window_photometry_reference(**a),
                        lambda: k1.fused_window_photometry_exact(**a),
                        tables, a["kc"], f8, k2b, **tol)
    chunk, sub, kc, w_cols, k0, l0 = auto._plan_windows(sorted_theta, 1024)
    subs = [s for *_, s in auto._window_calls(chunk, sub, w_cols, kc, k0, l0)]
    bounds = [k1_bound(s) for s in subs]
    k1b = {"bound_ms": sum(x["bound_ms"] for x in bounds),
           "bound_by": ("operations" if all(x["bound_by"] == "operations"
                                             for x in bounds) else "bytes"),
           "tf32x3_bound_ms": sum(x["tf32x3_bound_ms"] for x in bounds)}
    g = auto._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)

    def k1g(t, f):
        return k1.fused_window_photometry_grouped(**dict(g, tables=t, f8=f))

    log(f"[paper63] K1 at {len(k0)} sub-chunks of {sub} rows, W={w_cols}, "
        f"kc={kc}, F8={f8} (bound: the sum of the sub-chunks')")
    k1s = cluster_check(
        k1, "K1", k1g,
        lambda: k1.fused_window_photometry_grouped_reference(**g),
        lambda: k1.fused_window_photometry_grouped_reference(
            **g, first_product=k1.exact_first_product),
        g["tables"], auto._n_knots, f8, k1b, **tol)
    for st in (k1s, k2s):
        st["resident_clusters"] = resident.value
    return {"K1": k1s, "K2": k2s}


# -- phases 22-23: the gradient fitters and the rest of diagnostics ----------
GRAD_OBJECTS = 1024  # the mock catalogue of MAP and VI
HMC_OBJECTS, HMC_CHAINS = 256, 8
GRAD_ROWS = 256  # the log-posterior gradient, card against CPU
FISHER_ROWS, FISHER_CPU_ROWS = 65536, 64
# card against CPU, as |Δ| over each row's largest |entry| (the log-posterior
# gradient in logit space at prior draws, F at the truths) or over the prior
# width (HMC samples from the same draws); the card's and the CPU's float32
# sums of the same products differ in order only (measured on an H100:
# gradient 5.3e-5, F 3.4e-5)
TOL_GRAD_ROW = 1e-4
TOL_FISHER_ROW = 1e-4
TOL_HMC_WIDTH = 1e-4
# ... for at least half the chains of the short run: where the card's and
# the CPU's log α straddle an accept uniform (they differ by rounding), the
# two chains part for good, and so do the object's other chains, whose
# adapted step size is shared (measured on an H100: 44 of 64 chains within
# 1e-4, the acceptance 1.8e-3 apart)
HMC_CHAINS_CLOSE = 32
TOL_HMC_ACC = 1e-2
# L-C2ST after 200 epochs of Adam from the same draws: ReLU kinks flip on
# rounding and the classifiers drift apart (port against JAX on the CPU:
# 3.6e-3 on a statistic of ~0.1; card against CPU on an H100: 7.7e-3), so
# the statistics are held absolutely
TOL_LC2ST_STAT = 2e-2
SMC_KW = dict(n_particles=512, n_moves=2, max_stages=40)
# the marginal flow trains on every feature row: `detect_misspecification`
# takes the first `max_train`, and the library is sorted by redshift (its
# first 65536 rows span z < ~2, and 5 epochs on them flagged 13 of the 16
# garbage rows on an H100)
MISSPEC_ROWS = 2**18


def _zero_counts(k1, pk):
    k1.fused_window_photometry.launches = 0
    k1.fused_sed_photometry.launches = 0
    pk.shift_photometry_num.launches = 0


def _counts(k1, pk):
    return (k1.fused_window_photometry.launches,
            k1.fused_sed_photometry.launches, pk.shift_photometry_num.launches)


def cpu_twin(tt, sim):
    """The simulator on the CPU, on the same route, with the card's tables
    (`load_state`), so card and CPU differ only in their arithmetic."""
    return _with_card_tables(sim, tt.BatchSEDSimulator(
        sim.grid, sim.filters, sim.param_names, sfh=sim.sfh_name,
        zdist=sim.zdist_name, emission=sim.emission,
        photometry_backend=sim.photometry_backend, device="cpu"))


def _with_card_tables(sim, cpu):
    """`cpu` with every table of the card simulator `sim` loaded."""
    state = {}
    for key in sim.STATE_KEYS:
        val = getattr(sim, f"_{key}", None)
        if val is None or getattr(cpu, f"_{key}", None) is None:
            continue
        state[key] = ({t: v.float().cpu().numpy() for t, v in val.items()}
                      if key == "components" else val.float().cpu().numpy())
    cpu.load_state(state)
    return cpu


def _row_rel(card, cpu):
    """max over rows of max |card − cpu| / the row's largest |cpu| entry."""
    card = card.detach().float().cpu().reshape(card.shape[0], -1)
    cpu = cpu.detach().float().reshape(cpu.shape[0], -1)
    scale = torch.clamp(cpu.abs().amax(dim=1), min=1e-30)
    return float(((card - cpu).abs().amax(dim=1) / scale).max())


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sim_box(names):
    """PRIOR's box over the simulator's θ (raw peak age, as the library
    stores it)."""
    low = [PRIOR[n][0] if n in PRIOR else 10.0 ** PRIOR[f"log10_{n}"][0]
           for n in names]
    high = [PRIOR[n][1] if n in PRIOR else 10.0 ** PRIOR[f"log10_{n}"][1]
            for n in names]
    return low, high


def gradient_fitters(tt, k1, pk, sim, fitter, dev):
    """Phase 22: the gradient fitters through the north-star simulator."""
    from synference_tpu_torch import mcmc
    from synference_tpu_torch.mcmc import _LogitBox, _value_and_grad

    names = tuple(sim.param_names)
    low, high = sim_box(names)
    prior = tt.BoxUniform(low, high, names, device=dev)
    width = (prior.high - prior.low).cpu()
    g = torch.Generator(device=dev).manual_seed(22)
    truth = prior.sample(g, GRAD_OBJECTS)
    flux = sim.photometry(truth)
    torch.cuda.synchronize()
    check(_counts(k1, pk) == (0, 1, 0),
          f"the mock catalogue launched {_counts(k1, pk)} (K1, K2, K3), not "
          f"one K2")
    sigma = torch.full_like(flux, tt.DepthNoiseModel(29.5).sigma_njy)
    obs = flux + sigma * torch.randn(flux.shape, generator=g, device=dev)
    log(f"[grad] mock catalogue: {GRAD_OBJECTS} prior draws of the "
        f"north-star model through photometry() (one K2 launch), σ "
        f"{float(sigma[0, 0]):.4f} nJy (depth 29.5), median SNR "
        f"{float((flux / sigma).median()):.1f}")

    def no_kernels(name, fn):
        before = _counts(k1, pk)
        out, dt = _timed(fn)
        check(_counts(k1, pk) == before,
              f"{name} launched a kernel: {before} -> {_counts(k1, pk)}")
        check(sim._mega_off is False, f"{name} left _mega_off set")
        return out, dt

    # the wrappers refuse gradients on the card, in both AD modes
    from torch.autograd import forward_ad
    params = sim.theta_dict(truth[:64])
    sfzh, _ = sim._sfzh(params)
    z = params["redshift"]
    k2_rest = (sim._shift_of_z(z), params["tau_v"], sim._scale_of_z(z),
               sim._mega_tables, sim._n_knots, sim._knot_delta, sim._f8)
    res = sim.simulate(truth[:64], want_spectra=True)
    fw = res["fnu_njy"] * sim._wlam
    calls = {"K2": (sfzh, lambda x: k1.fused_sed_photometry(x, *k2_rest)),
             "K1": (sfzh, lambda x: k1.fused_window_photometry_grouped(
                 x, k2_rest[0], k2_rest[1], k2_rest[2], sim._mega_tables,
                 [0], [0], 64, sim._l_sup, sim._n_knots, sim._knot_delta,
                 sim._f8)),
             "K3": (fw, lambda x: pk.shift_photometry_num(
                 x, torch.zeros((8, 8, fw.shape[1] + 8), device=dev),
                 torch.zeros(64, dtype=torch.int32, device=dev)))}
    for name, (x, call) in calls.items():
        for mode in ("requires_grad", "forward-AD dual"):
            raised = False
            try:
                if mode == "requires_grad":
                    call(x.detach().clone().requires_grad_(True))
                else:
                    with forward_ad.dual_level():
                        call(forward_ad.make_dual(x.detach().clone(),
                                                  torch.ones_like(x)))
            except RuntimeError as e:
                raised = "_mega_off" in str(e)
            check(raised, f"{name} did not refuse an input with a {mode}")
    check(_counts(k1, pk) == (0, 1, 0), "a refused call launched a kernel")
    log("[grad] K1, K2 and K3 refuse an input that requires grad and a "
        "forward-AD dual (RuntimeError naming _mega_off)")

    # the log-posterior gradient in logit space, card against CPU
    cpu_sim = cpu_twin(tt, sim)
    cpu_prior = tt.BoxUniform(low, high, names, device="cpu")
    theta_g = prior.sample(g, GRAD_ROWS)
    grads = {}
    for name, s_, p_, dv in (("card", sim, prior, dev),
                             ("cpu", cpu_sim, cpu_prior, "cpu")):
        box = _LogitBox(p_)
        x_, sg_ = obs[:GRAD_ROWS].to(dv), sigma[:GRAD_ROWS].to(dv)

        def logpost(u, s_=s_, box=box, x_=x_, sg_=sg_):
            return (mcmc.censored_gaussian_loglike_rows(
                s_.photometry(box.theta(u)), x_, sg_) + box.log_jac(u))

        with mcmc._plain_route(s_):
            grads[name] = _value_and_grad(logpost, box.u(theta_g.to(dv)))[1]
            truth_grad = _value_and_grad(logpost, box.u(truth[:GRAD_ROWS]
                                                         .to(dv)))[1]
        check(bool(torch.isfinite(grads[name]).all()
                   and torch.isfinite(truth_grad).all()),
              f"non-finite log-posterior gradient ({name})")
    rel = _row_rel(grads["card"], grads["cpu"])
    log(f"[grad] log-posterior gradient on {GRAD_ROWS} rows at prior draws: "
        f"finite there and at the truths; card against CPU max |Δ| / row "
        f"max {rel:.3e} (bound {TOL_GRAD_ROW:g})")
    check(rel < TOL_GRAD_ROW, f"gradient card vs CPU {rel:.3e}")

    # Fisher forecast at 65536 truths (the catalogue's first rows repeated
    # over fresh prior draws)
    theta_f = torch.cat([truth, prior.sample(g, FISHER_ROWS - GRAD_OBJECTS)])
    fr, dt_f = no_kernels("fisher_forecast", lambda: tt.fisher_forecast(
        sim, theta_f, sigma[:1].expand(FISHER_ROWS, -1)))
    f_mat = fr["fisher"]
    asym = float(((f_mat - f_mat.transpose(1, 2)).abs().amax(dim=(1, 2))
                  / f_mat.abs().amax(dim=(1, 2))).max())
    check(bool(torch.isfinite(f_mat).all()), "non-finite Fisher matrix")
    check(asym < 1e-6, f"Fisher matrix asymmetric by {asym:.2e}")
    fr_cpu = tt.fisher_forecast(cpu_sim, theta_f[:FISHER_CPU_ROWS].cpu(),
                                sigma[:FISHER_CPU_ROWS].cpu())
    rel_f = _row_rel(f_mat[:FISHER_CPU_ROWS], fr_cpu["fisher"])
    log(f"[grad] fisher_forecast({FISHER_ROWS} rows): {dt_f:.3f} s = "
        f"{FISHER_ROWS / dt_f:,.0f} rows/s, 0 kernel launches; finite, "
        f"asymmetry {asym:.1e}; card against CPU on {FISHER_CPU_ROWS} rows "
        f"{rel_f:.3e} of each F's largest entry (bound {TOL_FISHER_ROW:g}); "
        f"Cramér-Rao σ finite on "
        f"{float(torch.isfinite(fr['cramer_rao_sigma']).all(1).float().mean()):.3f}"
        f" of rows")
    check(rel_f < TOL_FISHER_ROW, f"Fisher card vs CPU {rel_f:.3e}")

    # MAP + Laplace and VI of the whole catalogue
    out_map, dt_map = no_kernels("fit_catalogue_map", lambda: tt.fit_catalogue_map(
        sim, obs, sigma, prior, g, n_steps=400, n_restarts=4))
    tmap = out_map["theta_map"]
    check(bool(prior.support_mask(tmap).all()), "a MAP lies outside the box")
    check(bool(torch.isfinite(out_map["log_like"]).all()),
          "non-finite MAP log-likelihood")
    pulls = ((tmap - truth) / out_map["laplace_sigma"]).cpu().numpy()
    med_pull = [float(np.nanmedian(np.abs(pulls[:, i])))
                for i in range(len(names))]
    log(f"[grad] fit_catalogue_map({GRAD_OBJECTS} objects, 4 restarts, 400 "
        f"Adam steps): {dt_map:.2f} s = {1e3 * dt_map / GRAD_OBJECTS:.3f} s "
        f"per 1000 objects, 0 kernel launches; median |pull| per parameter "
        f"{np.round(med_pull, 3).tolist()}; Laplace σ finite on "
        f"{float(torch.isfinite(out_map['laplace_sigma']).all(1).float().mean()):.3f}"
        f" of objects; median log-likelihood "
        f"{float(out_map['log_like'].median()):.2f}")
    out_vi, dt_vi = no_kernels("fit_catalogue_vi", lambda: tt.fit_catalogue_vi(
        sim, obs, sigma, prior, g))
    for k in ("elbo", "mean", "sigma"):
        check(bool(torch.isfinite(out_vi[k]).all()), f"non-finite VI {k}")
    log(f"[grad] fit_catalogue_vi({GRAD_OBJECTS} objects, 500 steps of 8 "
        f"draws): {dt_vi:.2f} s = {1e3 * dt_vi / GRAD_OBJECTS:.3f} s per "
        f"1000 objects, 0 kernel launches; median ELBO "
        f"{float(out_vi['elbo'].median()):.2f}")

    # HMC of 256 objects at the JAX defaults, the whole call under the
    # sync guard
    import warnings
    x_h, s_h = obs[:HMC_OBJECTS].contiguous(), sigma[:HMC_OBJECTS].contiguous()
    torch.cuda.synchronize()

    def hmc():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            torch.cuda.set_sync_debug_mode("error")
        try:
            return tt.fit_catalogue_hmc(sim, x_h, s_h, prior, g,
                                        n_chains=HMC_CHAINS)
        finally:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                torch.cuda.set_sync_debug_mode(0)

    (samples, lps, acc), dt_h = no_kernels("fit_catalogue_hmc", hmc)
    acc = float(acc)
    n_pass = HMC_OBJECTS * HMC_CHAINS * 550 * 13
    check(0.0 < acc < 1.0, f"HMC acceptance {acc}")
    check(bool(prior.support_mask(samples.reshape(-1, len(names))).all()),
          "an HMC sample lies outside the box")
    chains = samples.reshape(HMC_OBJECTS, HMC_CHAINS, -1, len(names)
                             ).permute(2, 0, 1, 3)
    rhat, _ = mcmc.split_rhat_ess(chains)
    rmax = rhat.amax(dim=1).cpu().numpy()
    cr = tt.fisher_forecast(sim, truth[:HMC_OBJECTS], s_h)["cramer_rao_sigma"]
    ratio = (samples.std(dim=1) / cr).cpu().numpy()
    log(f"[grad] fit_catalogue_hmc({HMC_OBJECTS} objects x {HMC_CHAINS} "
        f"chains, 150 warmup, 400 samples, 12 leapfrog) under sync debug "
        f"mode \"error\": {dt_h:.2f} s = {1e3 * dt_h / HMC_OBJECTS:.2f} s per "
        f"1000 objects, {n_pass / dt_h:,.0f} gradient rows/s "
        f"({HMC_OBJECTS * HMC_CHAINS} rows x 550 x 13 passes), 0 kernel "
        f"launches; acceptance {acc:.3f}; split-R-hat median "
        f"{float(np.median(rmax)):.3f}, share > 1.1 "
        f"{float((rmax > 1.1).mean()):.3f}; median HMC σ / Cramér-Rao σ per "
        f"parameter {np.round(np.nanmedian(ratio, axis=0), 3).tolist()}")

    # a short HMC from the same draws on the card and the CPU, at 50%
    # errors: at depth 29.5 a 4-step chain from prior candidates rejects
    # every proposal, and the comparison would only see its start
    rng = np.random.default_rng(22)
    n_short, c_short = 8, 8
    s_short = 0.5 * flux[:n_short] + sigma[:n_short]
    draws = {"candidates": cpu_prior.sample(torch.Generator().manual_seed(5),
                                            256).numpy(),
             "momenta": rng.standard_normal(
                 (8, n_short * c_short, len(names))).astype(np.float32),
             "accept": rng.uniform(size=(8, n_short * c_short)).astype(
                 np.float32)}
    kw = dict(n_chains=c_short, n_warmup=4, n_samples=4, n_leapfrog=3,
              draws=draws)
    short_card, _ = no_kernels("short fit_catalogue_hmc", lambda: tt.fit_catalogue_hmc(
        sim, obs[:n_short], s_short, prior, **kw))
    short_cpu = tt.fit_catalogue_hmc(cpu_sim, obs[:n_short].cpu(),
                                     s_short.cpu(), cpu_prior, **kw)
    dev_chain = ((short_card[0].cpu() - short_cpu[0]).abs() / width).reshape(
        n_short, c_short, -1, len(names)).amax(dim=(2, 3)).flatten()
    close = dev_chain < TOL_HMC_WIDTH
    objects = int(close.reshape(n_short, c_short).all(dim=1).sum())
    d_acc = abs(float(short_card[2]) - float(short_cpu[2]))
    log(f"[grad] short HMC ({n_short} objects x {c_short} chains, 50% "
        f"errors, 2 + 2 warmup and 4 samples of 3 leapfrog) from the same "
        f"draws: card against CPU, {int(close.sum())} of "
        f"{n_short * c_short} chains within {TOL_HMC_WIDTH:g} of the prior "
        f"width (largest deviation among them "
        f"{float(dev_chain[close].max()):.3e}), all chains of {objects} of "
        f"{n_short} objects; acceptance {float(short_card[2]):.4f} and "
        f"{float(short_cpu[2]):.4f} (|Δ| {d_acc:.1e}, bound "
        f"{TOL_HMC_ACC:g})")
    check(int(close.sum()) >= HMC_CHAINS_CLOSE,
          f"only {int(close.sum())} short HMC chains agree card vs CPU")
    check(d_acc < TOL_HMC_ACC, f"short HMC acceptance card vs CPU {d_acc}")

    # NPE against HMC: phase 9's ensemble (θ as the library stores it, the
    # simulator's) on 8 objects featurised as in phase 14
    feats8 = fitter.features_from_observations(obs[:8].cpu().numpy(),
                                               sigma[:8].cpu().numpy())
    cc, dt_cc = no_kernels("posterior_crosscheck", lambda: tt.posterior_crosscheck(
        fitter.posterior, sim, feats8, obs[:8], sigma[:8], prior, g))
    scores = cc["c2st"]
    check(bool(((scores >= 0) & (scores <= 1)).all()),
          f"C2ST outside [0, 1]: {scores}")
    log(f"[grad] posterior_crosscheck(8 objects, 512 draws, HMC 8 chains x "
        f"64, 120 warmup): {dt_cc:.2f} s; C2ST {np.round(scores, 3).tolist()}"
        f"; HMC acceptance {cc['hmc_acceptance']:.3f}")

    # model comparison: lognormal against phase 15's delayed-τ model, on 4
    # objects drawn from the lognormal one
    fam = tt.BatchSEDSimulator(
        sim.grid, sim.filters, FAMILY_PNAMES, sfh="delayed_tau",
        zdist="normal", emission=sim.emission, device=dev)
    fam_prior = tt.BoxUniform([FAMILY_PRIOR[n][0] for n in FAMILY_PNAMES],
                              [FAMILY_PRIOR[n][1] for n in FAMILY_PNAMES],
                              FAMILY_PNAMES, device=dev)
    before = _counts(k1, pk)
    t0 = time.perf_counter()
    bayes = []
    for i in range(4):
        mc = tt.model_comparison(
            {"lognormal": sim, "delayed_tau": fam}, obs[i], sigma[i],
            {"lognormal": prior, "delayed_tau": fam_prior}, g, **SMC_KW)
        for name in ("lognormal", "delayed_tau"):
            check(bool(np.isfinite(mc[name]["log_z"])),
                  f"non-finite log Z of {name}")
        bayes.append(mc["lognormal"]["log_z"] - mc["delayed_tau"]["log_z"])
        stages = [mc[n]["info"]["n_stages"] for n in ("lognormal",
                                                       "delayed_tau")]
    k2_smc = _counts(k1, pk)[1] - before[1]
    log(f"[grad] model_comparison on 4 objects (SMC {SMC_KW}): "
        f"{time.perf_counter() - t0:.2f} s, {k2_smc} K2 launches (SMC is "
        f"gradient-free: the kernel route, as in the JAX package); log Bayes "
        f"factor lognormal - delayed-τ {np.round(bayes, 2).tolist()}; stages "
        f"of the last {stages}")
    return _counts(k1, pk)


def diagnostics_rest(tt, k1, pk, fitter, lib, dev):
    """Phase 23: the rest of diagnostics and priors on phase 9's fitter."""
    from synference_tpu_torch.diagnostics import lc2st
    from synference_tpu_torch.flows.base import (ConditionalFlow,
                                                 params_from_numpy,
                                                 params_to_numpy)

    g = torch.Generator(device=dev).manual_seed(23)
    test = fitter._split["test"]
    x_cal = torch.as_tensor(fitter.features[test[:1000]], device=dev)
    theta_cal = fitter.feature_params[test[:1000]]
    x_obs = torch.as_tensor(fitter.features[test[1000]], device=dev)
    n_null, hidden = 20, 64
    d_in = theta_cal.shape[1] + x_cal.shape[1]
    with torch.no_grad():
        draws = {"theta_hat": fitter.posterior.sample_batch(x_cal, 1, g)[:, 0],
                 "obs_samples": fitter.posterior.sample(x_obs, 2000, g),
                 "masks": torch.rand((n_null, 1000, 1), generator=g,
                                     device=dev) < 0.5,
                 "w1": np.sqrt(2.0 / d_in) * torch.randn(
                     (n_null + 1, hidden, d_in), generator=g, device=dev)}
    card, dt = _timed(lambda: fitter.lc2st(x_obs, n_cal=1000, draws=draws,
                                           n_null=n_null, n_epochs=200))
    post_cpu = tt.EnsemblePosterior(
        ConditionalFlow.from_spec(fitter.flow.spec(), "cpu"),
        params_from_numpy(params_to_numpy(fitter.posterior.params), "cpu"),
        tt.BoxUniform.from_dict(fitter.prior.to_dict(), "cpu"))
    cpu = lc2st(post_cpu, theta_cal, x_cal.cpu(), x_obs.cpu(),
                draws={k: v.cpu() for k, v in draws.items()}, n_null=n_null,
                n_epochs=200)
    stats_card = np.r_[card["stat"], card["null_stats"]]
    stats_cpu = np.r_[cpu["stat"], cpu["null_stats"]]
    d_stat = float(np.abs(stats_card - stats_cpu).max())
    check(bool(np.isfinite(stats_card).all() and np.isfinite(card["p_value"])),
          "non-finite L-C2ST")
    log(f"[diag] fitter.lc2st(n_cal 1000, n_null 20, 200 epochs; 21 "
        f"classifiers as one member axis): {dt:.2f} s; stat "
        f"{card['stat']:.5f}, p {card['p_value']:.3f} (CPU {cpu['stat']:.5f}"
        f", p {cpu['p_value']:.3f}); max |Δ statistic| card vs CPU "
        f"{d_stat:.3e} (bound {TOL_LC2ST_STAT:g}), classifier probabilities "
        f"{float(np.abs(card['probs_obs'] - cpu['probs_obs']).max()):.3e}")
    check(d_stat < TOL_LC2ST_STAT, f"L-C2ST card vs CPU {d_stat:.3e}")

    # misspecification: 256 held-out rows and 16 garbage rows
    rng = np.random.default_rng(23)
    garbage = (rng.uniform(1e5, 1e7, (GARBAGE_ROWS, len(CODES)))
               * rng.choice([-1.0, 1.0], (GARBAGE_ROWS, len(CODES))))
    sigma = tt.DepthNoiseModel(29.5).sigma_njy
    x_bad = fitter.features_from_observations(
        garbage.astype(np.float32), np.full_like(garbage, sigma, np.float32))
    x_mis = np.concatenate([fitter.features[test[:256]], x_bad])
    (flags, lp_mis, thresh), dt = _timed(
        lambda: fitter.detect_misspecification(
            x_mis, generator=g, max_train=MISSPEC_ROWS, max_epochs=5))
    log(f"[diag] detect_misspecification (maf marginal, 5 epochs on the "
        f"first {MISSPEC_ROWS} feature rows): {dt:.2f} s; flagged "
        f"{int(flags[:256].sum())} of 256 held-out rows and "
        f"{int(flags[256:].sum())} of {GARBAGE_ROWS} garbage rows; "
        f"threshold {thresh:.2f}, garbage log-densities up to "
        f"{float(lp_mis[256:].max()):.2f}")
    check(bool(flags[256:].all()), "a garbage row was not flagged")

    xs, truths = fitter.features[test[:256]], fitter.feature_params[test[:256]]
    imp, dt = _timed(lambda: tt.feature_importance(fitter.posterior, xs,
                                                   truths))
    log(f"[diag] feature_importance(256 objects, 3 repeats): {dt:.2f} s; "
        f"{np.round(imp, 3).tolist()}")
    check(bool(np.isfinite(imp).all()), "non-finite feature importance")
    sh, dt = _timed(lambda: tt.shapley_feature_importance(
        fitter.posterior, xs, truths, seed=23))
    gain = sh["base_log_prob"] - sh["masked_log_prob"]
    eff = abs(sh["total_gain"] - gain) / max(abs(gain), 1e-30)
    log(f"[diag] shapley_feature_importance(256 objects, 8 orderings): "
        f"{dt:.2f} s; Σφ {sh['total_gain']:.4f} against v(all) - v(none) "
        f"{gain:.4f} (relative {eff:.1e}); φ "
        f"{np.round(sh['shapley'], 3).tolist()}")
    check(eff < 1e-4, f"Shapley efficiency off by {eff:.1e}")

    theta_map, dt = _timed(lambda: fitter.calculate_map(
        fitter.features[test[:64]], generator=g))
    log(f"[diag] calculate_map(64 objects, 512 draws each): {dt:.3f} s")
    check(tuple(theta_map.shape) == (64, len(PNAMES))
          and bool(fitter.prior.support_mask(theta_map).all()),
          "calculate_map outside the prior or misshapen")

    # the restricted prior: simulations fail in one corner of the box
    names = list(fitter.parameter_names)
    theta_r = lib["parameters"].T[::16][:65536]
    mass, z = names.index("log10_mass"), names.index("redshift")
    corner = (theta_r[:, mass] > 10.25) & (theta_r[:, z] > 5.5)
    x_r = np.ones((theta_r.shape[0], len(CODES)), np.float32)
    x_r[corner] = np.nan
    base = tt.BoxUniform(*sim_box(names), names, device=dev)
    rp, dt_fit = _timed(lambda: tt.restricted_prior_from_simulations(
        base, theta_r, x_r, generator=g))
    s, dt_s = _timed(lambda: rp.sample(g, 10_000))
    s = s.cpu().numpy()
    in_corner = float(((s[:, mass] > 10.25) & (s[:, z] > 5.5)).mean())
    log(f"[diag] restricted_prior_from_simulations({theta_r.shape[0]} θ, "
        f"{corner.mean():.3f} of them invalid in the corner): fit {dt_fit:.2f}"
        f" s ({rp.classifier.clf.n_iter_} epochs), 10^4 draws {dt_s:.3f} s, "
        f"{in_corner:.4f} of them in the corner")
    check(in_corner < 0.02, f"{in_corner:.4f} of the draws in the corner")
    return _counts(k1, pk)


# The AGN and composite paths (phases 24-25): the AGN twin's model at full
# width, cut in depth.
AGN_ROWS = 2**18
AGN_TRAIN_ROWS = 20_000
AGN_EPOCHS = 5
AGN_PRIOR = {"log10_l_agn": (43.5, 47.0), "redshift": (0.1, 6.0),
             "ionisation_parameter": (-3.0, 0.0),
             "hydrogen_density": (2.0, 6.0),
             "covering_fraction_blr": (0.02, 0.3),
             "covering_fraction_nlr": (0.05, 0.5), "tau_v": (0.0, 1.5)}
ANALYTIC_PRIOR = {"log10_l_agn": (43.5, 47.0), "redshift": (0.1, 6.0),
                  "agn_slope": (-1.2, 0.3), "tau_v": (0.0, 1.5)}
AGN_CPU_ROWS = 4096  # card against CPU, both AGN simulators
COMPOSITE_ROWS = 65536
FRACTION_ROWS = 16384
TOL_FRACTION = 1e-5
# rows of both libraries within this of z = 2 combine (~50 and ~18 rows)
COMBINE_Z_ATOL = 2e-4


def agn_model(tt, dev):
    """The AGN twin's simulator: `make_synthetic_agn_grid(6, 4, 2048)`
    through `AGNGridSimulator` on the twin's 7 NIRCam tophats, named by the
    phase-4 library's codes so that the two libraries combine."""
    grid = tt.make_synthetic_agn_grid(n_u=6, n_nh=4, n_wav=2048)
    filters = tt.FilterSet([
        tt.tophat_filter(c, ctr, w)
        for c, ctr, w in zip(CODES, HEADLINE_CENTERS, HEADLINE_WIDTHS)])
    return tt.AGNGridSimulator(grid, filters, device=dev)


def agn_cpu_twin(sim):
    """The AGN simulator on the CPU, on the card's route and tables."""
    return _with_card_tables(sim, type(sim)(
        sim.grid, sim.filters, param_names=sim.param_names,
        photometry_backend=sim.photometry_backend, device="cpu"))


def box_theta(prior, names, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(*prior[p], n) for p in names],
                    axis=1).astype(np.float32)


def agn_path(tt, k1, pk, dev):
    """Phase 24: the AGN twin's model at full width: a 2^18-row library,
    NSF 50 x 8 on its first 20 000 rows (cut to AGN_EPOCHS epochs, drawn
    live into a StringIO), evaluation, a 50-object catalogue fit; both AGN
    simulators on the card against the CPU. No kernel may launch."""
    import contextlib
    import io

    sim = agn_model(tt, dev)
    check(sim.photometry_backend == "pallas" and not sim._mega_supported()
          and not sim._window_supported(),
          "the AGN simulator passes a stellar kernel's gate")
    gen = tt.LibraryGenerator(sim, AGN_PRIOR, device=dev)
    gen.generate(n=BATCH, batch_size=BATCH, seed=1)  # warm-up
    _zero_counts(k1, pk)
    lib, wall = _timed(lambda: gen.generate(n=AGN_ROWS, batch_size=BATCH,
                                            seed=0))
    phot = lib["photometry"]
    log(f"[agn] AGNGridSimulator (6 x 4 x 2048 grid, lambda support "
        f"{sim._l_sup} columns, {sim._n_knots} knots): generate({AGN_ROWS}) "
        f"{wall:.3f} s = {AGN_ROWS / wall:,.0f} SEDs/s (host sampler, the "
        f"plain dense route); launches (K1, K2, K3) {_counts(k1, pk)}")
    check(phot.shape == (len(CODES), AGN_ROWS), f"AGN photometry {phot.shape}")
    check(bool(np.isfinite(phot).all() and (phot >= 0).all()),
          "non-finite or negative AGN photometry")

    fitter = tt.SBIFitter.from_library(
        {k: (v[:, :AGN_TRAIN_ROWS] if k in ("photometry", "parameters")
             else v) for k, v in lib.items()}, name="agn", device=dev)
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(fitter.filter_codes), unit="asinh",
        depths_ab=(28.5,) * 7, n_scatters=2, include_errors=True))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, dt = _timed(lambda: fitter.run_single_sbi(
            "nsf", hidden_features=50, num_transforms=8,
            train_config=tt.TrainConfig(
                max_epochs=AGN_EPOCHS, stop_after_epochs=12, batch_size=512,
                learning_rate=5e-4, live_plot=True)))
    lines = buf.getvalue().splitlines()
    log(f"[agn] NSF 50x8, one member, batch 512, {fitter.features.shape[0]} "
        f"rows: {len(res.val_losses)} epochs in {dt:.2f} s "
        f"({res.history['steps_per_epoch']} steps each); val loss "
        f"{np.round(res.val_losses[:, 0].astype(float), 3).tolist()}; live "
        f"plot: {lines[-1]!r}")
    check(len(res.val_losses) == AGN_EPOCHS, "the AGN training stopped early")
    check(bool(np.isfinite(res.val_losses).all()), "non-finite AGN loss")
    check(bool((res.val_losses[1:].min(axis=0) < res.val_losses[0]).all()),
          "the AGN validation loss never fell below its first epoch's")
    check(len(lines) == AGN_EPOCHS and lines[0].startswith("epoch    0"),
          "the live plot did not draw one line per epoch")

    report, dt = _timed(lambda: fitter.evaluate_model(256, max_objects=256))
    log(f"[agn] evaluate_model(256, 256) {dt:.3f} s: TARP "
        f"{report['tarp_deviation']:.4f}, PIT-KS "
        f"{np.round(report['pit_ks'], 3).tolist()}")
    check(np.isfinite(report["tarp_deviation"]), "non-finite AGN TARP")
    obs = fitter.photometry[:50]
    table, dt = _timed(lambda: tt.fit_catalogue(
        fitter, obs, 0.05 * obs, "nJy", n_samples=500,
        ood_methods=("mahalanobis",)))
    recovery = {}
    for p in ("log10_l_agn", "redshift"):
        q = table[f"{p}_q50"]
        check(bool(np.isfinite(q).all()), f"non-finite {p} quantiles")
        truth = fitter.parameters[:50, fitter.parameter_names.index(p)]
        recovery[p] = float(np.corrcoef(q, truth)[0, 1])
    log(f"[agn] fit_catalogue(50 rows, 500 draws) {dt:.3f} s: recovery r "
        f"{ {k: round(v, 3) for k, v in recovery.items()} }")

    # both AGN simulators on the card against the same route on the CPU
    analytic = tt.AGNSimulator(
        tt.make_synthetic_grid(n_ages=48, n_mets=8, n_wav=2048,
                               lam_min=300.0), sim.filters, device=dev)
    for card, prior in ((sim, AGN_PRIOR), (analytic, ANALYTIC_PRIOR)):
        theta = box_theta(prior, card.param_names, AGN_CPU_ROWS, seed=24)
        out = card.photometry(theta)
        ref = agn_cpu_twin(card).photometry(theta)
        med, p99, mx, _ = rel_stats(out, ref)
        log(f"[agn] {type(card).__name__}.photometry({AGN_CPU_ROWS}) card "
            f"vs CPU: rel median={med:.3e} p99={p99:.3e} max={mx:.3e} (tol "
            f"p99<{TOL_STAGED_P99} max<{TOL_STAGED_MAX})")
        check(p99 < TOL_STAGED_P99 and mx < TOL_STAGED_MAX,
              f"{type(card).__name__} card and CPU disagree")
    counts = _counts(k1, pk)
    check(counts == (0, 0, 0), f"the AGN path launched kernels {counts}")
    return lib, counts


def composite_path(tt, k1, pk, lib4, lib24, dev):
    """Phase 25: the headline stellar model (K2) plus the AGN grid model on
    the same filters; `agn_fraction` and `combine_libraries` on the phase-4
    and phase-24 libraries; `run_from_config` on a JSON config."""
    import json as _json

    stars = headline_model(tt, dev, "auto")
    agn = tt.AGNGridSimulator(
        tt.make_synthetic_agn_grid(n_u=6, n_nh=4, n_wav=2048), stars.filters,
        device=dev)
    comp = tt.CompositeSEDSimulator({"stars": stars, "agn": agn})
    agn_names = tuple(p for p in agn.param_names if p != "redshift")
    theta = torch.cat([
        headline_theta(dev)[:, [1, 0, 2, 3, 4, 5]],
        torch.as_tensor(box_theta(AGN_PRIOR, agn_names, COMPOSITE_ROWS,
                                  seed=25), device=dev)], dim=1)
    check(theta.shape[1] == comp.n_params, "composite θ width")
    comp.photometry(theta[:1024])  # warm-up
    torch.cuda.synchronize()
    _zero_counts(k1, pk)
    phot, dt = _timed(lambda: comp.photometry(theta))
    counts = _counts(k1, pk)
    log(f"[composite] photometry({COMPOSITE_ROWS}) {1e3 * dt:.3f} ms (host "
        f"clock, first call); launches (K1, K2, K3) {counts}")
    check(counts == (0, 1, 0), f"composite launches {counts}, expected one K2")
    parts = {}
    for name, sim in comp.components.items():
        res = sim._core(comp._component_theta(theta, name), False,
                        fused=True)
        parts[name] = sim._photometry_fused(res["_lnu"], res["_z"])
    plain = parts["stars"] + parts["agn"]
    med, p99, mx, _ = rel_stats(phot, plain)
    log(f"[composite] vs the sum of the components' plain routes: rel "
        f"median={med:.3e} p99={p99:.3e} max={mx:.3e} (tol "
        f"p99<{TOL_STAGED_P99} max<{TOL_STAGED_MAX})")
    check(p99 < TOL_STAGED_P99 and mx < TOL_STAGED_MAX,
          "the composite disagrees with its components' plain routes")
    # the same on the bands where the stars give at least 10% of the flux,
    # so that a dropped or mis-scaled stellar part cannot hide under the AGN
    ref = plain.cpu().numpy()
    keep = ((parts["stars"].cpu().numpy() >= 0.1 * ref)
            & (ref > 1e-3 * ref.max(axis=1, keepdims=True)))
    rel = (np.abs(phot.cpu().numpy() - ref) / np.maximum(np.abs(ref), 1e-30)
           )[keep]
    rows = int(keep.any(axis=1).sum())
    log(f"[composite] on the {int(keep.sum())} bands of {rows} rows where "
        f"the stars give >= 10% of the flux: rel p99="
        f"{np.quantile(rel, 0.99):.3e} max={rel.max():.3e} (same tol)")
    check(rows >= COMPOSITE_ROWS // 4, "too few rows with a stellar share")
    check(np.quantile(rel, 0.99) < TOL_STAGED_P99 and rel.max()
          < TOL_STAGED_MAX, "the composite's stellar part disagrees")

    # agn_fraction on stellar θ from the phase-4 library and AGN θ from the
    # phase-24 library, against a float64 host integral of the same spectra
    names4, names24 = lib4["parameter_names"], lib24["parameter_names"]
    rows = np.s_[:FRACTION_ROWS]
    theta_f = torch.as_tensor(np.stack(
        [lib4["parameters"][names4.index("redshift"), rows]]
        + [lib4["parameters"][names4.index(p), rows] for p in PNAMES
           if p != "redshift"]
        + [lib24["parameters"][names24.index(p), rows] for p in agn_names],
        axis=1), device=dev)
    frac, dt = _timed(lambda: comp.agn_fraction(theta_f,
                                                agn_components=("agn",)))
    lam = np.asarray(stars.grid.lam, np.float64)
    w = ((lam >= 1.0e4) & (lam <= 3.0e5)) * np.gradient(lam) / lam**2
    lnu = {name: sim.simulate(comp._component_theta(theta_f, name),
                              want_spectra=True)["lnu"].double().cpu().numpy()
           for name, sim in comp.components.items()}
    ref = (lnu["agn"] @ w) / np.maximum((lnu["agn"] + lnu["stars"]) @ w,
                                        1e-30)
    err = float(np.abs(frac.cpu().numpy() - ref).max())
    log(f"[composite] agn_fraction({FRACTION_ROWS} rows: phase-4 stellar θ, "
        f"phase-24 AGN θ) {dt:.3f} s on {frac.device}; median "
        f"{float(frac.median()):.4f}, max |Δ| against a float64 host "
        f"integral {err:.2e} (tol {TOL_FRACTION})")
    check(frac.device.type == "cuda" and bool(((frac >= 0) & (frac <= 1))
                                              .all()), "agn_fraction range")
    check(err < TOL_FRACTION, "agn_fraction disagrees with its integral")

    # outer-product combination of the two libraries around z = 2, and
    # row-matched combination of their first 4096 rows
    z4 = lib4["parameters"][names4.index("redshift")]
    z24 = lib24["parameters"][names24.index("redshift")]
    check(list(lib4["filter_codes"]) == list(lib24["filter_codes"]),
          "the phase-4 and phase-24 libraries have other filters")
    (out, dt) = _timed(lambda: tt.combine_libraries(
        [lib4, lib24], [9.0, 10.0], [2.0], [[0.7, 0.3], [0.9, 0.1]],
        base_names=["stars", "agn"], mass_params=["log10_mass", None],
        z_atol=COMBINE_Z_ATOL))
    near4 = np.where(np.abs(z4 - 2.0) <= COMBINE_Z_ATOL)[0]
    near24 = np.where(np.abs(z24 - 2.0) <= COMBINE_Z_ATOL)[0]
    n4, n24, first4, first24 = len(near4), len(near24), near4[0], near24[0]
    m4 = 10.0 ** lib4["parameters"][names4.index("log10_mass"), first4]
    hand = (0.7e9 * lib4["photometry"][:, first4].astype(np.float64) / m4
            + 0.3e9 * lib24["photometry"][:, first24].astype(np.float64)
            / 1e9)
    cell = np.abs(out["photometry"][:, 0] - hand).max() / np.abs(hand).max()
    log(f"[composite] combine_libraries(phase-4 x phase-24 at |z - 2| <= "
        f"{COMBINE_Z_ATOL}: {n4} x {n24} rows, 2 masses, 2 weights) "
        f"{dt:.3f} s -> "
        f"{out['photometry'].shape[1]} rows; first cell against a hand sum "
        f"{cell:.1e}")
    check(out["photometry"].shape[1] == n4 * n24 * 4 and cell < 1e-6,
          "combine_libraries")
    matched = tt.combine_libraries_matched(
        [{k: (v[:, :4096] if k in ("photometry", "parameters") else v)
          for k, v in lib.items()} for lib in (lib4, lib24)],
        np.full(4096, 10.0), np.tile([[0.8, 0.2]], (4096, 1)),
        mass_params=["log10_mass", None])
    check(np.isfinite(matched["photometry"]).all()
          and matched["photometry"].shape == (len(CODES), 4096),
          "combine_libraries_matched")

    # config-driven training on a JSON config with fitter=
    fitter = tt.SBIFitter.from_library(
        {k: (v[:, :AGN_TRAIN_ROWS] if k in ("photometry", "parameters")
             else v) for k, v in lib24.items()}, name="agn_cfg", device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {"max_epochs": 2, "output": os.path.join(tmp, "m.pkl"),
               "features": {"unit": "asinh", "depths_ab": [28.5] * 7,
                            "include_errors": True},
               "train_args": {"validation_fraction": 0.1,
                              "epochs_per_dispatch": 4, "fixed_params": {
                                  "model_choice": "nsf",
                                  "training_batch_size": 512,
                                  "nsf_hidden_features": 32,
                                  "nsf_num_transforms": 4}}}
        path = os.path.join(tmp, "cfg.json")
        with open(path, "w") as f:
            _json.dump(cfg, f)
        fitted, dt = _timed(lambda: tt.run_from_config(path, fitter=fitter,
                                                       device=dev))
        saved = os.path.exists(cfg["output"])
    log(f"[composite] run_from_config(JSON, nsf 32x4, 2 epochs) {dt:.2f} s; "
        f"val loss {np.round(fitted.train_result.val_losses[:, 0], 3)}; "
        f"saved {saved}")
    check(saved and bool(np.isfinite(fitted.train_result.val_losses).all()),
          "run_from_config")
    # the timing runs after the counts were read: a call launches K2 once
    ms = time_ms(lambda: comp.photometry(theta), reps=20)
    ms_parts = {name: time_ms(lambda s=sim, n=name: s.photometry(
        comp._component_theta(theta, n)), reps=20)
        for name, sim in comp.components.items()}
    log(f"[composite] photometry({COMPOSITE_ROWS}) {ms:.4f} ms = "
        f"{COMPOSITE_ROWS / ms * 1e3:,.0f} SEDs/s (CUDA events); components "
        f"alone: stars (K2) {ms_parts['stars']:.4f} ms, AGN (plain) "
        f"{ms_parts['agn']:.4f} ms")
    return counts


# -- phases 26-29: the simformer, HPO, the paper-63 twin, parallel/ --------
# Phase 26: a simformer over phase 9's north-star features (6 θ + 14
# features = 20 tokens) at the reference width (d_model 128, 4 heads, 4
# layers), cut to SIMFORMER_EPOCHS epochs on 2^16 rows; sampling of 64
# objects × 256 draws at the default 500 reverse-SDE steps.
SIMFORMER_ROWS, SIMFORMER_EPOCHS = 2**16, 3
SIMFORMER_OBJECTS, SIMFORMER_DRAWS = 64, 256
# card against CPU from the same weights, TF32 off: the score to 1e-4 of
# its largest entry, log p by 20 PF-ODE steps to 1e-3 absolute (float32
# sums in another order, carried through 20 steps of the divergence)
TOL_SCORE, TOL_SF_LOGP = 1e-4, 1e-3
# Phase 27: HPO on every 16th row of phase 4's library (65536 rows): the
# study's seed 1 draws learning rate 7e-4 first, then 1e-7 three times, so a
# median pruner cuts the later trials at epoch 1 of 3
HPO_STRIDE, HPO_EPOCHS, HPO_SEED = 16, 3, 1
HPO_SPACE = {"hidden_features": ("categorical", [32]),
             "num_transforms": ("categorical", [4]),
             "learning_rate": ("categorical", [7e-4, 1e-7]),
             "batch_size": ("categorical", [2048])}
SWEEP_RATES = [1e-7, 1e-4, 7e-4, 3e-3]
# Phase 28: the paper-63 twin at full width, depth cut (2^16 rows, 2
# epochs, one member). Phase 29: parallel/ on a one-rank NCCL group.
P63_ROWS, P63_EPOCHS = 2**16, 2
PAR_ROWS = 2**18


def simformer_phase(tt, k1, pk, fitter, dev):
    """Phase 26: `run_single_simformer` on 2^16 rows of phase 9's features,
    the 500-step sampler graphed against eager, card against CPU, and a
    saved model read back."""
    from synference_tpu_torch import simformer as ts

    rows = np.arange(SIMFORMER_ROWS) * (fitter.features.shape[0]
                                       // SIMFORMER_ROWS)
    sf = tt.SBIFitter(photometry=fitter.photometry[rows],
                      parameters=fitter.parameters[rows],
                      parameter_names=fitter.parameter_names,
                      filter_codes=fitter.filter_codes, device=dev)
    sf.features = fitter.features[rows]
    sf.feature_params = fitter.feature_params[rows]
    sf.feature_source = np.arange(SIMFORMER_ROWS)
    sf.feature_flags = fitter.feature_flags
    sf.prior = fitter.prior
    n_tok = sf.features.shape[1] + sf.feature_params.shape[1]
    hist, wall = _timed(lambda: sf.run_single_simformer(
        d_model=128, n_heads=4, n_layers=4, max_epochs=SIMFORMER_EPOCHS))
    steps = int(0.9 * SIMFORMER_ROWS) // 256
    log(f"[simformer] {n_tok} tokens, d_model 128, 4 x 4 heads: "
        f"{len(hist['val'])} epochs of {steps} steps at batch 256 in "
        f"{wall:.2f} s = {1e3 * wall / (steps * len(hist['val'])):.2f} ms "
        f"per step (eager, validation included); val "
        f"{np.round(hist['val'], 4).tolist()}")
    check(n_tok == 20, f"{n_tok} tokens")
    check(bool(np.isfinite(hist["train"]).all()
               and np.isfinite(hist["val"]).all()), "non-finite loss")
    check(min(hist["val"][1:]) < hist["val"][0],
          "the simformer's validation loss never fell below epoch 1's")
    post = sf.posterior
    held = np.arange(SIMFORMER_OBJECTS) * 4096 + 1
    xs = torch.as_tensor(fitter.features[held], device=dev)
    out = {}
    for graphed in (True, False):
        gen = torch.Generator(device=dev).manual_seed(11)
        out[graphed], secs = _timed(lambda: post.sample_batch(
            xs, SIMFORMER_DRAWS, gen, graphed=graphed))
        log(f"[simformer] sample_batch {SIMFORMER_OBJECTS} x "
            f"{SIMFORMER_DRAWS}, {post.n_steps} steps, "
            f"{'graphed' if graphed else 'eager'}: {secs:.2f} s = "
            f"{1e3 * secs / post.n_steps:.2f} ms per step, "
            f"{SIMFORMER_OBJECTS * SIMFORMER_DRAWS / secs:,.0f} draws/s")
    diff = float((out[True] - out[False]).abs().max())
    log(f"[simformer] graphed vs eager: max |diff| {diff:.3e} "
        f"({'bitwise equal' if diff == 0 else 'not bitwise'})")
    check(diff <= 1e-6, "the graphed sampler disagrees with the eager one")
    s = out[True]
    check(s.shape == (SIMFORMER_OBJECTS, SIMFORMER_DRAWS, 6)
          and bool(torch.isfinite(s).all()), f"samples {tuple(s.shape)}")
    inside = ((s >= fitter.prior.low) & (s <= fitter.prior.high)).all(-1)
    truth = torch.as_tensor(fitter.feature_params[held], device=dev)
    z_err = (s[..., 1].median(dim=1).values - truth[:, 1]).abs()
    log(f"[simformer] draws inside the prior box "
        f"{float(inside.float().mean()):.4f}; median |z error| "
        f"{float(z_err.median()):.3f} (readings after "
        f"{len(hist['val'])} epochs)")
    # card against CPU from the same weights
    cpu = ts.SimformerPosterior.from_state_dict(post.state_dict(),
                                                device="cpu")
    g = torch.Generator().manual_seed(2)
    v = torch.randn(256, n_tok, generator=g)
    t = torch.rand(256, generator=g) * 0.999 + 1e-3
    cond = (torch.rand(256, n_tok, generator=g) < 0.5).float()
    with torch.no_grad():
        card = post.model.score(v.to(dev), t.to(dev), cond.to(dev)).cpu()
        ref = cpu.model.score(v, t, cond)
    rel = float((card - ref).abs().max() / ref.abs().max())
    theta_q = fitter.feature_params[held[:4]].repeat(64, 0)
    x_q = fitter.features[held[:4]].repeat(64, 0)
    # the eager run first: it also takes the forward-AD kernels' first-use
    # set-up out of the graphed run's time
    lp_eager = post.log_prob(theta_q, x_q, n_steps=20, graphed=False)
    lp_card, secs = _timed(lambda: post.log_prob(theta_q, x_q, n_steps=20))
    lp_cpu = cpu.log_prob(theta_q, x_q, n_steps=20)
    dlp = float((lp_card.cpu() - lp_cpu).abs().max())
    log(f"[simformer] card vs CPU on 256 rows: score rel {rel:.3e} (tol "
        f"{TOL_SCORE}); log_prob (20 PF-ODE steps, 6 JVP directions) "
        f"max |diff| {dlp:.3e} (tol {TOL_SF_LOGP}), {secs:.2f} s on the "
        f"card graphed (capture included); graphed vs eager ODE equal: "
        f"{bool(torch.equal(lp_card, lp_eager))}; log p median "
        f"{float(lp_cpu.median()):.3f}")
    check(rel < TOL_SCORE, "simformer score: card disagrees with the CPU")
    check(dlp < TOL_SF_LOGP, "simformer log_prob: card disagrees with CPU")
    check(bool(torch.equal(lp_card, lp_eager)),
          "the graphed PF-ODE disagrees with the eager one")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "simformer.pkl")
        sf.save_state(path)
        back = tt.SBIFitter.load_saved_model(path, device=dev)
    check(back.engine == "simformer", "saved engine")
    a = sf.sample_posterior(fitter.features[held[:8]], 32,
                            torch.Generator(device=dev).manual_seed(5))
    b = back.sample_posterior(fitter.features[held[:8]], 32,
                              torch.Generator(device=dev).manual_seed(5))
    check(bool(np.array_equal(a, b)), "the saved simformer draws otherwise")
    log("[simformer] save_state -> load_saved_model: the same draws")
    counts = _counts(k1, pk)
    check(counts == (0, 0, 0), f"phase 26 launched kernels {counts}")
    return counts


def hpo_phase(tt, k1, pk, lib, dev):
    """Phase 27: `optimize_sbi` with a median pruner, `sweep_learning_rates`
    and `run_from_config` with an optuna block, on phase 4's library."""
    from synference_tpu_torch import hpo

    fitter = tt.SBIFitter(
        photometry=lib["photometry"].T[::HPO_STRIDE],
        parameters=lib["parameters"].T[::HPO_STRIDE],
        parameter_names=lib["parameter_names"],
        filter_codes=lib["filter_codes"], device=dev)
    fitter.create_feature_array(tt.FeatureConfig(
        filter_codes=tuple(CODES), unit="asinh", depths_ab=(29.5,) * 7,
        n_scatters=1, include_errors=True))
    (study, best), secs = _timed(lambda: hpo.optimize_sbi(
        fitter, model_type="nsf", search_space=HPO_SPACE, n_trials=4,
        max_epochs=HPO_EPOCHS, seed=HPO_SEED, verbose=False,
        pruner=hpo.MedianPruner(n_startup_trials=1, n_warmup_steps=1)))
    states = [(t["state"], len(t["intermediate"]),
               t["params"]["learning_rate"]) for t in study.trials]
    log(f"[hpo] optimize_sbi 4 trials x <= {HPO_EPOCHS} epochs on "
        f"{fitter.features.shape[0]} rows in {secs:.2f} s: (state, epochs "
        f"trained, lr) {states}; best {best}")
    pruned = [t for t in study.trials if t["state"] == "PRUNED"]
    check(bool(pruned) and all(len(t["intermediate"]) < HPO_EPOCHS
                               for t in pruned),
          "no trial was pruned mid-run")
    check(best["learning_rate"] == 7e-4, f"best trial {best}")
    flow = tt.build_flow("nsf", 6, fitter.features.shape[1],
                         hidden_features=32, num_transforms=4, device=dev)
    out, secs = _timed(lambda: hpo.sweep_learning_rates(
        flow, fitter.feature_params, fitter.features, SWEEP_RATES,
        config=tt.TrainConfig(batch_size=2048, max_epochs=HPO_EPOCHS),
        generator=torch.Generator(device=dev).manual_seed(0)))
    log(f"[hpo] sweep_learning_rates {SWEEP_RATES} as one 4-member run in "
        f"{secs:.2f} s: best val {np.round(out['best_val'], 4).tolist()}, "
        f"best lr {out['best_lr']}")
    check(out["result"].n_members == 4
          and out["best_index"] == int(np.argmin(out["best_val"]))
          and out["best_lr"] != SWEEP_RATES[0], "the sweep's winner")
    lead = out["params"]["flow"]["blocks"][0][0]["w"]
    check(bool(torch.equal(lead, out["result"].params["flow"]["blocks"][0][
        0]["w"][out["best_index"]])), "the winner's parameters")
    cfg = {"max_epochs": 2, "verbose": False, "train_args": {
        "skip_optimization": False,
        "fixed_params": {"model_choice": "nsf"},
        "optuna": {"n_trials": 2, "search_space": {
            k: list(v) for k, v in HPO_SPACE.items()}}}}
    fitted, secs = _timed(lambda: tt.run_from_config(cfg, fitter=fitter,
                                                     device=dev))
    log(f"[hpo] run_from_config with an optuna block (2 trials, then the "
        f"best retrained) in {secs:.2f} s")
    check(len(fitted.hpo_study.trials) == 2
          and fitted.train_result is not None, "the optuna block")
    counts = _counts(k1, pk)
    check(counts == (0, 0, 0), f"phase 27 launched kernels {counts}")
    return counts


def paper63_twin(tt, k1, pk, sim, dev):
    """Phase 28: `examples/paper63_e2e_torch.py` at full width (phase 1's
    grid, all 63 curves), 2^16 rows, 2 epochs, one member."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "paper63_e2e_torch", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "examples", "paper63_e2e_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    res = twin.main(P63_ROWS, None, "cuda", grid=sim.grid,
                    max_epochs=P63_EPOCHS, n_nets=1, stop_after=P63_EPOCHS)
    counts = _counts(k1, pk)
    log(f"[paper63] {res['n_library']} rows x {res['n_filters']} bands, "
        f"{res['feature_dim']} features: timings {res['timings']}; K1 "
        f"launches {res['k1_launches']}; TARP "
        f"{res['tarp_deviation']:.4f}, R2 {res['r2']} after {res['epochs']} "
        f"epochs (readings)")
    check(res["n_filters"] == 63 and res["feature_dim"] == 126,
          "paper-63 widths")
    check(res["k1_launches"] >= 1 and counts[0] == res["k1_launches"],
          f"paper-63 generate launched K1 {res['k1_launches']} times")
    check(bool(np.isfinite(res["tarp_deviation"])
               and np.isfinite(res["r2"]).all()), "paper-63 metrics")
    return counts


def parallel_phase(tt, k1, pk, sim, gen, fitter, dev):
    """Phase 29: parallel/ on a one-rank NCCL group: sharded generate
    (z-sorted and dense) against generate, sharded photometry through K2,
    the sharded step against the trainer's, padded sampling, the directory
    checkpoint."""
    import socket

    import torch.distributed as dist

    from synference_tpu_torch import parallel as par
    from synference_tpu_torch.flows.base import tree_leaves
    from synference_tpu_torch.train import (_EnsembleState, _npe_loss,
                                            load_checkpoint, save_checkpoint)

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    check(par.initialize_multihost(f"localhost:{port}", 1, 0, device="cuda")
          == (0, 1), "process group")
    mesh = par.make_mesh(device="cuda")
    counts = [0, 0, 0]

    def counted(fn):
        _zero_counts(k1, pk)
        out = fn()
        torch.cuda.synchronize()
        for i, c in enumerate(_counts(k1, pk)):
            counts[i] += c
        return out

    ref = gen.generate(PAR_ROWS, batch_size=BATCH, seed=5,
                       device_sampling=False)
    lib, secs = _timed(lambda: counted(lambda: par.sharded_generate(
        gen, PAR_ROWS, mesh, batch_size=BATCH, seed=5)))
    log(f"[parallel] sharded_generate({PAR_ROWS}) z-sorted, 1 NCCL rank: "
        f"{secs:.3f} s, K1 launches {counts[0]}")
    check(np.array_equal(lib["photometry"], ref["photometry"])
          and np.array_equal(lib["parameters"], ref["parameters"]),
          "sharded z-sorted generate differs from generate")
    dense = counted(lambda: par.sharded_generate(
        gen, 2 * BATCH, mesh, batch_size=BATCH, seed=6, zsorted=False))
    k2_dense = counts[1]
    th = torch.as_tensor(dense["parameters"].T, device=dev)
    plain = torch.cat([sim.photometry(th[i:i + BATCH], row_offset=i)
                       for i in (0, BATCH)]).cpu().numpy().T
    check(np.array_equal(dense["photometry"], plain),
          "sharded dense generate differs from photometry()")
    hsim = headline_model(tt, dev, "interp")
    theta = headline_theta(dev)
    fn = par.make_sharded_photometry_fn(hsim, mesh)
    before = counts[1]
    out = counted(lambda: fn(theta)["photometry_njy"])
    check(counts[1] - before == 1, "sharded photometry did not launch K2")
    check(bool(torch.equal(out, hsim.photometry(theta))),
          "sharded photometry differs from photometry()")
    log(f"[parallel] dense sharded generate of {2 * BATCH} rows: K2 "
        f"launches {k2_dense}, bitwise photometry(); sharded photometry of "
        f"{HEADLINE_BATCH} headline rows: 1 K2 launch, bitwise")
    tb = torch.as_tensor(fitter.feature_params[:2048], device=dev)
    xb = torch.as_tensor(fitter.features[:2048], device=dev)
    params = par.init_sharded_ensemble(
        fitter.flow, torch.Generator(device=dev).manual_seed(0), tb, xb, 2,
        mesh)
    cfg = tt.TrainConfig(learning_rate=7e-4)
    state = _EnsembleState(fitter.flow.init(
        torch.Generator(device=dev).manual_seed(0), tb, xb, n_members=2),
        torch.full((2,), 7e-4, device=dev), cfg)
    step, place = par.make_sharded_train_step(fitter.flow, mesh, cfg)
    opt = par.init_opt_state(params)
    for _ in range(3):
        params, opt, losses = step(params, opt, place(tb), place(xb))
        ref_loss = state.train_step(_npe_loss(fitter.flow),
                                    tb.expand(2, -1, -1),
                                    xb.expand(2, -1, -1))
        check(bool(torch.equal(losses, ref_loss)),
              "the sharded step's loss differs from the trainer's")
    flat = torch.cat([a.reshape(2, -1) for a in tree_leaves(params)], 1)
    check(bool(torch.equal(flat, state.flat)),
          "the sharded step's parameters differ from the trainer's")
    log("[parallel] NSF 69x15 x2 sharded step (NCCL all_reduce over data) "
        "x3 on 2048 rows: bitwise the trainer's step")
    s = counted(lambda: par.sharded_sample_batch(
        fitter.posterior, fitter.features[:13], mesh, n_samples=64))
    q = counted(lambda: par.sharded_fit_catalogue(
        fitter.posterior, fitter.features[:11], mesh, n_samples=256))
    check(s.shape == (13, 64, 6) and q.shape == (11, 3, 6)
          and bool(np.isfinite(s).all() and (q[:, 0] <= q[:, 2]).all()),
          "sharded sampling")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck")
        blob = {"flat": state.flat.cpu().numpy(), "step": 3}
        save_checkpoint(path, blob, backend="orbax")
        back = load_checkpoint(path, backend="orbax")
        files = sorted(os.listdir(path))
    check(np.array_equal(back["flat"], blob["flat"]) and back["step"] == 3,
          "directory checkpoint")
    log(f"[parallel] sharded sampling of 13 objects (padded) and a quantile "
        f"table of 11; directory checkpoint {files} read back")
    dist.destroy_process_group()
    return tuple(counts)


# -- phases 30-31: K1 and K2 with a second per-row input ----------------------
# phase 30, the birth cloud (Charlot & Fall 2000 dust: τ_BC over the grid's
# first 25 ages, 300 of 768 cells, both screens (λ/5500 Å)^−0.7); phase 31,
# Pacman emission (fesc a θ column: fesc·incident + (1 − fesc)·total·
# exp(−τ_V k), both tables in the first product; a tenth of the rows at
# fesc = 0 and a tenth at fesc = 1). `zero` is the input that gives the
# one-screen kernel's bits, `drop` the arguments the one-screen call leaves
# out, `tables` the spectra tables the first product reads.
SECOND_INPUTS = {
    "birth cloud": dict(
        name="tau_v_bc", prior=(0.0, 2.0), seed=30, tables=1, key="tau_bc",
        drop=("tau_bc", "n_young"), ends=False,
        emission=dict(reprocessed_types=("total",), dust_law="power_law",
                      dust_params=(("slope", -0.7),),
                      tau_v_bc_param="tau_v_bc")),
    "pacman": dict(
        name="fesc", prior=(0.0, 1.0), seed=31, tables=2, key="fesc_row",
        drop=("fesc_row", "sed_inc"), ends=True,
        emission=dict(incident_type="incident", reprocessed_types=("total",),
                      fesc="fesc")),
}


def screen_bound(b, c, w, kf, bf16_cols, f8, tables) -> dict:
    """The bound of a K1 sub-chunk or a K2 batch whose first product reads
    `tables` spectra tables: 2·tables·C·W FLOPs a row (a rescale's exp and
    multiply per (row, column) are not counted), each table read once."""
    return bound(flops_fp32=2.0 * tables * b * c * w,
                 flops_bf16=2.0 * b * w * bf16_cols,
                 nbytes=4 * (b * c + tables * c * w + w + kf
                             + (2 + tables) * b + b * f8) + 2 * w * kf)


def second_input(tt, k1, sim, dev, tag: str) -> dict:
    """Phase 30 (`tag` "birth cloud") or 31 ("pacman"): K1 and K2 with
    their second per-row input (`SECOND_INPUTS`) on phase 1's grid at the
    north-star bands (F8 8, lone blocks) and all 63 bands (F8 64,
    clusters), on 65536 rows each: against their plain versions and the
    exact gate, two runs bitwise equal, bitwise equal to their 8-band
    slices, and with the input at zero bitwise equal to the one-screen
    kernel; timed beside their bound (`screen_bound`) and beside the
    one-screen kernel on the same rows. Returns {"K1": {f8: stats}, "K2":
    {f8: stats}}."""
    spec = SECOND_INPUTS[tag]
    out = {"K1": {}, "K2": {}}
    tol = dict(tol_p99=TOL_STAGED_P99, tol_max=TOL_STAGED_MAX, tag=tag)
    for filters in (sim.filters, tt.load_instrument_filters()):
        m = tt.BatchSEDSimulator(
            sim.grid, filters, PNAMES + (spec["name"],), sfh="lognormal",
            zdist="delta", emission=tt.EmissionConfig(**spec["emission"]),
            device=dev)
        f8 = m._f8
        check(m._window_mega_supported() and m._mega_supported()
              and (spec["name"] != "tau_v_bc" or m._n_young == 300),
              f"the {tag} model skips K1/K2")
        gen = tt.LibraryGenerator(m, dict(PRIOR, **{spec["name"]:
                                                    spec["prior"]}),
                                  unlog_keys=["log10_peak_age"], device=dev)
        theta = gen.sample_parameters_device(
            HEADLINE_BATCH, torch.Generator(device=dev).manual_seed(
                spec["seed"]))
        if spec["ends"]:
            ends = torch.randperm(HEADLINE_BATCH, device=dev,
                                  generator=torch.Generator(device=dev)
                                  .manual_seed(32))[:HEADLINE_BATCH // 5]
            theta[ends[:HEADLINE_BATCH // 10], -1] = 0.0
            theta[ends[HEADLINE_BATCH // 10:], -1] = 1.0
        z = theta[:, PNAMES.index("redshift")]
        sorted_theta = theta[torch.sort(z, stable=True).indices]
        chunk, sub, kc, w_cols, k0, l0 = m._plan_windows(sorted_theta, 1024)
        bounds = [screen_bound(*x["sfzh"].shape, x["sed_w"].shape[1],
                               x["kc"] * x["f8"], x["kc"] * x["f8"],
                               x["f8"], spec["tables"])
                  for *_, x in m._window_calls(chunk, sub, w_cols, kc, k0,
                                               l0)]
        k1b = {"bound_ms": sum(x["bound_ms"] for x in bounds),
               "bound_by": ("operations" if all(
                   x["bound_by"] == "operations" for x in bounds)
                   else "bytes"),
               "tf32x3_bound_ms": sum(x["tf32x3_bound_ms"] for x in bounds)}
        g = m._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
        params = m.theta_dict(theta)
        a = dict(k2_args(m, theta), **m._screens(params, params["tau_v"]))
        if spec["tables"] == 2:
            a["sed_inc"] = m._mega_tables["inc"]
        b, c = a["sfzh"].shape
        n_l = a["sed_w"].shape[1]
        k2b = screen_bound(b, c, n_l, a["kc"] * f8, 4 * f8, f8,
                           spec["tables"])
        tables = m._mega_tables
        for name, args, bnd, n_knots, launch, plain, exact in (
                ("K1", g, k1b, m._n_knots,
                 lambda t, f, x: k1.fused_window_photometry_grouped(
                     **dict(x, tables=t, f8=f)),
                 lambda x: k1.fused_window_photometry_grouped_reference(**x),
                 lambda x: k1.fused_window_photometry_grouped_reference(
                     **x, first_product=k1.exact_first_product)),
                ("K2", a, k2b, a["kc"],
                 lambda t, f, x: k2_call(k1, dict(
                     x, sed_w=t["sed"], sed_inc=t.get("inc"),
                     curve_w=t["curve"], knot_w=t["knot"], den_w=t["den"],
                     f8=f)),
                 lambda x: k1.fused_window_photometry_reference(**x),
                 lambda x: k1.fused_window_photometry_exact(**x))):
            log(f"[{tag}] {name} at F8 {f8}: {b} rows, C={c}, "
                f"{spec['tables']} table(s)")
            st = cluster_check(
                k1, name, lambda t, f: launch(t, f, args),
                lambda: plain(args), lambda: exact(args), tables, n_knots,
                f8, bnd, **tol)
            key = spec["key"]
            zero = dict(args, **{key: torch.zeros_like(args[key])})
            one = {k: v for k, v in args.items() if k not in spec["drop"]}
            check(torch.equal(launch(tables, f8, zero),
                              launch(tables, f8, one)),
                  f"{name} with {key} = 0 differs from the one-screen "
                  "kernel")
            st["one_screen_ms"] = time_ms(lambda: launch(tables, f8, one),
                                          reps=5)
            log(f"[{tag}] {name} at F8 {f8}: {st['ms']:.4f} ms, the "
                f"one-screen kernel on the same rows {st['one_screen_ms']:.4f}"
                f" ms ({st['ms'] / st['one_screen_ms']:.3f}x); {key} = 0 "
                "gives its bits")
            out[name][f8] = st
    return out


def sfzh_phase(sim, gen, dev) -> dict:
    """Phase 32: the SFZH kernel against the plain `_sfzh` on 65536 rows of
    the phase-1 model, and its times (`time_ms`) beside its bound."""
    from synference_tpu_torch import sfh
    from synference_tpu_torch.ops import sfzh as so

    theta = gen.sample_parameters_device(
        HEADLINE_BATCH, torch.Generator(device=dev).manual_seed(32))
    params = sim.theta_dict(theta)
    check(sim._sfzh_kernel_runs(HEADLINE_BATCH, dev),
          "the north-star model skips the SFZH kernel")
    before = so.lognormal_delta_sfzh.launches
    got, got_m = sim._sfzh(params)
    alone, _ = sim._sfzh(params, marginal=False)
    sim._mega_off = True
    try:
        want, want_m = sim._sfzh(params)
        plain_ms = time_ms(lambda: sim._sfzh(params, marginal=False))
    finally:
        sim._mega_off = False
    check(so.lognormal_delta_sfzh.launches == before + 2,
          "the plain `_sfzh` launched the SFZH kernel")
    check(torch.equal(got, want) and torch.equal(alone, want)
          and torch.equal(got_m, want_m),
          "the SFZH kernel differs from the plain `_sfzh`")
    p = dict(params, max_age=sim._max_age(params))
    mu, tau = sfh.lognormal_shape(p)
    args = (p["max_age"], mu[:, 0], tau[:, 0], 10.0 ** params["log10_mass"],
            *sfh.delta_cells(params, sim._log10_mets), sim._sampling.edges,
            sim._log10_mets.shape[0])
    b, c = got.shape
    n_ages = got_m.shape[1]
    st = bound(0.0, 0.0, 4 * (b * c + 5 * b + n_ages + 1) + 8 * b)
    st.update(
        ms=time_ms(lambda: so.lognormal_delta_sfzh(*args, marginal=False),
                   reps=50),
        marginal_ms=time_ms(lambda: so.lognormal_delta_sfzh(*args), reps=50),
        sfzh_ms=time_ms(lambda: sim._sfzh(params, marginal=False)),
        plain_ms=plain_ms, max_abs_err=0.0)
    st["share_of_bound"] = st["bound_ms"] / st["ms"]
    log(f"[sfzh] {b} x {c}: kernel {st['ms']:.4f} ms (with the age "
        f"marginal {st['marginal_ms']:.4f}) against a bound of "
        f"{st['bound_ms']:.4f} ms ({st['bound_by']}, share "
        f"{st['share_of_bound']:.3f}); the whole `_sfzh` "
        f"{st['sfzh_ms']:.4f} ms, the plain `_sfzh` {plain_ms:.4f} ms; "
        "bit for bit the plain SFZH and marginal")
    return st


def main() -> None:
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import synference_tpu_torch as tt
    from synference_tpu_torch.ops import _cuda
    from synference_tpu_torch.ops import fused_sed as k1
    from synference_tpu_torch.ops import photometry_kernel as pk
    from synference_tpu_torch.ops import sfzh as sfzh_op

    path, secs, compiler_log = _cuda.build_library()
    _cuda.load_library()
    log(f"[build] {path.name} built in {secs:.1f} s (K1, K2, K3, SFZH)")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    t0 = time.perf_counter()
    sim, gen = build_model(tt, dev)
    torch.cuda.synchronize()
    log(f"[model] setup {time.perf_counter() - t0:.1f} s: "
        f"{len(sim.filters)} bands, {sim.grid.n_ages}x{sim.grid.n_mets}x"
        f"{sim.grid.n_wav} grid, {sim._n_knots} knots (delta "
        f"{sim._knot_delta}), lambda support {sim._l_sup} columns")
    k1_stats, (_, _, _, a) = kernel_vs_plain(sim, gen, k1)
    lib, launches, sfzh_main = main_path(sim, gen, k1, a["kc"],
                                         a["sed_w"].shape[1])
    k1_stats["launches"] = launches
    features(tt, lib, dev)
    k2_stats = dense_photometry(tt, k1, dev)
    k2_north_star(k1, sim, gen, dev)
    k3_stats = exact_spectra(tt, pk, dev, sim)
    fitter = train(tt, lib, dev)
    posterior(tt, fitter, dev)
    # phase 20 retrains this fitter as NLE and NRE; phases 22-23 use the NPE
    npe = {k: getattr(fitter, k)
           for k in ("engine", "flow", "train_result", "posterior")}
    p63 = {}  # phase 16: its driven path's launches, K1 and K2 at F8 64
    for name, phase in (
            ("11 library file", lambda: library_file(tt, dev)),
            ("12 auto and resume",
             lambda: auto_and_resume(tt, sim, gen, k1, lib)),
            ("13 features", lambda: features_on_card(tt, lib, dev)),
            ("14 catalogue", lambda: catalogue(tt, fitter, sim, k1, dev)),
            ("15 families and particles",
             lambda: families_and_particles(tt, k1, sim, dev)),
            ("16 paper-63 conv and auto",
             lambda: p63.update(paper63(tt, k1, pk, sim, dev))),
            ("17 spectral path", lambda: spectral_path(tt, dev)),
            ("18 noise models and lines",
             lambda: noise_and_lines(tt, lib, dev))):
        t0 = time.perf_counter()
        phase()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    # this slice's paths, each kernel's count set to 0 before them: phases
    # 19-20 train on phase 4's library and launch no kernel; phase 21
    # launches K2 in every round's simulations
    _zero_counts(k1, pk)
    for name, phase in (("19 flow zoo", lambda: flow_zoo(tt, lib, dev)),
                        ("20 NLE and NRE", lambda: engines(tt, fitter, dev))):
        t0 = time.perf_counter()
        phase()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    k2_19_20 = k1.fused_sed_photometry.launches
    t0 = time.perf_counter()
    k2_online = online_engines(tt, k1, dev)
    log(f"[phase] 21 online engines: {time.perf_counter() - t0:.1f} s")
    k1_19_21 = k1.fused_window_photometry.launches
    k3_19_21 = pk.shift_photometry_num.launches
    # phases 22-23, each with the counts set to 0 just before it: the
    # fitters launch no kernel (their simulator's `_mega_off`), the mock
    # catalogue one K2 and the gradient-free SMC of the model comparison K2
    for k, v in npe.items():
        setattr(fitter, k, v)
    t_grad = time.perf_counter()
    slice_counts = {}
    for name, phase in (
            ("22", lambda: gradient_fitters(tt, k1, pk, sim, fitter, dev)),
            ("23", lambda: diagnostics_rest(tt, k1, pk, fitter, lib, dev))):
        _zero_counts(k1, pk)
        t0 = time.perf_counter()
        slice_counts[name] = phase()
        log(f"[phase] {name} {('gradient fitters', 'diagnostics')[int(name) - 22]}"
            f": {time.perf_counter() - t0:.1f} s, launches (K1, K2, K3) "
            f"{slice_counts[name]}")
    log(f"[phase] 22-23 together: {time.perf_counter() - t_grad:.1f} s")
    # phases 24-25, each with the counts set to 0 just before its driven
    # path: the AGN simulators launch no kernel (their forward-model gate),
    # the composite's stellar component K2 once per photometry() call
    t_agn = time.perf_counter()
    _zero_counts(k1, pk)
    lib24, slice_counts["24"] = agn_path(tt, k1, pk, dev)
    log(f"[phase] 24 AGN: {time.perf_counter() - t_agn:.1f} s, launches "
        f"(K1, K2, K3) {slice_counts['24']}")
    t0 = time.perf_counter()
    _zero_counts(k1, pk)
    slice_counts["25"] = composite_path(tt, k1, pk, lib, lib24, dev)
    log(f"[phase] 25 composite: {time.perf_counter() - t0:.1f} s, launches "
        f"(K1, K2, K3) {slice_counts['25']}")
    log(f"[phase] 24-25 together: {time.perf_counter() - t_agn:.1f} s")
    # phases 26-29, each with the counts set to 0 just before it: the
    # simformer and HPO train and sample without a kernel; the paper-63
    # twin's generate takes K1 ("auto" on one batch); parallel/ takes K1
    # in its z-sorted generate and K2 in its dense one
    t_new = time.perf_counter()
    for name, label, phase in (
            ("26", "simformer",
             lambda: simformer_phase(tt, k1, pk, fitter, dev)),
            ("27", "HPO", lambda: hpo_phase(tt, k1, pk, lib, dev)),
            ("28", "paper-63 twin",
             lambda: paper63_twin(tt, k1, pk, sim, dev)),
            ("29", "parallel",
             lambda: parallel_phase(tt, k1, pk, sim, gen, fitter, dev))):
        _zero_counts(k1, pk)
        t0 = time.perf_counter()
        slice_counts[name] = phase()
        log(f"[phase] {name} {label}: {time.perf_counter() - t0:.1f} s, "
            f"launches (K1, K2, K3) {slice_counts[name]}")
    log(f"[phase] 26-29 together: {time.perf_counter() - t_new:.1f} s")
    second = {}
    for phase, tag in (("30", "birth cloud"), ("31", "pacman")):
        t0 = time.perf_counter()
        second[tag] = second_input(tt, k1, sim, dev, tag)
        log(f"[phase] {phase} {tag}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sfzh_stats = sfzh_phase(sim, gen, dev)
    log(f"[phase] 32 SFZH: {time.perf_counter() - t0:.1f} s")
    by_phase = {"K1": {"4": k1_stats["launches"], "16": p63["counts"][0],
                       "19-21": k1_19_21},
                "K2": {"6": k2_stats["launches"], "16": p63["counts"][1],
                       "19-20": k2_19_20, "21": k2_online},
                "K3": {"8": k3_stats["launches"], "16": p63["counts"][2],
                       "19-21": k3_19_21}}
    for i, key in enumerate(("K1", "K2", "K3")):
        by_phase[key].update({ph: c[i] for ph, c in slice_counts.items()})
    for key, st in (("K1", k1_stats), ("K2", k2_stats), ("K3", k3_stats)):
        st["launches"] = sum(by_phase[key].values())

    rows = []
    for key, name, source, replaces, st in (
            ("K1", "K1 fused_window_photometry_grouped", "fused_window.cu",
             "synference_tpu/ops/fused_sed.py:167", k1_stats),
            ("K2", "K2 fused_sed_photometry", "fused_sed.cu",
             "synference_tpu/ops/fused_sed.py:167", k2_stats),
            ("K3", "K3 shift_photometry_num", "shift_num.cu",
             "synference_tpu/ops/photometry_kernel.py:342 and :233",
             k3_stats)):
        share = st["bound_ms"] / st["ms"]
        log(f"[summary] {name}: {st['ms']:.4f} ms against a bound of "
            f"{st['bound_ms']:.4f} ms ({st['bound_by']}): share of bound "
            f"{share:.3f}; {st['launches']} launches on the main path and this "
            f"slice's paths {by_phase[key]}")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"synference_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": st["launches"],
            "launches_by_phase": by_phase[key],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            "share_of_bound": share,
            "first_product_ms": st["first_product_ms"]})
        if key in p63:  # at the paper-63 width: F8 64, band-group clusters
            rows[-1]["paper63"] = {
                k: p63[key][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "share_of_bound", "max_abs_err",
                    "cluster", "resident_clusters")}
        for tag, phase in (("birth_cloud", second["birth cloud"]),
                           ("pacman", second["pacman"])):
            if key in phase:  # phases 30 and 31, at F8 8 and F8 64
                rows[-1][tag] = {
                    f8: {k: st[k] for k in (
                        "ms", "one_screen_ms", "plain_ms", "bound_ms",
                        "bound_by", "share_of_bound", "max_abs_err",
                        "cluster")}
                    for f8, st in phase[key].items()}
    rows.append({
        "name": "SFZH lognormal_delta_sfzh", "route": "cuda",
        "source": "synference_tpu_torch/csrc/sfzh.cu",
        # the JAX package's `_sfzh` (synference_tpu/sed.py:541) is XLA code
        "replaces": None, "launches": sfzh_op.lognormal_delta_sfzh.launches,
        "launches_by_phase": {"4": sfzh_main},
        "library_ms": None, "first_product_ms": None,
        **{k: sfzh_stats[k] for k in (
            "ms", "marginal_ms", "sfzh_ms", "plain_ms", "bound_ms",
            "bound_by", "share_of_bound", "max_abs_err")}})
    log(f"[summary] SFZH lognormal_delta_sfzh: {sfzh_stats['ms']:.4f} ms "
        f"against a bound of {sfzh_stats['bound_ms']:.4f} ms: share of "
        f"bound {sfzh_stats['share_of_bound']:.3f}; "
        f"{sfzh_op.lognormal_delta_sfzh.launches} launches in all, "
        f"{sfzh_main} on the main path")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
