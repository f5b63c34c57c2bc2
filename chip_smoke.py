#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (`synference_tpu_torch`).

Drives the port's paths once on one NVIDIA card. The mock-library path and
the NPE path on top of it (features, NSF ensemble training, posterior
sampling, calibration metrics, a saved model) run at the north-star width (64 ages × 12 metallicities × 10⁴ λ grid, 7
NIRCam bands, lognormal SFH, delta-Z, Calzetti screen, Inoue14 IGM); the
dense simulator path at `bench.py`'s headline width (48 ages × 8
metallicities × 2048 λ from 300 Å, 7 tophat bands, the same physics, 65536
unsorted θ):

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles every kernel in `synference_tpu_torch/csrc/` (K1, K2,
   K3), one nvcc process per source, all started together;
3. K1 vs plain: K1 against its plain PyTorch version on main-path
   sub-chunks (orders 1 and 3) and, in its one-launch form, on a whole
   main-path batch of 64 sub-chunks, with both timings per batch beside
   the sum of the sub-chunks' bounds and the cuBLAS first product, and a
   check that the bound rejects the plain version with a TF32 or a bf16
   first product;
4. main path: `LibraryGenerator.generate(n=2^20, zsorted_fused=True)`,
   checking that K1 ran once per 65536-row batch, that the photometry is
   finite and non-negative, and that one sub-chunk agrees with the staged
   window body;
5. features: asinh features with depth noise and errors;
6. dense photometry: `sim.photometry(θ)` on the headline model launches K2
   once; K2 against its plain version (and the TF32 / bf16 power check),
   the result against the plain `_photometry_fused` route, with times;
7. K2 at the north-star width: one unsorted batch, K2 and its plain
   version, and both routes' times (the card's crossover record);
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
12. "auto" and resume: `generate(2^20, zsorted_fused="auto")` on the
   north-star model probes both window bodies (both times by CUDA events,
   the choice and its digest printed), counts K1's launches, and equals
   phase 4's bits when the fused body wins (within the staged-body bound
   when it loses); a second generator on the simulator does not probe; a
   2-batch run at the defaults takes K1 without a probe; a
   4-batch run interrupted after batch 2 by a deliberate exception resumes
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

Run from the repository root: `python3 chip_smoke.py`. Any failed phase
exits non-zero. The line before the last is a JSON summary of every kernel
on the path (with each kernel's share of its bound, and `first_product_ms`:
the fp32 first product alone as one cuBLAS `torch.matmul` with TF32 off, a
yardstick for the kernels' core that the port never calls); the last line
is `{"ok": true, "device": {...}}`.
"""

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
    theta, sub, bs, kc, w_cols = gen._draw_sorted(N_LIBRARY, BATCH, seed=0)
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
        worst["max_abs_err"] = max(worst["max_abs_err"], abs_err)
    check(torch.equal(out, k1.fused_window_photometry_grouped(**g)),
          "two K1 runs differ")
    subs = [a for *_, a in sim._window_calls(chunk, sub, w_cols, kc, k0, l0)]
    bounds = [k1_bound(a) for a in subs]
    worst["bound_ms"] = sum(b["bound_ms"] for b in bounds)
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
        f"{worst['bound_ms']:.4f} ms ({worst['bound_by']}); cuBLAS fp32 "
        f"first product of the batch's shape {worst['first_product_ms']:.4f}"
        f" ms (CUDA events); two runs bitwise equal")
    return worst, calls[0]


def bound_has_power(k1, a, name: str = "kernel") -> None:
    """The kernel bound must reject the shortcuts a kernel could take in its
    first product: the plain version with TF32, and with bf16 inputs. `a`
    holds K1's plain version's arguments (K2's plain version is K1's over
    the whole tables)."""
    ref = k1.fused_window_photometry_reference(**a)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = k1.fused_window_photometry_reference(**a)
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = k1.fused_window_photometry_reference(**dict(
        a, sfzh=a["sfzh"].bfloat16().float(),
        sed_w=a["sed_w"].bfloat16().float()))
    for low, out in (("TF32", tf32), ("bf16", bf16)):
        med, p99, mx, _ = rel_stats(out, ref)
        log(f"[{name}] plain with a {low} first product vs plain: rel "
            f"median={med:.3e} p99={p99:.3e} max={mx:.3e} (must exceed "
            f"{TOL_KERNEL_MAX})")
        check(mx > TOL_KERNEL_MAX,
              f"the {name} bound does not reject a {low} first product")


def main_path(sim, gen, k1, kc: int, w_cols: int):
    """The timed main-path run, with K1's launch count read around it."""
    gen.generate(n=65536, seed=1, zsorted_fused=True)  # warm-up, not counted
    torch.cuda.synchronize()
    k1.fused_window_photometry.launches = 0
    t0 = time.perf_counter()
    lib = gen.generate(n=N_LIBRARY, seed=0, zsorted_fused=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.fused_window_photometry.launches
    phot = lib["photometry"]
    n_batch = int(np.ceil(N_LIBRARY / BATCH))
    log(f"[main] generate(n={N_LIBRARY}) {wall:.3f} s = "
        f"{N_LIBRARY / wall:,.0f} SEDs/s; K1 launches {launches}")
    check(launches == n_batch,
          f"K1 launched {launches} times, expected {n_batch}")
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
    return lib, launches


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
    memory rate and its operations over the peak rate of their type."""
    t_ops = (flops_fp32 / PEAK_FP32_FLOP_S + flops_bf16 / PEAK_BF16_FLOP_S)
    t_bytes = nbytes / PEAK_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
    return k1.fused_sed_photometry(
        a["sfzh"], a["s_rel"], a["tau_v"], a["scale"], tables, a["kc"],
        a["delta"], a["f8"], order=a["order"], fesc=a["fesc"])


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
    check(torch.equal(out, k2_call(k1, a)), f"two K2 runs differ ({name})")
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
        f"({stats['bound_by']}), share "
        f"{stats['bound_ms'] / stats['ms']:.3f}; cuBLAS fp32 first product "
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


def training_parts(flow, theta, x, n_val: int):
    """One optimiser step and one validation pass over `n_val` rows of the
    north-star ensemble, as `train_ensemble` runs them, on freshly
    initialised members: (step, validate, state)."""
    from synference_tpu_torch import train as tr

    dev = flow.device
    cfg = tr.TrainConfig(batch_size=2048, learning_rate=7e-4)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    state = tr._new_state(flow, theta, x, cfg, N_NETS, g)
    loss_fn = tr._npe_loss(flow)
    rows = torch.randint(0, theta.shape[0], (N_NETS, cfg.batch_size),
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
    """Phase 12: "auto" on the north-star library, and chunk resume."""
    from synference_tpu_torch import library as tl

    n_batch = int(np.ceil(N_LIBRARY / BATCH))
    with tempfile.TemporaryDirectory() as tmp:
        tl.ZSORTED_PROBE_FILE = os.path.join(tmp, "zsorted_probe.json")
        k1.fused_window_photometry.launches = 0
        t0 = time.perf_counter()
        lib = gen.generate(n=N_LIBRARY, seed=0, zsorted_fused="auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1.fused_window_photometry.launches
        rec = gen.last_probe
        check(rec is not None and rec["source"] == "probe",
              f"auto did not probe: {rec}")
        fused = rec["fused"]
        log(f"[auto] generate(n={N_LIBRARY}, zsorted_fused='auto') "
            f"{wall:.3f} s with the probe: staged body {rec['staged_ms']:.4f}"
            f" ms, fused body (K1) {rec['fused_ms']:.4f} ms per batch of "
            f"{BATCH} (CUDA events, one warm call each); choice "
            f"{'fused' if fused else 'staged'}; digest {rec['digest']}; K1 "
            f"launches {launches}")
        check(launches == (n_batch + 2 if fused else 2),
              f"K1 launched {launches} times")
        if fused:
            check(np.array_equal(lib["photometry"], lib4["photometry"]),
                  "auto (fused) differs from phase 4's bits")
            log("[auto] photometry equals phase 4's bits")
        else:
            med, p99, mx, _ = rel_stats(torch.as_tensor(lib["photometry"].T),
                                        torch.as_tensor(lib4["photometry"].T))
            log(f"[auto] staged vs phase 4: rel median={med:.3e} "
                f"p99={p99:.3e} max={mx:.3e}")
            check(p99 < TOL_STAGED_P99 and mx < TOL_STAGED_MAX,
                  "auto (staged) disagrees with phase 4")
        again = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                                    device=sim.device)
        k1.fused_window_photometry.launches = 0
        again.generate(n=N_LIBRARY, seed=0)
        torch.cuda.synchronize()
        check(again.last_probe["source"] == "simulator",
              "a second generator probed again")
        check(k1.fused_window_photometry.launches == (n_batch if fused
                                                      else 0),
              "the second run took another body")
        log(f"[auto] a second generator on the simulator: no probe, K1 "
            f"launches {k1.fused_window_photometry.launches}")
        sim.__dict__.pop("_zsorted_fused_probe")
        short = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                                    device=sim.device)
        k1.fused_window_photometry.launches = 0
        short.generate(n=2 * BATCH, seed=7)
        torch.cuda.synchronize()
        check(short.last_probe == {"source": "short run", "fused": True}
              and k1.fused_window_photometry.launches == 2,
              f"a 2-batch run at the defaults: {short.last_probe}, K1 "
              f"launches {k1.fused_window_photometry.launches}")
        log("[auto] a 2-batch run at the defaults: no probe, K1 launches 2")

        args = dict(n=4 * BATCH, seed=5, zsorted_fused=fused)
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

    path, secs, compiler_log = _cuda.build_library()
    _cuda.load_library()
    log(f"[build] {path.name} built in {secs:.1f} s (K1, K2, K3)")
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
    lib, launches = main_path(sim, gen, k1, a["kc"], a["sed_w"].shape[1])
    k1_stats["launches"] = launches
    features(tt, lib, dev)
    k2_stats = dense_photometry(tt, k1, dev)
    k2_north_star(k1, sim, gen, dev)
    k3_stats = exact_spectra(tt, pk, dev, sim)
    fitter = train(tt, lib, dev)
    posterior(tt, fitter, dev)
    for name, phase in (
            ("11 library file", lambda: library_file(tt, dev)),
            ("12 auto and resume",
             lambda: auto_and_resume(tt, sim, gen, k1, lib)),
            ("13 features", lambda: features_on_card(tt, lib, dev)),
            ("14 catalogue", lambda: catalogue(tt, fitter, sim, k1, dev))):
        t0 = time.perf_counter()
        phase()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")

    rows = []
    for name, source, replaces, st in (
            ("K1 fused_window_photometry_grouped", "fused_window.cu",
             "synference_tpu/ops/fused_sed.py:167", k1_stats),
            ("K2 fused_sed_photometry", "fused_sed.cu",
             "synference_tpu/ops/fused_sed.py:167", k2_stats),
            ("K3 shift_photometry_num", "shift_num.cu",
             "synference_tpu/ops/photometry_kernel.py:342 and :233",
             k3_stats)):
        share = st["bound_ms"] / st["ms"]
        log(f"[summary] {name}: {st['ms']:.4f} ms against a bound of "
            f"{st['bound_ms']:.4f} ms ({st['bound_by']}): share of bound "
            f"{share:.3f}; {st['launches']} launches on the main path")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"synference_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": st["launches"],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            "share_of_bound": share,
            "first_product_ms": st["first_product_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
