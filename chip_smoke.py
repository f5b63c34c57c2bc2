#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (`synference_tpu_torch`).

Drives the port's mock-library main path once on one NVIDIA card at the
north-star width (64 ages × 12 metallicities × 10⁴ λ grid, 7 NIRCam bands,
lognormal SFH, delta-Z, Calzetti screen, Inoue14 IGM):

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the K1 kernel from `synference_tpu_torch/csrc/`;
3. kernel vs plain: K1 against its plain PyTorch version on main-path
   sub-chunks (orders 1 and 3), with both timings, and a check that the
   bound rejects the plain version with a TF32 or a bf16 first product;
4. main path: `LibraryGenerator.generate(n=2^20, zsorted_fused=True)`,
   checking that K1 ran, that the photometry is finite and non-negative,
   and that one sub-chunk agrees with the staged window body;
5. features: asinh features with depth noise and errors.

Run from the repository root: `python3 chip_smoke.py`. Any failed phase
exits non-zero. The line before the last is a JSON summary of every kernel
on the path; the last line is `{"ok": true, "device": {...}}`.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_LIBRARY = 2**20
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
# input (measured p99 2.7e-7, max 4.1e-5 on an H100)
TOL_STAGED_P99, TOL_STAGED_MAX = 1e-5, 1e-3


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


def kernel_vs_plain(sim, gen, k1):
    """K1 and its plain version on the main path's own sub-chunk inputs: the
    first sub-chunk of the run and one from its middle, orders 1 and 3."""
    theta, sub, bs, kc, w_cols = gen._draw_sorted(N_LIBRARY, 65536, seed=0)
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
    bound_has_power(k1, a)
    worst["ms"] = time_ms(lambda: k1.fused_window_photometry(**a))
    worst["plain_ms"] = time_ms(
        lambda: k1.fused_window_photometry_reference(**a))
    log(f"[kernel] time per sub-chunk call (order 3): K1 {worst['ms']:.4f} ms,"
        f" plain {worst['plain_ms']:.4f} ms")
    return worst, calls[0]


def bound_has_power(k1, a) -> None:
    """The kernel bound must reject the shortcuts a kernel could take in its
    first product: the plain version with TF32, and with bf16 inputs."""
    ref = k1.fused_window_photometry_reference(**a)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = k1.fused_window_photometry_reference(**a)
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = k1.fused_window_photometry_reference(**dict(
        a, sfzh=a["sfzh"].bfloat16().float(),
        sed_w=a["sed_w"].bfloat16().float()))
    for name, out in (("TF32", tf32), ("bf16", bf16)):
        med, p99, mx, _ = rel_stats(out, ref)
        log(f"[kernel] plain with a {name} first product vs plain: rel "
            f"median={med:.3e} p99={p99:.3e} max={mx:.3e} (must exceed "
            f"{TOL_KERNEL_MAX})")
        check(mx > TOL_KERNEL_MAX,
              f"the kernel bound does not reject a {name} first product")


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
    n_sub = int(np.ceil(N_LIBRARY / 1024))
    log(f"[main] generate(n={N_LIBRARY}) {wall:.3f} s = "
        f"{N_LIBRARY / wall:,.0f} SEDs/s; K1 launches {launches}")
    check(launches == n_sub, f"K1 launched {launches} times, expected {n_sub}")
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

    path, secs, compiler_log = _cuda.build_library()
    _cuda.load_library()
    log(f"[build] {path.name} built in {secs:.1f} s")
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
    features(tt, lib, dev)

    print(json.dumps({"kernels": [{
        "name": "K1 fused_window_photometry",
        "route": "cuda",
        "source": "synference_tpu_torch/csrc/fused_window.cu",
        "replaces": "synference_tpu/ops/fused_sed.py:167",
        "launches": launches,
        "max_abs_err": k1_stats["max_abs_err"],
        "ms": k1_stats["ms"],
        "plain_ms": k1_stats["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
