"""Spectroscopic library generation: repeated
`LibraryGenerator.generate(want_spectra=True)` calls through a
`SpectralFeaturePipeline`, closed loop, one client.

The simulator and prior are `drivers/generate.py::build`'s; the
configuration's "spectra" block sets the pipeline: its instrument R, its
constant-R grid from `lam_min` to `lam_max` (`pixels` of them), its norm
window and its model resolution (null: the pipeline's default); the
resampling is the pipeline's linear one.
Parameters (the workload file's "params"): as `drivers/generate.py`'s.

The window: calls with seeds drawn from the run's seed, each returning θ,
band photometry and the spectral features (the instrument pixels over
their norm-window mean, then log10 |norm|) on the host, until `seconds`
have passed; the metric is all rows returned over the window's wall time.
The check holds the sampled rows' features and band fluxes to the plain
reference (`reference/spectra.py`) run on the θ the program returned, and
that θ to the prior box and the Latin hypercube (this path does not sort
by redshift).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import harness, spectra_work
from benchmark.reference.forward import tf32_first_product
from benchmark.reference.spectra import SpectraModel, lsf_taps

_GENERATE = harness.load_module("drivers", "generate")


def build(ctx):
    """The program's generator with its spectral pipeline; returns
    (generator, grid arrays, filter curves)."""
    import synference_tpu_torch as tt

    gen, grid_a, curves = _GENERATE.build(ctx)
    sp = ctx.config["spectra"]
    obs_lam = tt.generate_constant_r_grid(sp["instrument_r"], sp["lam_min"],
                                          sp["lam_max"])
    if len(obs_lam) != int(sp["pixels"]):
        raise ValueError(f"the instrument grid has {len(obs_lam)} pixels, "
                         f"the configuration states {sp['pixels']}")
    pipe = tt.SpectralFeaturePipeline(
        gen.simulator.grid.lam, obs_lam, instrument_r=sp["instrument_r"],
        model_r=sp["model_r"], norm_window=tuple(sp["norm_window"]),
        device=ctx.device)
    gen = tt.LibraryGenerator(gen.simulator, gen.param_ranges,
                              unlog_keys=gen.unlog_keys,
                              spectral_pipeline=pipe, device=ctx.device)
    return gen, grid_a, curves


def run(ctx) -> dict:
    p = ctx.params
    n = int(p["rows_per_call"])
    gen, grid_a, curves = build(ctx)
    for i in range(int(p["warmup_calls"])):
        gen.generate(n=n, seed=ctx.seed_of(i, salt=1), want_spectra=True)
    rng = np.random.default_rng(ctx.seed % (2 ** 63))
    m = int(p["sample_rows_per_call"])
    keep_call = int(rng.integers(0, 4))
    iz = gen.simulator.param_names.index("redshift")
    theta_rows, phot_rows, spec_rows, kept, zs = [], [], [], [], []
    calls = 0
    ctx.begin_window()
    t_stop = ctx.t_begin + ctx.seconds
    while True:
        lib = gen.generate(n=n, seed=ctx.seed_of(calls), want_spectra=True)
        theta = lib["parameters"]  # (P, N)
        idx = np.concatenate([[0, n - 1],
                              rng.integers(1, n - 1, size=max(m - 2, 0))])
        theta_rows.append(theta[:, idx].T.copy())
        phot_rows.append(lib["photometry"][:, idx].T.copy())
        spec_rows.append(lib["spectra"][:, idx].T.copy())
        if calls == keep_call:
            kept.append(theta)
        if ctx.trace:
            zs.append(theta[iz].copy())
        calls += 1
        if time.perf_counter() >= t_stop:
            break
    ctx.end_window()
    if not kept:
        kept.append(theta)
    pipe = gen.spectral_pipeline
    if ctx.trace:
        n_taps = len(lsf_taps(pipe.instrument_r, pipe.model_r, pipe.grid_r))
        ctx.work = spectra_work.window_work(
            grid_a["lam"], curves, zs,
            int(np.prod(grid_a["total"].shape[:-1])), n_taps)
    state = {"theta": np.concatenate(theta_rows),
             "phot": np.concatenate(phot_rows),
             "spec": np.concatenate(spec_rows), "kept": kept,
             "grid": grid_a, "curves": curves,
             "names": gen.simulator.param_names, "rng": rng}
    del gen, pipe
    return {"metrics": {p["metric"]: calls * n / ctx.window_s},
            "attempted": calls, "failed": 0, "state": state}


def compare(spec, phot, ref_spec, ref_phot) -> dict:
    """Absolute gaps of the normalised pixels (p99, max) and of log10
    |norm| (p99), the count of non-finite features, and the band fluxes'
    gaps (`drivers/generate.py::compare`)."""
    import torch

    spec = torch.as_tensor(spec, dtype=torch.float64)
    ref_spec = torch.as_tensor(ref_spec, dtype=torch.float64)
    gap = torch.nan_to_num((spec - ref_spec).abs(), nan=float("inf"))
    out = {"spec_gap_p99": float(torch.quantile(gap[:, :-1], 0.99)),
           "spec_gap_max": float(gap[:, :-1].max()),
           "norm_log_gap_p99": float(torch.quantile(gap[:, -1], 0.99)),
           "spec_nonfinite": int((~torch.isfinite(spec)).sum())}
    out.update(_GENERATE.compare(phot, ref_phot))
    return out


def _sample(ctx, state):
    """The sampled rows' θ, band fluxes and features, capped at
    `max_sample_rows` (a pick drawn from the seed)."""
    cap = int(ctx.params["max_sample_rows"])
    theta, phot, spec = state["theta"], state["phot"], state["spec"]
    if len(theta) > cap:
        if "pick" not in state:
            state["pick"] = np.sort(state["rng"].choice(len(theta), cap,
                                                        replace=False))
        pick = state["pick"]
        theta, phot, spec = theta[pick], phot[pick], spec[pick]
    return theta, phot, spec


def _reference(ctx, state, name: str, **kw):
    """The reference's (features, band fluxes) on the sampled rows' θ,
    under `kw` (`SpectraModel.spectra`'s first product and planted
    faults); computed once per `name`."""
    import torch

    refs = state.setdefault("refs", {})
    if name not in refs:
        if "ref" not in state:
            state["ref"] = SpectraModel(state["grid"], state["curves"],
                                        ctx.config["model"],
                                        ctx.config["spectra"], ctx.device)
        theta, _, _ = _sample(ctx, state)
        feats, fluxes = state["ref"].spectra(
            torch.as_tensor(theta, device=ctx.device), **kw)
        refs[name] = (feats.numpy(), fluxes.numpy())
    return refs[name]


def check(ctx, state) -> list:
    _, phot, spec = _sample(ctx, state)
    ref_spec, ref_phot = _reference(ctx, state, "exact")
    got = compare(spec, phot, ref_spec, ref_phot)
    for theta in state["kept"]:
        for k, v in _GENERATE.theta_checks(
                theta, state["names"], ctx.config["model"],
                int(ctx.params["strata"])).items():
            got[k] = max(got.get(k, 0), v)
    return [(k, v, ctx.limits[k]) for k, v in got.items() if k in ctx.limits]


def _in_place(ctx, state, name: str, **kw) -> dict:
    """The reference under `kw` put in the program's place, against the
    exact reference."""
    return compare(*_reference(ctx, state, name, **kw),
                   *_reference(ctx, state, "exact"))


def control(ctx, state) -> dict:
    """The control's readings: the reference with both contractions in
    TF32."""
    return _in_place(ctx, state, "tf32", first_product=tf32_first_product)


def faults(ctx, state) -> dict:
    """Planted faults' readings: a 10% wider LSF, and a redshift off by
    1e-4 where each row is placed on the instrument grid."""
    return {"lsf_wider_10pct": _in_place(ctx, state, "lsf_wider_10pct",
                                         lsf_scale=1.1),
            "z_off_1e-4": _in_place(ctx, state, "z_off_1e-4", dz=1e-4)}
