"""Library generation: repeated `LibraryGenerator.generate` calls, closed
loop, one client.

Parameters (the workload file's "params"): `rows_per_call` (n of each
call), `warmup_calls`, `sample_rows_per_call` (rows of each call kept for
the check: its first, its last and the rest drawn from the seed, with
replacement),
`max_sample_rows` (the check's cap over the window), `strata` (coarse
Latin-hypercube strata the check counts), `metric` (the name the cell
reports its rows per second under).

The window: calls with seeds drawn from the run's seed, each returning
θ and photometry on the host, until `seconds` have passed; the metric is
all rows returned over the window's wall time. The check holds the
sampled rows' photometry to the plain forward model
(`reference/forward.py`) run on the θ the program returned, and holds
that θ to its guarantees: inside the prior box, a Latin hypercube (every
coarse stratum of every parameter holds its share of rows) and sorted by
redshift.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import inputs, workcount
from benchmark.reference.forward import (ForwardModel, exact_first_product,
                                         tf32_first_product)


def build(ctx):
    """The program's simulator and generator over the benchmark's grid and
    filters; returns (generator, grid arrays, filter curves)."""
    import synference_tpu_torch as tt

    cfg = ctx.config
    model = cfg["model"]
    grid_a = inputs.make_grid(cfg["grid"], ctx.seed, ctx.device)
    curves = inputs.make_filters(cfg["filters"])
    grid = tt.SPSGrid(name=cfg["grid"]["name"],
                      log10_ages=grid_a["log10_ages"],
                      metallicities=grid_a["metallicities"],
                      lam=grid_a["lam"],
                      spectra={"incident": grid_a["incident"],
                               "total": grid_a["total"]})
    fset = tt.FilterSet([tt.Filter(code=c, lam=lam, transmission=t)
                         for c, lam, t in curves])
    dlog = float(np.diff(np.log10(grid_a["lam"])).mean())
    sim = tt.BatchSEDSimulator(
        grid, fset, tuple(model["param_names"]), sfh=model["sfh"],
        zdist=model["zdist"],
        emission=tt.EmissionConfig(
            reprocessed_types=tuple(model["reprocessed_types"]),
            dust_law=model["dust_law"], igm=model["igm"]),
        cosmology=tt.Cosmology(**model["cosmology"]),
        z_max=model["z_max"],
        photometry_knot_delta=max(1, round(model["knot_spacing_dex"]
                                           / dlog)),
        device=ctx.device)
    gen = tt.LibraryGenerator(
        sim, {k: tuple(v) for k, v in model["prior"].items()},
        unlog_keys=list(model["unlog_keys"]), device=ctx.device)
    return gen, grid_a, curves


def run(ctx) -> dict:
    p = ctx.params
    n = int(p["rows_per_call"])
    gen, grid_a, curves = build(ctx)
    for i in range(int(p["warmup_calls"])):
        gen.generate(n=n, seed=ctx.seed_of(i, salt=1))
    rng = np.random.default_rng(ctx.seed % (2 ** 63))
    m = int(p["sample_rows_per_call"])
    keep_call = int(rng.integers(0, 4))
    theta_rows, phot_rows, kept, zs = [], [], [], []
    calls = 0
    ctx.begin_window()
    t_stop = ctx.t_begin + ctx.seconds
    while True:
        lib = gen.generate(n=n, seed=ctx.seed_of(calls))
        theta, phot = lib["parameters"], lib["photometry"]  # (P, N), (F, N)
        idx = np.concatenate([[0, n - 1],
                              rng.integers(1, n - 1, size=max(m - 2, 0))])
        theta_rows.append(theta[:, idx].T.copy())
        phot_rows.append(phot[:, idx].T.copy())
        if calls == keep_call:
            kept.append(theta)
        if ctx.trace:
            zs.append(theta[gen.simulator.param_names.index("redshift")]
                      .copy())
        calls += 1
        if time.perf_counter() >= t_stop:
            break
    ctx.end_window()
    if not kept:
        kept.append(theta)
    if ctx.trace:
        ctx.work = _work(gen, grid_a, curves, zs, n)
    sim = gen.simulator
    state = {"theta": np.concatenate(theta_rows),
             "phot": np.concatenate(phot_rows), "kept": kept,
             "grid": grid_a, "curves": curves,
             "names": sim.param_names, "rng": rng}
    del gen, sim
    return {"metrics": {p["metric"]: calls * n / ctx.window_s},
            "attempted": calls, "failed": 0, "state": state}


def _work(gen, grid_a, curves, zs, n: int) -> dict:
    """Per K1 launch (one per batch of the call), the work its real rows
    need; summed over the window's calls."""
    from synference_tpu_torch.library import auto_batch_size

    bs = auto_batch_size(n)
    support = workcount.band_support(curves)
    cells = int(np.prod(grid_a["total"].shape[:-1]))
    ops = least = 0.0
    for z in zs:
        for i in range(0, n, bs):
            w = workcount.launch_work(grid_a["lam"], support, z[i:i + bs],
                                      cells, len(curves))
            ops += w["ops"]
            least += w["least_s"]
    return {"ops": ops, "least_s": least}


def compare(phot, ref) -> dict:
    """Relative gaps of fluxes above 1e-3 of their row's maximum in the
    reference: p99 and max; and the count of non-finite fluxes."""
    import torch

    phot = torch.as_tensor(phot, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64)
    rel = (phot - ref).abs() / ref.abs().clamp(min=1e-30)
    rel = rel[ref > 1e-3 * ref.max(dim=1, keepdim=True).values]
    rel = torch.nan_to_num(rel, nan=float("inf"))
    return {"flux_rel_p99": float(torch.quantile(rel, 0.99)),
            "flux_rel_max": float(rel.max()),
            "flux_nonfinite": int((~torch.isfinite(phot)).sum())}


def theta_checks(theta, names, model: dict, strata: int) -> dict:
    """θ of one whole call (P, N) against its guarantees: rows outside the
    prior box, redshift steps down, and the largest departure of a coarse
    Latin-hypercube stratum from its share of rows."""
    n = theta.shape[1]
    outside, worst = 0, 0
    for key, (lo, hi) in model["prior"].items():
        name = key[6:] if key in model["unlog_keys"] else key
        v = np.asarray(theta[list(names).index(name)], np.float64)
        if key in model["unlog_keys"]:
            v = np.log10(v)
        tol = 1e-5 * (hi - lo)
        outside += int(np.sum((v < lo - tol) | (v > hi + tol)))
        u = np.clip((v - lo) / (hi - lo), 0.0, 1.0 - 1e-12)
        counts = np.bincount((u * strata).astype(np.int64),
                             minlength=strata)
        worst = max(worst, int(np.max(np.abs(counts - n / strata))))
    z = theta[list(names).index("redshift")]
    return {"theta_outside_prior": outside,
            "z_order_breaks": int(np.sum(np.diff(z) < 0)),
            "lhc_stratum_dev": worst}


def reference_rows(ctx, state, first_product=exact_first_product):
    """The sampled rows' program photometry (capped, drawn from the seed)
    and the reference's on the same θ."""
    import torch

    cap = int(ctx.params["max_sample_rows"])
    theta, phot = state["theta"], state["phot"]
    if len(theta) > cap:
        if "pick" not in state:
            state["pick"] = np.sort(state["rng"].choice(len(theta), cap,
                                                        replace=False))
        theta, phot = theta[state["pick"]], phot[state["pick"]]
    ref = state.get("ref")
    if ref is None:
        ref = state["ref"] = ForwardModel(state["grid"], state["curves"],
                                          ctx.config["model"], ctx.device)
    out = ref.photometry(torch.as_tensor(theta, device=ctx.device),
                         first_product=first_product)
    return phot, out.cpu().numpy()


def check(ctx, state) -> list:
    phot, ref = reference_rows(ctx, state)
    got = compare(phot, ref)
    for theta in state["kept"]:
        for k, v in theta_checks(theta, state["names"], ctx.config["model"],
                                 int(ctx.params["strata"])).items():
            got[k] = max(got.get(k, 0), v)
    return [(k, v, ctx.limits[k]) for k, v in got.items() if k in ctx.limits]


def control(ctx, state) -> dict:
    """The control's readings: the reference with its first product in
    TF32, put in the program's place, on the same rows."""
    _, ref = reference_rows(ctx, state)
    _, low = reference_rows(ctx, state, first_product=tf32_first_product)
    return compare(low, ref)
