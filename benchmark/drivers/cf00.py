"""Library generation under Charlot & Fall (2000) dust: repeated
`LibraryGenerator.generate` calls, closed loop, one client.

As `drivers/generate.py` (parameters, window and metric: its `run`; the
checks), with the simulator built from the configuration's whole emission
model: the ISM screen `tau_v_param` and the birth cloud `tau_v_bc_param`
over the stars younger than 10^age_pivot_log10 yr, both with the
configuration's dust law and `dust_params`, and a static `fesc`. The check holds the sampled rows'
photometry to `reference/cf00.py` run on the θ the program returned.
"""

from __future__ import annotations

import numpy as np

from benchmark import harness, inputs
from benchmark.reference.cf00 import CF00Model
from benchmark.reference.forward import tf32_first_product

_GENERATE = harness.load_module("drivers", "generate")
compare, theta_checks = _GENERATE.compare, _GENERATE.theta_checks


def build(ctx):
    """The program's simulator and generator over the benchmark's grid and
    filters with the configuration's emission model; returns (generator,
    grid arrays, filter curves)."""
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
            fesc=float(model["fesc"]), dust_law=model["dust_law"],
            dust_params=tuple(model["dust_params"].items()),
            tau_v_param=model["tau_v_param"],
            tau_v_bc_param=model["tau_v_bc_param"],
            age_pivot_log10=float(model["age_pivot_log10"]),
            igm=model["igm"]),
        cosmology=tt.Cosmology(**model["cosmology"]),
        z_max=model["z_max"],
        photometry_knot_delta=max(1, round(model["knot_spacing_dex"]
                                           / dlog)),
        device=ctx.device)
    gen = tt.LibraryGenerator(
        sim, {k: tuple(v) for k, v in model["prior"].items()},
        unlog_keys=list(model["unlog_keys"]), device=ctx.device)
    return gen, grid_a, curves


# drivers/generate.py's window on this driver's simulator: `_GENERATE` is
# this module's own copy of it (`harness.load_module` loads a file anew),
# so its `build` is rebound here and nowhere else
_GENERATE.build = build
run = _GENERATE.run


def reference_rows(ctx, state, **kw):
    """The sampled rows' program photometry (capped, drawn from the seed)
    and the reference's on the same θ; `kw` goes to
    `CF00Model.photometry` (the control's precision, a planted fault)."""
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
        ref = state["ref"] = CF00Model(state["grid"], state["curves"],
                                       ctx.config["model"], ctx.device)
    out = ref.photometry(torch.as_tensor(theta, device=ctx.device), **kw)
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
    """The control's readings: the reference with its first products in
    TF32, put in the program's place, on the same rows."""
    _, ref = reference_rows(ctx, state)
    _, low = reference_rows(ctx, state, first_product=tf32_first_product)
    return compare(low, ref)


def faults(ctx, state) -> dict:
    """Planted faults put in the program's place, on the same rows: the
    birth cloud dropped, and the young/old split one grid age late."""
    _, ref = reference_rows(ctx, state)
    out = {}
    for name, kw in (("bc_dropped", {"drop_bc": True}),
                     ("pivot_one_age_late", {"pivot_shift": 1})):
        _, bad = reference_rows(ctx, state, **kw)
        out[name] = compare(bad, ref)
    return out
