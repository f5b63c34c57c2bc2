"""Library generation under Pacman emission with a free escape fraction:
repeated `LibraryGenerator.generate` calls, closed loop, one client.

As `drivers/generate.py` (parameters, window and metric: its `run`; the
checks), with the simulator built from the configuration's whole emission
model: fesc a column of θ, the incident spectra escaping unscreened and
the reprocessed ones (`reprocessed_types`) behind the ISM screen
`tau_v_param` with the configuration's dust law. The work a row needs is
this model's (`_work`): both first products. The check holds the sampled
rows' photometry to `reference/pacman.py` run on the θ the program
returned.
"""

from __future__ import annotations

import numpy as np

from benchmark import harness, inputs, workcount
from benchmark.reference.forward import tf32_first_product
from benchmark.reference.pacman import PacmanModel

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
            incident_type=model["incident_type"],
            reprocessed_types=tuple(model["reprocessed_types"]),
            fesc=model["fesc"], dust_law=model["dust_law"],
            tau_v_bc_param=model["tau_v_bc_param"], igm=model["igm"]),
        cosmology=tt.Cosmology(**model["cosmology"]),
        z_max=model["z_max"],
        photometry_knot_delta=max(1, round(model["knot_spacing_dex"]
                                           / dlog)),
        device=ctx.device)
    gen = tt.LibraryGenerator(
        sim, {k: tuple(v) for k, v in model["prior"].items()},
        unlog_keys=list(model["unlog_keys"]), device=ctx.device)
    return gen, grid_a, curves


def launch_work(lam, support, z, n_cells: int, n_bands: int) -> dict:
    """Operations, bytes and least time of one launch over rows `z` under
    Pacman emission: per row both first products (the incident and the
    reprocessed table, 4·C·L_row) and the band integrals (2·L_row·F); the
    columns its rows cover of both tables read once, the SFZH weights, the
    output and each row's fesc."""
    cols = workcount.columns_per_row(lam, support, z).astype(np.float64)
    ops = float(np.sum(4.0 * n_cells * cols + 2.0 * cols * n_bands))
    b = len(z)
    nbytes = 4.0 * (2 * n_cells * workcount.columns_covered(lam, support, z)
                    + b * n_cells + b * (n_bands + 1))
    peaks = workcount.PEAKS
    return {"ops": ops, "bytes": nbytes,
            "least_s": max(ops / peaks["fp32_flops"],
                           nbytes / peaks["hbm_bytes_per_s"])}


def _work(gen, grid_a, curves, zs, n: int) -> dict:
    """Per K1 launch (one per batch of the call), the work its real rows
    need under this model (`launch_work`); summed over the window's
    calls."""
    from synference_tpu_torch.library import auto_batch_size

    bs = auto_batch_size(n)
    support = workcount.band_support(curves)
    cells = int(np.prod(grid_a["total"].shape[:-1]))
    ops = least = 0.0
    for z in zs:
        for i in range(0, n, bs):
            w = launch_work(grid_a["lam"], support, z[i:i + bs], cells,
                            len(curves))
            ops += w["ops"]
            least += w["least_s"]
    return {"ops": ops, "least_s": least}


# drivers/generate.py's window on this driver's simulator and work count:
# `_GENERATE` is this module's own copy of it (`harness.load_module` loads
# a file anew), so its `build` and `_work` are rebound here and nowhere else
_GENERATE.build = build
_GENERATE._work = _work
run = _GENERATE.run


def reference_rows(ctx, state, **kw):
    """The sampled rows' program photometry (capped, drawn from the seed)
    and the reference's on the same θ; `kw` goes to
    `PacmanModel.photometry` (the control's precision, a planted fault)."""
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
        ref = state["ref"] = PacmanModel(state["grid"], state["curves"],
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
    """Planted faults put in the program's place, on the same rows: fesc
    read as 0, and the escaped light put behind the ISM screen."""
    _, ref = reference_rows(ctx, state)
    out = {}
    for name, kw in (("fesc_ignored", {"fesc_ignored": True}),
                     ("escape_screened", {"escape_screened": True})):
        _, bad = reference_rows(ctx, state, **kw)
        out[name] = compare(bad, ref)
    return out
