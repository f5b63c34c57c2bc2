"""Sharded mock-SED generation over the ranks of a mesh axis.

Each rank simulates its block of rows of a batch, with the rows' global
offset (stochastic particle realisations stay those of the single-process
run), and the outputs are all-gathered, so every rank holds the batch's
result: the counterpart of the JAX package's shard_map over the sample
axis and of the reference's MPI rank files.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import axis_info, gather_rows

__all__ = ["make_sharded_photometry_fn", "make_sharded_zsorted_fn",
           "sharded_generate"]


def make_sharded_photometry_fn(sim, mesh, axis_name: str = "data",
                               want_spectra: bool = False):
    """The dense simulator with the batch split along the sample axis.

    Returns fn(θ (B, P), row_offset=0) -> `sim.simulate`'s dict with every
    (B, ...) output on every rank; B must divide by the axis size. Rank r
    simulates rows [r·B/n, (r+1)·B/n) with row offset `row_offset` + r·B/n.
    """
    size, rank, _ = axis_info(mesh, axis_name)

    def fn(theta, row_offset: int = 0):
        theta = torch.atleast_2d(torch.as_tensor(
            theta, dtype=torch.float32, device=sim.device))
        b = theta.shape[0]
        if b % size:
            raise ValueError(f"batch of {b} rows does not divide over "
                             f"{size} ranks of {axis_name!r}")
        local = b // size
        out = sim.simulate(theta[rank * local:(rank + 1) * local],
                           want_spectra=want_spectra,
                           row_offset=int(row_offset) + rank * local)
        return {k: gather_rows(v, mesh, axis_name) for k, v in out.items()}

    return fn


def make_sharded_zsorted_fn(sim, mesh, axis_name: str = "data",
                            sub_chunk: int = 1024, kc: int | None = None,
                            w_cols: int | None = None, fused: bool = False):
    """The z-sorted window engine with the sub-chunks split over the axis.

    Returns fn(θ (B, P) in any order, row_offset=0) ->
    {"photometry_njy": (B, F)} in the input row order, on every rank: the
    batch is sorted by redshift (stable) on the device, padded with its
    last row to a whole number of sub-chunks per rank, and each rank runs
    `photometry_zsorted_device` over its contiguous block of sub-chunks
    (`fused` picks K1 or the staged body). Pass GLOBAL (kc, w_cols) window
    sizes (`sharded_generate` plans them over the whole run) so that every
    sub-chunk has the windows of the single-process run, and with them its
    bits; without them each rank plans its own block.
    """
    size, rank, _ = axis_info(mesh, axis_name)

    def fn(theta, row_offset: int = 0):
        theta = torch.atleast_2d(torch.as_tensor(
            theta, dtype=torch.float32, device=sim.device))
        b = theta.shape[0]
        if "redshift" in sim.param_names:
            order = torch.sort(theta[:, sim.param_names.index("redshift")],
                               stable=True).indices
            theta = theta[order]
        else:
            order = None
        sub = int(min(sub_chunk, b))
        n_sub = int(np.ceil(np.ceil(b / sub) / size) * size)
        pad = n_sub * sub - b
        if pad:
            theta = torch.cat([theta, theta[-1:].expand(pad, -1)], dim=0)
        local = n_sub // size * sub
        out = sim.photometry_zsorted_device(
            theta[rank * local:(rank + 1) * local], sub_chunk=sub,
            row_offset=int(row_offset) + rank * local, kc=kc, w_cols=w_cols,
            fused=fused)
        out = gather_rows(out, mesh, axis_name)[:b]
        if order is not None:
            out = torch.empty_like(out).index_copy_(0, order, out)
        return {"photometry_njy": out}

    return fn


def sharded_generate(generator, n: int, mesh, batch_size: int | None = None,
                     seed: int = 0, out_path: str | None = None,
                     axis_name: str = "data", want_spectra: bool = False,
                     zsorted: bool | None = None) -> dict:
    """`LibraryGenerator.generate` with every batch split over the axis.

    The batch size (default `auto_batch_size(n)`) is padded to a multiple
    of the axis size. θ come from the host sampler with `seed`, as in a
    single-process run; every rank returns the whole library and only rank
    0 writes `out_path`.

    `zsorted` (default: where the window engine runs the model and the run
    is photometry only) sorts the draws by redshift over the whole run,
    plans ONE window (kc, w_cols) from them, as `generate` does, and runs
    each batch through `make_sharded_zsorted_fn`: the library then equals
    a single-process `generate(n, batch_size, seed)` bit for bit, rows
    sorted by redshift; the window body is `generate`'s "auto" choice,
    which every rank makes alike from the configuration. When the window
    would be the whole table, or with `zsorted=False`, the dense simulator
    runs (`make_sharded_photometry_fn`). The single-process run to compare
    with is `generate(..., device_sampling=False)`: the default device
    sampler draws other θ.
    """
    from ..library import _fused_window_body, _supports, auto_batch_size

    size, rank, _ = axis_info(mesh, axis_name)
    if batch_size is None:
        batch_size = auto_batch_size(n)
    bs = int(np.ceil(batch_size / size) * size)
    sim = generator.simulator
    phot_only = not want_spectra and not generator.supplementary
    if zsorted is None:
        zsorted = (phot_only and "redshift" in sim.param_names
                   and _supports(sim, "_window_supported"))
    if zsorted and not phot_only:
        raise ValueError("zsorted sharded generation is photometry-only")
    out_path = out_path if rank == 0 else None
    if zsorted:
        theta = generator.sample_parameters(
            n, rng=np.random.default_rng(seed))
        iz = sim.param_names.index("redshift")
        theta = theta[np.argsort(theta[:, iz], kind="stable")]
        n_pad = int(np.ceil(n / bs) * bs)
        theta_dev = generator._padded(theta, n_pad)
        sub = min(1024, bs)
        kc, w_cols = sim._zsorted_plan(
            generator._run_span(theta_dev[:, iz], bs, sub))
        if kc < sim._n_knots and w_cols < sim._l_sup:
            zfn = make_sharded_zsorted_fn(
                sim, mesh, axis_name, sub_chunk=sub, kc=kc, w_cols=w_cols,
                fused=_fused_window_body(sim, "auto"))
            return generator.generate(n, batch_size=bs, seed=seed,
                                      out_path=out_path, pmapped_fn=zfn,
                                      presort=True)
    fn = make_sharded_photometry_fn(
        sim, mesh, axis_name,
        want_spectra=want_spectra or bool(generator.supplementary))
    return generator.generate(n, batch_size=bs, seed=seed, out_path=out_path,
                              want_spectra=want_spectra, pmapped_fn=fn)
