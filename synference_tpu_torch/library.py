"""Mock-library generation and the reference-compatible HDF5 schema.

Counterpart of `synference_tpu/library.py`. Two generation paths, chosen by
`LibraryGenerator.generate` with the JAX package's rule:

- the device path (photometry only, LHC or plain uniform draws, a model the
  window engine runs): θ is drawn by a `torch.Generator` on the device,
  sorted by redshift, window-planned once for the run and simulated batch by
  batch through `BatchSEDSimulator.photometry_zsorted_device`;
- the host path (every other request: spectra, supplementary quantities,
  the scipy QMC engines, a fixed redshift): θ is drawn on the host by
  `draw_from_hypercube`, bit for bit as the JAX package draws it for the
  same seed, then moved to the device. Z-sorted runs go through the same
  window engine with one plan for the run; the rest through the dense
  `simulate`.

The window body of z-sorted runs is K1 (the fused body) or the staged body;
`zsorted_fused="auto"` times both once per configuration on the card and
keeps the faster, and takes K1 for runs too short to repay the timing
(`_choose_zsorted_fused`). Libraries are written and read
in the reference's HDF5 schema, with a `Model` group from which
`simulator_from_library` rebuilds the simulator; files are interchangeable
with the JAX package's. h5py and scipy are imported where they are used.

Deliberate differences from the JAX package: where it warns and falls back
(an unsupported `zsorted_fused=True`, a `device_sampling=True` it cannot
honour) this package raises; device-sampler resume chunks carry their own
tag, because a `torch.Generator` draws other θ than `jax.random`; an unknown
simulator class in a library file raises instead of building the base
simulator; and the window-body probe propagates a kernel failure.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import pathlib

import numpy as np
import torch

from .cosmology import Cosmology
from .filters import FilterSet
from .grids import SPSGrid
from .sed import BatchSEDSimulator, EmissionConfig

__all__ = ["auto_batch_size", "draw_from_hypercube",
           "draw_from_hypercube_device", "save_library_hdf5",
           "load_library_hdf5", "LibraryCreator", "LibraryGenerator",
           "grid_content_hash", "simulator_from_library",
           "zsorted_probe_digest"]

# where "auto" keeps its window-body choices across processes (a build
# artifact, like the kernel library beside it)
ZSORTED_PROBE_FILE = (pathlib.Path(__file__).resolve().parent / "_build"
                      / "zsorted_probe.json")
# resume-chunk tags: θ of the host sampler is the JAX package's, the device
# sampler's is not (the JAX package tags its own device chunks "device")
_HOST_SAMPLER = "host"
_DEVICE_SAMPLER = "torch-device"
# "auto" probes only runs long enough to repay timing both bodies; shorter
# runs on the card take K1
_PROBE_MIN_BATCHES = 4
# the Python side of both window bodies (the staged body and K1's wrapper)
_WINDOW_BODY_MODULES = ("sed.py", "ops/fused_sed.py",
                        "ops/photometry_kernel.py")


def auto_batch_size(n: int, spectra_width: int | None = None) -> int:
    """Generation chunk size when the caller doesn't pick one: at most 65536
    rows (scaled down with the output width when full spectra are kept),
    never padding a small request up to a huge chunk."""
    cap = 65536
    if spectra_width:
        cap = int(65536 * 2048 / max(spectra_width, 2048))
        cap = max(4096, (cap // 256) * 256)
    return int(min(cap, max(256, -(-n // 256) * 256)))


def _strip_log_prefix(key: str) -> str:
    for prefix in ("log10_", "log_"):
        if key.startswith(prefix):
            return key[len(prefix):]
    return key


# ---------------------------------------------------------------------------
# Prior sampling
# ---------------------------------------------------------------------------


def draw_from_hypercube(param_ranges: dict, n: int, rng=None,
                        unlog_keys: list | None = None,
                        engine: str = "lhc") -> dict:
    """Draw n quasi-random samples over named (lo, hi) ranges on the host,
    as the JAX package does (the same seed gives the same float32 bits).

    engine: "lhc" (scrambled Latin hypercube: scipy below 10⁵ rows, a
    stratified per-dimension permutation plus jitter from 10⁵), "sobol",
    "halton" or "random". `unlog_keys` entries are sampled in log space,
    raised to 10**x, and lose their "log10_"/"log_" prefix. Returns
    {name: (n,) float32 array}.
    """
    unlog_keys = unlog_keys or []
    d = len(param_ranges)
    seed = np.random.default_rng(rng)
    if engine == "lhc":
        if n >= 100_000:
            u = np.empty((int(n), d))
            for j in range(d):
                u[:, j] = (seed.permutation(int(n)) + seed.random(int(n))) / n
        else:
            from scipy.stats import qmc

            u = qmc.LatinHypercube(d=d, rng=seed).random(int(n))
    elif engine in ("sobol", "halton"):
        from scipy.stats import qmc

        cls = qmc.Sobol if engine == "sobol" else qmc.Halton
        u = cls(d=d, rng=seed).random(int(n))
    elif engine == "random":
        u = seed.random((int(n), d))
    else:
        raise ValueError(f"unknown engine {engine!r}")
    out = {}
    for i, (key, (lo, hi)) in enumerate(param_ranges.items()):
        if not lo < hi:
            raise ValueError(f"range for {key!r} must have lo < hi")
        vals = (lo + (hi - lo) * u[:, i]).astype(np.float32)
        if key in unlog_keys:
            vals = (10.0**vals).astype(np.float32)
            key = _strip_log_prefix(key)
        if not np.isfinite(vals).all():
            raise ValueError(f"non-finite samples for parameter {key!r}")
        out[key] = vals
    return out


def draw_from_hypercube_device(param_ranges: dict, n: int,
                               generator: torch.Generator,
                               unlog_keys: list | None = None,
                               engine: str = "lhc") -> dict:
    """Draw n samples over named (lo, hi) ranges on the generator's device:
    engine "lhc" a classic stratified Latin hypercube (per-dimension random
    permutation plus jitter), "random" plain uniforms. Returns {name: (n,)
    float32 tensor}; the draws differ from `draw_from_hypercube`'s."""
    if engine not in ("lhc", "random"):
        raise ValueError(
            f"device sampling supports engines 'lhc'/'random', not "
            f"{engine!r} (sobol/halton are scipy host-side)")
    unlog_keys = unlog_keys or []
    dev = generator.device
    out = {}
    for key, (lo, hi) in param_ranges.items():
        if not lo < hi:
            raise ValueError(f"range for {key!r} must have lo < hi")
        if engine == "lhc":
            perm = torch.randperm(int(n), generator=generator, device=dev)
            # perm/n + u/n, not (perm+u)/n: above 2^24 the f32 add perm + u
            # would drop the jitter
            u = (perm.to(torch.float32) / n
                 + torch.rand(int(n), generator=generator, device=dev) / n)
        else:
            u = torch.rand(int(n), generator=generator, device=dev)
        vals = (lo + (hi - lo) * u).to(torch.float32)
        if key in unlog_keys:
            vals = (10.0 ** vals).to(torch.float32)
            key = _strip_log_prefix(key)
        out[key] = vals
    return out


# ---------------------------------------------------------------------------
# HDF5 schema (2-D datasets stored (n_features, n_samples))
# ---------------------------------------------------------------------------


def save_library_hdf5(path: str, parameters, parameter_names: list,
                      filter_codes: list | None = None, photometry=None,
                      spectra=None, parameter_units: list | None = None,
                      supplementary_parameters=None,
                      supplementary_parameter_names: list | None = None,
                      supplementary_parameter_units: list | None = None,
                      photometry_units: str = "nJy",
                      model_name: str = "synference_tpu",
                      extra_datasets: dict | None = None,
                      extra_attrs: dict | None = None,
                      model_group_writer=None) -> None:
    """Write a library in the reference schema: `photometry` (F, N),
    `parameters` (P, N), and so on. Filter codes that do not fit an HDF5
    attribute (64 KB) go to a `Grid/FilterCodes` dataset, with the
    attribute pointing at it."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("Grid")
        if photometry is not None:
            g.create_dataset("Photometry", data=photometry, compression="gzip")
        if spectra is not None:
            g.create_dataset("Spectra", data=spectra, compression="gzip")
        g.create_dataset("Parameters", data=parameters, compression="gzip")
        if supplementary_parameters is not None:
            names = list(supplementary_parameter_names or [])
            g.create_dataset("SupplementaryParameters",
                             data=supplementary_parameters,
                             compression="gzip")
            f.attrs["SupplementaryParameterNames"] = names
            f.attrs["SupplementaryParameterUnits"] = list(
                supplementary_parameter_units or [""] * len(names))
        f.attrs["ParameterNames"] = list(parameter_names)
        if filter_codes is not None:
            try:
                f.attrs["FilterCodes"] = list(filter_codes)
            except (OSError, RuntimeError):
                g.create_dataset("FilterCodes",
                                 data=np.array(filter_codes, dtype="S"),
                                 compression="gzip")
                f.attrs["FilterCodes"] = "/Grid/FilterCodes/"
        f.attrs["PhotometryUnits"] = photometry_units
        if parameter_units is not None:
            f.attrs["ParameterUnits"] = list(parameter_units)
        f.attrs["model_name"] = model_name
        f.attrs["CreationDT"] = datetime.datetime.now().strftime(
            "%Y%m%d_%H%M%S")
        for k, v in (extra_datasets or {}).items():
            g.create_dataset(k, data=v, compression="gzip")
        for k, v in (extra_attrs or {}).items():
            f.attrs[k] = v
        if model_group_writer is not None:
            model_group_writer(f.create_group("Model"))


def _text(values) -> list:
    return [v.decode() if isinstance(v, bytes) else str(v) for v in values]


def load_library_hdf5(path: str) -> dict:
    """Read a reference-schema library into the dict `generate` returns."""
    import h5py

    with h5py.File(path, "r") as f:
        out = {
            "parameters": f["Grid/Parameters"][:],
            "parameter_names": _text(f.attrs["ParameterNames"]),
            "photometry_units": str(f.attrs.get("PhotometryUnits", "nJy")),
            "parameter_units": (_text(f.attrs["ParameterUnits"])
                                if "ParameterUnits" in f.attrs else None),
        }
        fc = f.attrs.get("FilterCodes")
        if isinstance(fc, (bytes, str)):  # pointer to the dataset fallback
            fc = _text(f[fc.decode() if isinstance(fc, bytes) else fc][:])
        elif fc is not None:
            fc = _text(fc)
        out["filter_codes"] = fc
        for key, name in (("photometry", "Photometry"), ("spectra", "Spectra"),
                          ("wavelengths", "Wavelengths")):
            if f"Grid/{name}" in f:
                out[key] = f[f"Grid/{name}"][:]
        if "Grid/SupplementaryParameters" in f:
            out["supplementary_parameters"] = (
                f["Grid/SupplementaryParameters"][:])
            out["supplementary_parameter_names"] = _text(
                f.attrs["SupplementaryParameterNames"])
            out["supplementary_parameter_units"] = _text(
                f.attrs["SupplementaryParameterUnits"])
    return out


class LibraryCreator:
    """Bring-your-own-library: write conforming HDF5 from raw arrays without
    a simulator. Parameters may be (N, P) or (P, N), photometry (N, F) or
    (F, N)."""

    def __init__(self, parameters, parameter_names: list, photometry=None,
                 filter_codes: list | None = None, spectra=None, **extra):
        parameters = np.asarray(parameters)
        if parameters.shape[0] != len(parameter_names):
            parameters = parameters.T
        if parameters.shape[0] != len(parameter_names):
            raise ValueError("parameters shape does not match parameter_names")
        self.parameters = parameters
        self.parameter_names = list(parameter_names)
        if photometry is not None:
            photometry = np.asarray(photometry)
            if filter_codes and photometry.shape[0] != len(filter_codes):
                photometry = photometry.T
        self.photometry = photometry
        self.filter_codes = filter_codes
        self.spectra = spectra
        self.extra = extra

    def save(self, path: str, **kw) -> None:
        save_library_hdf5(path, parameters=self.parameters,
                          parameter_names=self.parameter_names,
                          photometry=self.photometry,
                          filter_codes=self.filter_codes,
                          spectra=self.spectra, **{**self.extra, **kw})


# ---------------------------------------------------------------------------
# Resume chunks: `{resume_path}.chunk{ci:06d}.npz`, written once each
# ---------------------------------------------------------------------------


def _chunk_file(resume_path: str, ci: int) -> str:
    return f"{resume_path}.chunk{ci:06d}.npz"


def _load_chunks(resume_path: str, meta: dict) -> list:
    """The consecutive run of completed chunks whose metadata matches `meta`
    (n, batch_size, seed, order, sampler): a list of {field: array}."""
    chunks = []
    while os.path.exists(_chunk_file(resume_path, len(chunks))):
        with np.load(_chunk_file(resume_path, len(chunks))) as ck:
            got = {
                "n": int(ck["n"]), "batch_size": int(ck["batch_size"]),
                "seed": int(ck["seed"]),
                "order": str(ck["order"]) if "order" in ck.files else None,
                "sampler": (str(ck["sampler"]) if "sampler" in ck.files
                            else _HOST_SAMPLER)}
            if got != meta:
                break
            chunks.append({k: ck[k] for k in ("phot", "spec", "supp")
                           if k in ck.files})
    return chunks


def _save_chunk(resume_path: str, ci: int, meta: dict, arrays: dict) -> None:
    tmp = _chunk_file(resume_path, ci) + ".tmp.npz"
    np.savez(tmp, **meta, **arrays)
    os.replace(tmp, _chunk_file(resume_path, ci))


def _remove_chunks(resume_path: str, n_chunks: int) -> None:
    for ci in range(n_chunks):
        path = _chunk_file(resume_path, ci)
        if os.path.exists(path):
            os.remove(path)


# ---------------------------------------------------------------------------
# The window-body probe
# ---------------------------------------------------------------------------


def _window_body_code_digest() -> str:
    """sha256 over the code of both window bodies: the kernel sources (the
    identity of K1's build) and the Python modules of the staged body and
    K1's wrapper."""
    from .ops._cuda import source_digest

    pkg = pathlib.Path(__file__).resolve().parent
    h = hashlib.sha256(source_digest().encode())
    for name in _WINDOW_BODY_MODULES:
        h.update(name.encode() + (pkg / name).read_bytes())
    return h.hexdigest()


def zsorted_probe_digest(sim: BatchSEDSimulator, plan: tuple, batch: int,
                         device_name: str) -> str:
    """sha256 key of a persisted "auto" choice: the grid's content, its
    width, the filter codes, the plan (sub, kc, w_cols), the batch rows, the
    card's name (a choice measured on one card is not carried to another)
    and the code of both window bodies (a rewrite of either voids the
    choice). Equal across processes for the same configuration and code."""
    record = [grid_content_hash(sim.grid), int(sim.grid.n_wav),
              list(sim.filters.codes), [int(v) for v in plan], int(batch),
              str(device_name), _window_body_code_digest()]
    return hashlib.sha256(json.dumps(record).encode()).hexdigest()


def _probe_ms(fn) -> float:
    """ms of one warm call of `fn` on the card, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _probe_bodies(sim: BatchSEDSimulator, theta, sub: int, kc: int,
                  w_cols: int) -> dict:
    """Time one warm batch through the staged and the fused window body:
    {"staged_ms", "fused_ms", "fused": the fused body is faster}. A body
    that fails raises."""
    record = {}
    for name, fused in (("staged_ms", False), ("fused_ms", True)):
        record[name] = _probe_ms(lambda f=fused: sim.photometry_zsorted_device(
            theta, sub_chunk=sub, kc=kc, w_cols=w_cols, fused=f))
    record["fused"] = bool(record["fused_ms"] < record["staged_ms"])
    return record


def _read_probe_file() -> dict:
    try:
        with open(ZSORTED_PROBE_FILE) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def _write_probe_file(digest: str, record: dict) -> None:
    stored = _read_probe_file()
    stored[digest] = record
    path = pathlib.Path(ZSORTED_PROBE_FILE)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(stored, indent=1))
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Library generation through the batch simulator
# ---------------------------------------------------------------------------


class LibraryGenerator:
    """θ-prior + BatchSEDSimulator -> library dict in the reference schema
    ("parameters" (P, N), "photometry" (F, N), names, units; spectra and
    supplementary quantities on request), optionally written to HDF5.

    Args:
        simulator: the port's BatchSEDSimulator.
        param_ranges: {name: (lo, hi)}; after un-logging, the names must
            cover `simulator.param_names`.
        unlog_keys: names sampled in log10 space.
        supplementary: names of `supplementary.SUPP_FUNCTIONS` recorded per
            row (needs the dense spectra, so the host path).
        engine: "lhc", "sobol", "halton" or "random".
        spectral_pipeline, emission_lines: not ported (ROADMAP M10 and
            M9); anything but None / () raises.
        embed_grid: store the grid's spectra in the Model group (a
            self-contained file); by default only its name, axes and
            content hash.
        device: where the simulator runs; must be the simulator's device.
    """

    def __init__(self, simulator: BatchSEDSimulator, param_ranges: dict,
                 unlog_keys: list | None = None, supplementary: tuple = (),
                 engine: str = "lhc", spectral_pipeline=None,
                 emission_lines: tuple = (), embed_grid: bool = False, *,
                 device):
        if spectral_pipeline is not None:
            raise NotImplementedError(
                "spectral_pipeline (spectra on an instrument grid) is not "
                "ported yet (ROADMAP M10)")
        if emission_lines:
            raise NotImplementedError(
                "emission_lines (BatchSEDSimulator.line_quantities) are not "
                "ported yet (ROADMAP M9)")
        self.device = torch.device(device)
        if self.device != simulator.device:
            raise ValueError(f"generator device {self.device} differs from "
                             f"the simulator's {simulator.device}")
        if supplementary:
            from .supplementary import SUPP_FUNCTIONS

            unknown = [s for s in supplementary if s not in SUPP_FUNCTIONS]
            if unknown:
                raise ValueError(f"unknown supplementary quantities {unknown}")
        self.simulator = simulator
        self.param_ranges = dict(param_ranges)
        self.unlog_keys = list(unlog_keys or [])
        self.supplementary = tuple(supplementary)
        self.engine = engine
        self.embed_grid = bool(embed_grid)
        # the last "auto" resolution: its source ("probe", "file",
        # "simulator", "short run", "cpu" or "unsupported"), and for a probe
        # both bodies' ms and the digest it was stored under
        self.last_probe: dict | None = None
        drawn = [_strip_log_prefix(k) if k in self.unlog_keys else k
                 for k in self.param_ranges]
        missing = [p for p in simulator.param_names if p not in drawn]
        if missing:
            raise ValueError(
                f"simulator params {missing} not covered by param_ranges")

    # -- θ ----------------------------------------------------------------
    def sample_parameters(self, n: int, rng=None) -> np.ndarray:
        """(N, P) host θ draws in simulator.param_names order."""
        draws = draw_from_hypercube(self.param_ranges, n, rng=rng,
                                    unlog_keys=self.unlog_keys,
                                    engine=self.engine)
        return np.stack([draws[p] for p in self.simulator.param_names],
                        axis=1)

    def sample_parameters_device(self, n: int, generator: torch.Generator):
        """(N, P) θ draws on the device in simulator.param_names order."""
        draws = draw_from_hypercube_device(self.param_ranges, n, generator,
                                           unlog_keys=self.unlog_keys,
                                           engine=self.engine)
        return torch.stack([draws[p] for p in self.simulator.param_names],
                           dim=1)

    # -- generation -------------------------------------------------------
    def generate(self, n: int, batch_size: int | None = None, seed: int = 0,
                 out_path: str | None = None, want_spectra: bool = False,
                 pmapped_fn=None, resume_path: str | None = None,
                 zsorted_fused: bool | str = "auto",
                 device_sampling: bool | None = None) -> dict:
        """Generate n mock SEDs; returns the library dict and, with
        `out_path`, writes it as HDF5 with a Model group.

        `device_sampling` (default: where allowed) takes the device path;
        it is allowed for photometry-only lhc/random generation with a
        redshift parameter and a model the window engine runs, and True
        where it is not allowed raises. The device path's θ come from a
        `torch.Generator` seeded with `seed` (other draws than the JAX
        package's); the host path's θ equal the JAX package's bit for bit.
        Z-sorted runs return their rows sorted by redshift.

        `resume_path`: checkpoint prefix; each finished batch is written
        once to `{resume_path}.chunk{ci:06d}.npz` and skipped on a restart
        whose (n, batch_size, seed, row order, sampler) match. The files go
        when the run ends.

        `zsorted_fused`: the window body of z-sorted runs; True (K1), False
        (the staged body) or "auto" (see `_choose_zsorted_fused`).

        `pmapped_fn` (mesh-sharded batches) is not ported (ROADMAP M14),
        nor `presort`, which only applies with it.
        """
        if pmapped_fn is not None:
            raise NotImplementedError(
                "generate(pmapped_fn=...) (mesh-sharded batches) is not "
                "ported yet (ROADMAP M14)")
        sim = self.simulator
        wide = want_spectra or bool(self.supplementary)
        if batch_size is None:
            batch_size = auto_batch_size(
                n, spectra_width=int(sim.grid.n_wav) if wide else None)
        if n == 0:
            lib = self._empty_library(want_spectra)
            self._save(out_path, lib)
            return lib
        device_ok = (not wide and self.engine in ("lhc", "random")
                     and "redshift" in sim.param_names
                     and sim._window_supported())
        if device_sampling is None:
            device_sampling = device_ok
        elif device_sampling and not device_ok:
            raise ValueError(
                "device_sampling=True, but this generation needs the host "
                "sampler (spectra or supplementary quantities, a scipy QMC "
                "engine, a fixed redshift, or a model the window engine "
                "cannot run)")
        if device_sampling:
            lib = self._generate_device(n, batch_size, seed, resume_path,
                                        zsorted_fused)
        else:
            lib = self._generate_host(n, batch_size, seed, want_spectra,
                                      resume_path, zsorted_fused)
        self._save(out_path, lib)
        return lib

    def _generate_host(self, n, batch_size, seed, want_spectra, resume_path,
                       zsorted_fused) -> dict:
        """θ from the host sampler; z-sorted through the window engine when
        it runs the model and its window is not the whole table, else the
        dense `simulate`, one batch of `batch_size` rows at a time."""
        sim = self.simulator
        wide = want_spectra or bool(self.supplementary)
        theta = self.sample_parameters(n, rng=np.random.default_rng(seed))
        n_pad = int(np.ceil(n / batch_size) * batch_size)
        n_batches = n_pad // batch_size
        batch_fn = None
        if (not wide and "redshift" in sim.param_names
                and sim._window_supported()):
            iz = sim.param_names.index("redshift")
            ordered = theta[np.argsort(theta[:, iz], kind="stable")]
            theta_dev = self._padded(ordered, n_pad)  # last row: tight windows
            sub = min(1024, batch_size)
            kc, w_cols = sim._zsorted_plan(
                self._run_span(theta_dev[:, iz], batch_size, sub))
            if kc < sim._n_knots and w_cols < sim._l_sup:
                theta, row_order = ordered, "zsorted"
                fuse = self._choose_zsorted_fused(
                    zsorted_fused, sub, kc, w_cols, theta_dev[:batch_size],
                    n_batches)

                def batch_fn(t):
                    return {"photometry_njy": sim.photometry_zsorted_device(
                        t, sub_chunk=sub, kc=kc, w_cols=w_cols, fused=fuse)}
        if batch_fn is None:
            theta_dev, row_order = self._padded(theta, n_pad), "input"
            self._check_fused_request(zsorted_fused)

            def batch_fn(t):
                return sim.simulate(t, want_spectra=wide)

        meta = {"n": n, "batch_size": batch_size, "seed": seed,
                "order": row_order, "sampler": _HOST_SAMPLER}

        def run(i):
            t = theta_dev[i:i + batch_size]
            out = batch_fn(t)
            arrays = {"phot": out["photometry_njy"]}
            if want_spectra:
                arrays["spec"] = out["fnu_njy"]
            if self.supplementary:
                from .supplementary import compute_supplementary

                arrays["supp"] = compute_supplementary(self.supplementary, sim,
                                                       t, out)
            return arrays

        chunks = self._run_batches(run, n_pad, batch_size, meta, resume_path)
        lib = self._library(theta, chunks["phot"][:n])
        if want_spectra:
            lib["spectra"] = chunks["spec"][:n].T
            lib["wavelengths"] = np.asarray(sim.grid.lam)
        if self.supplementary:
            lib["supplementary_parameters"] = chunks["supp"][:n].T
            lib["supplementary_parameter_names"] = list(self.supplementary)
        return lib

    def _generate_device(self, n, batch_size, seed, resume_path,
                         zsorted_fused) -> dict:
        """Photometry-only generation on the device: θ drawn, z-sorted,
        window-planned and simulated there; one readback for the plan, one
        copy of θ and photometry to the host."""
        sim = self.simulator
        theta, sub, bs, kc, w_cols = self._draw_sorted(n, batch_size, seed)
        n_pad = theta.shape[0]
        if kc < sim._n_knots and w_cols < sim._l_sup:
            fuse = self._choose_zsorted_fused(zsorted_fused, sub, kc, w_cols,
                                              theta[:bs], n_pad // bs)

            def chunk_fn(t):
                return sim.photometry_zsorted_device(
                    t, sub_chunk=sub, kc=kc, w_cols=w_cols, fused=fuse)
        else:  # the window is the whole table: the dense path
            self._check_fused_request(zsorted_fused)
            chunk_fn = sim.photometry
        meta = {"n": n, "batch_size": bs, "seed": seed, "order": "zsorted",
                "sampler": _DEVICE_SAMPLER}
        chunks = self._run_batches(
            lambda i: {"phot": chunk_fn(theta[i:i + bs])}, n_pad, bs, meta,
            resume_path)
        return self._library(theta[:n].cpu().numpy(), chunks["phot"][:n])

    def _draw_sorted(self, n: int, batch_size: int, seed: int):
        """θ drawn on the device, sorted by redshift and padded to whole
        batches, with one window plan for every sub-chunk of the run (one
        readback). Returns (θ, sub-chunk rows, batch rows, kc, w_cols)."""
        sim = self.simulator
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        theta = self.sample_parameters_device(n, gen)
        iz = sim.param_names.index("redshift")
        theta = theta[torch.sort(theta[:, iz], stable=True).indices]
        sub = int(min(1024, batch_size))
        bs = int(np.ceil(batch_size / sub) * sub)
        n_pad = int(np.ceil(n / bs) * bs)
        if n_pad != n:  # pad with the last (highest-z) row: windows stay tight
            theta = torch.cat([theta, theta[-1:].expand(n_pad - n, -1)], dim=0)
        # the simulator's planner, over the whole run
        _, _, kc, w_cols, _, _ = sim._plan_windows(theta, sub)
        return theta, sub, bs, kc, w_cols

    def _padded(self, theta: np.ndarray, n_pad: int):
        """Host θ padded with its last row to `n_pad` rows, on the device."""
        pad = np.repeat(theta[-1:], n_pad - theta.shape[0], axis=0)
        return torch.as_tensor(np.concatenate([theta, pad]),
                               device=self.device)

    def _run_span(self, z, batch_size: int, sub: int) -> int:
        """The largest knot span of any sub-chunk of any batch of z-sorted
        redshifts `z` (each batch padded with its last row to whole
        sub-chunks, as the window engine pads it); one readback."""
        k = self.simulator._knot_interval_device(z)
        spans = []
        for i in range(0, k.shape[0], batch_size):
            kb = k[i:i + batch_size]
            pad = -(-kb.shape[0] // sub) * sub - kb.shape[0]
            kb = torch.cat([kb, kb[-1:].expand(pad)])
            spans.append((kb[sub - 1::sub] - kb[::sub]).max())
        return int(torch.stack(spans).max())

    def _run_batches(self, run, n_pad: int, batch_size: int, meta: dict,
                     resume_path: str | None) -> dict:
        """Run `run(row offset) -> {field: (B, ...) tensor}` over the
        batches, resuming from and writing chunk files when `resume_path`
        is set. Photometry alone stays on the device until the end (no
        wait for the card per batch); spectra and supplementary columns
        come to the host batch by batch. Returns {field: (n_pad, ...) host
        array}."""
        n_batches = n_pad // batch_size
        done = ([] if resume_path is None
                else _load_chunks(resume_path, meta))[:n_batches]
        parts = list(done)
        for ci in range(len(done), n_batches):
            out = run(ci * batch_size)
            if resume_path is None and list(out) == ["phot"]:
                parts.append(out)
                continue
            arrays = {k: v.cpu().numpy() for k, v in out.items()}
            if resume_path is not None:
                _save_chunk(resume_path, ci, meta, arrays)
            parts.append(arrays)
        if resume_path is not None:
            _remove_chunks(resume_path, n_batches)
        return {k: np.concatenate([np.asarray(torch.as_tensor(p[k]).cpu())
                                   for p in parts]) for k in parts[0]}

    # -- the window body ----------------------------------------------------
    def _check_fused_request(self, requested) -> None:
        """An explicit fused body on a model K1 does not run raises (the JAX
        package warns and takes the staged body)."""
        if (requested is True
                and not self.simulator._window_mega_supported()):
            raise ValueError(
                "zsorted_fused=True but the fused window body does not "
                "support this simulator (see _window_mega_supported)")

    def _choose_zsorted_fused(self, requested, sub: int, kc: int,
                              w_cols: int, probe_theta, n_batches: int) -> bool:
        """The window body of a z-sorted run: True runs K1, False the staged
        body.

        True/False are honoured (True on a model K1 does not run raises).
        "auto" takes the staged body on the CPU and where a model K1 does
        not run. On the card it looks up the choice on the simulator under
        (sub, kc, w_cols, batch rows); failing that, a run of fewer than 4
        batches takes K1 (the faster body in every H100 reading of PERF.md)
        without timing anything, and a longer run
        looks in `ZSORTED_PROBE_FILE` under `zsorted_probe_digest`, and
        failing that times one warm batch (`probe_theta`) through each body
        with CUDA events, keeps the faster and stores the choice in both
        places. A body that fails to build or launch raises: it does not
        lose the vote."""
        sim = self.simulator
        if requested != "auto":
            self._check_fused_request(requested)
            return bool(requested)
        if sim.device.type != "cuda":
            self.last_probe = {"source": "cpu", "fused": False}
            return False
        if not sim._window_mega_supported():
            self.last_probe = {"source": "unsupported", "fused": False}
            return False
        batch = int(probe_theta.shape[0])
        key = (int(sub), int(kc), int(w_cols), batch)
        cache = sim.__dict__.setdefault("_zsorted_fused_probe", {})
        if key in cache:
            self.last_probe = dict(cache[key], source="simulator")
            return cache[key]["fused"]
        if n_batches < _PROBE_MIN_BATCHES:
            self.last_probe = {"source": "short run", "fused": True}
            return True
        digest = zsorted_probe_digest(sim, key[:3], batch,
                                      torch.cuda.get_device_name(sim.device))
        stored = _read_probe_file().get(digest)
        if stored is not None:
            cache[key] = stored
            self.last_probe = dict(stored, source="file")
            return stored["fused"]
        record = dict(_probe_bodies(sim, probe_theta, sub, kc, w_cols),
                      digest=digest)
        cache[key] = record
        _write_probe_file(digest, record)
        self.last_probe = dict(record, source="probe")
        return record["fused"]

    # -- results ------------------------------------------------------------
    def _library(self, theta: np.ndarray, photometry: np.ndarray) -> dict:
        sim = self.simulator
        return {
            "parameters": theta.T,  # (P, N) reference convention
            "parameter_names": list(sim.param_names),
            "photometry": photometry.T,  # (F, N)
            "filter_codes": list(sim.filters.codes),
            "photometry_units": "nJy",
        }

    def _empty_library(self, want_spectra: bool) -> dict:
        """n=0 result with the schema of a non-empty `generate` call."""
        sim = self.simulator
        lib = self._library(np.zeros((0, len(sim.param_names)), np.float32),
                            np.zeros((0, len(sim.filters)), np.float32))
        if want_spectra:
            lib["spectra"] = np.zeros((sim.grid.n_wav, 0), np.float32)
            lib["wavelengths"] = np.asarray(sim.grid.lam)
        if self.supplementary:
            lib["supplementary_parameters"] = np.zeros(
                (len(self.supplementary), 0), np.float32)
            lib["supplementary_parameter_names"] = list(self.supplementary)
        return lib

    def _save(self, out_path: str | None, lib: dict) -> None:
        if out_path is None:
            return
        save_library_hdf5(
            out_path, parameters=lib["parameters"],
            parameter_names=lib["parameter_names"],
            photometry=lib["photometry"], filter_codes=lib["filter_codes"],
            spectra=lib.get("spectra"),
            supplementary_parameters=lib.get("supplementary_parameters"),
            supplementary_parameter_names=lib.get(
                "supplementary_parameter_names"),
            extra_datasets=({"Wavelengths": lib["wavelengths"]}
                            if "wavelengths" in lib else None),
            model_group_writer=lambda grp: _write_model_group(
                grp, self.simulator, self.param_ranges, self.unlog_keys,
                embed_grid=self.embed_grid))


# ---------------------------------------------------------------------------
# Model group: persist and rebuild the simulator
# ---------------------------------------------------------------------------


def grid_content_hash(grid: SPSGrid) -> str:
    """sha256 hex digest over the grid's axes and spectra, the JAX
    package's for the same grid."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(grid.log10_ages, np.float64).tobytes())
    h.update(np.ascontiguousarray(grid.metallicities, np.float64).tobytes())
    h.update(np.ascontiguousarray(grid.lam, np.float64).tobytes())
    for name, vals in grid.extra_axes.items():
        h.update(name.encode())
        h.update(np.ascontiguousarray(vals, np.float64).tobytes())
    for t in sorted(grid.spectra):
        h.update(t.encode())
        h.update(np.ascontiguousarray(grid.spectra[t], np.float32).tobytes())
    return h.hexdigest()


def _write_model_group(grp, sim: BatchSEDSimulator, param_ranges=None,
                       unlog_keys=None, embed_grid: bool = False) -> None:
    grp.attrs["grid_name"] = sim.grid.name
    grp.attrs["simulator_class"] = type(sim).__name__
    grp.attrs["sfh"] = sim.sfh_name
    grp.attrs["zdist"] = sim.zdist_name
    grp.attrs["param_names"] = list(sim.param_names)
    grp.attrs["emission_config"] = json.dumps(sim.emission.to_dict())
    grp.attrs["cosmology"] = json.dumps(sim.cosmology.to_dict())
    grp.attrs["fixed_params"] = json.dumps(
        {k: float(v) for k, v in sim.fixed_params.items()})
    if param_ranges is not None:
        grp.attrs["param_ranges"] = json.dumps(
            {k: [float(v[0]), float(v[1])] for k, v in param_ranges.items()})
    if unlog_keys is not None:
        grp.attrs["unlog_keys"] = json.dumps(list(unlog_keys))
    sim.filters.to_hdf5(grp.create_group("instrument"))
    gg = grp.create_group("grid")
    gg.attrs["name"] = sim.grid.name
    gg.attrs["content_hash"] = grid_content_hash(sim.grid)
    gg.attrs["spectra_types"] = sorted(sim.grid.spectra.keys())
    gg.attrs["embedded"] = bool(embed_grid)
    gg.create_dataset("log10_ages", data=sim.grid.log10_ages)
    gg.create_dataset("metallicities", data=sim.grid.metallicities)
    gg.create_dataset("lam", data=sim.grid.lam)
    if sim.grid.extra_axes:
        ea = gg.create_group("extra_axes")
        ea.attrs["order"] = list(sim.grid.extra_axis_names)
        for k, v in sim.grid.extra_axes.items():
            ea.create_dataset(k, data=np.asarray(v))
    if embed_grid:
        sp = gg.create_group("spectra")
        for t, s in sim.grid.spectra.items():
            sp.create_dataset(t, data=s, compression="gzip")


def simulator_from_library(path: str, grid: SPSGrid | None = None,
                           verify_grid: bool = True, *, device,
                           **overrides) -> BatchSEDSimulator:
    """Rebuild the forward model from a library's Model group, written by
    this package or the JAX package.

    Args:
        grid: the SPS grid; required when the file stores only a grid
            reference (the default), and checked against the stored
            content hash unless `verify_grid` is False.
        device: where the simulator runs.
        overrides: keyword arguments of `BatchSEDSimulator` that replace
            the stored ones.
    """
    import h5py

    with h5py.File(path, "r") as f:
        if "Model" not in f:
            raise ValueError(f"{path} has no Model group")
        grp = f["Model"]
        cls_name = str(grp.attrs.get("simulator_class", "BatchSEDSimulator"))
        if cls_name != "BatchSEDSimulator":
            raise NotImplementedError(
                f"{path} was generated by a {cls_name}, which is not ported "
                "yet (ROADMAP M14 item 3: composite and AGN simulators)")
        kwargs = dict(
            sfh=str(grp.attrs["sfh"]), zdist=str(grp.attrs["zdist"]),
            param_names=tuple(_text(grp.attrs["param_names"])),
            emission=EmissionConfig.from_dict(
                json.loads(grp.attrs["emission_config"])),
            cosmology=Cosmology.from_dict(json.loads(grp.attrs["cosmology"])),
            fixed_params=json.loads(grp.attrs["fixed_params"]),
            filters=FilterSet.from_hdf5(grp["instrument"]))
        gg = grp["grid"]
        stored_hash = str(gg.attrs.get("content_hash", ""))
        if grid is None:
            if "spectra" not in gg:
                raise ValueError(
                    f"{path} stores only a grid reference "
                    f"(name={gg.attrs['name']!r}, hash={stored_hash[:12]}...)"
                    "; pass the matching SPSGrid via grid=..., or regenerate "
                    "the library with embed_grid=True")
            extra = {}
            if "extra_axes" in gg:
                order = _text(gg["extra_axes"].attrs["order"])
                extra = {k: gg["extra_axes"][k][:] for k in order}
            grid = SPSGrid(
                name=str(gg.attrs["name"]), log10_ages=gg["log10_ages"][:],
                metallicities=gg["metallicities"][:], lam=gg["lam"][:],
                spectra={t: gg["spectra"][t][:] for t in gg["spectra"]},
                extra_axes=extra)
        elif verify_grid and stored_hash:
            supplied = grid_content_hash(grid)
            if supplied != stored_hash:
                raise ValueError(
                    f"supplied grid content hash {supplied[:12]}... does not "
                    f"match the library's {stored_hash[:12]}... (stored "
                    f"grid_name={gg.attrs['name']!r}); pass verify_grid=False "
                    "to override")
    kwargs.update(overrides)
    return BatchSEDSimulator(grid=grid, device=device, **kwargs)
