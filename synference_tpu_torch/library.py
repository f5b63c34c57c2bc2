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
  `simulate`. Emission-line columns (`emission_lines`) come from
  `BatchSEDSimulator.line_quantities` per batch; spectra pass through a
  `spectra.SpectralFeaturePipeline` (`spectral_pipeline`) onto an
  instrument grid, recorded as `Wavelengths`. Every batch numbers its rows
  from its offset in the run, so particle SFZHs follow the rows' global
  indices.

The window body of z-sorted runs is K1 (the fused body) or the staged body,
by one rule (`_fused_window_body`): `zsorted_fused="auto"` takes K1 on the
card wherever K1 runs the model, and the staged body on the CPU and for
models K1 does not run. Libraries are written and read in the reference's
HDF5 schema, with a `Model` group from which `simulator_from_library`
rebuilds the simulator; files are interchangeable with the JAX package's.
h5py and scipy are imported where they are used.

Deliberate differences from the JAX package: where it warns and falls back
(an unsupported `zsorted_fused=True`, a `device_sampling=True` it cannot
honour) this package raises; device-sampler resume chunks carry their own
tag, because a `torch.Generator` draws other θ than `jax.random`; an unknown
simulator class in a library file (not in `sed.SIMULATOR_REGISTRY`)
raises instead of building the base simulator; and "auto" chooses by that
rule, where the JAX package times both bodies once per configuration.
Simulators without the window engine (the AGN simulators, a composite) take
the host path and the dense `simulate`.
"""

from __future__ import annotations

import concurrent.futures
import datetime
import hashlib
import inspect
import json
import os

import numpy as np
import torch

from .cosmology import Cosmology
from .filters import FilterSet
from .grids import SPSGrid
from .runtime import span, traced
from .sed import BatchSEDSimulator, EmissionConfig

__all__ = ["auto_batch_size", "draw_from_hypercube",
           "draw_from_hypercube_device", "save_library_hdf5",
           "load_library_hdf5", "LibraryCreator", "LibraryGenerator",
           "grid_content_hash", "simulator_from_library"]

# resume-chunk tags: θ of the host sampler is the JAX package's, the device
# sampler's is not (the JAX package tags its own device chunks "device")
_HOST_SAMPLER = "host"
_DEVICE_SAMPLER = "torch-device"


def _supports(sim, gate: str) -> bool:
    """`sim`'s own gate `gate` ("_window_supported" for the z-sorted window
    engine, "_window_mega_supported" for K1 in it): False for a simulator
    without the engine (a composite) and, by the gate itself, for a
    subclass with its own forward model (the AGN simulators)."""
    return getattr(sim, gate, lambda: False)()


def _fused_window_body(sim, requested) -> bool:
    """The window body of a z-sorted run of `sim`: True runs K1, False the
    staged body. `requested` True or False is honoured, and True on a model
    K1 does not run raises (the JAX package warns and takes the staged
    body). "auto" takes K1 on the card wherever K1 runs the model, and the
    staged body on the CPU and for models K1 does not run."""
    k1 = _supports(sim, "_window_mega_supported")
    if requested == "auto":
        return sim.device.type == "cuda" and k1
    if requested is True and not k1:
        raise ValueError(
            "zsorted_fused=True but the fused window body does not "
            "support this simulator (see _window_mega_supported)")
    return bool(requested)


def _takes_row_offset(fn) -> bool:
    """True when `fn`'s second positional parameter is named row_offset
    (then `generate` passes each batch's absolute row offset)."""
    try:
        pos = [p for p in inspect.signature(fn).parameters.values()
               if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    except (TypeError, ValueError):
        return False
    return len(pos) >= 2 and pos[1].name == "row_offset"


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
            chunks.append({k: ck[k] for k in ("phot", "spec", "supp",
                                              "lines")
                           if k in ck.files})
    return chunks


# the span of each field's blocking read in `_to_host`
_READBACK_SPANS = {"phot": "readback.photometry", "spec": "readback.spectra",
                   "supp": "readback.supplementary",
                   "lines": "readback.lines"}


def _to_host(field: str, v) -> np.ndarray:
    """A batch's part of `field` as a host array, for runs that write each
    batch to its chunk file (`resume_path`): a tensor is read back from its
    device (one `readback.<field>` span: `readback.photometry`,
    `readback.spectra`, ...), a host array is kept."""
    if isinstance(v, np.ndarray):
        return v
    with span(_READBACK_SPANS[field]):
        return v.cpu().numpy()


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
# Copy-out of runs without `resume_path`: each batch's parts land in the
# run's host arrays while the card computes the next batches
# ---------------------------------------------------------------------------

# pinned slots a generator keeps: one landing on the host, one copying, one
# waiting for its batch
_RING_SLOTS = 3


def _rows_to_copy(v: torch.Tensor, rows: int) -> torch.Tensor:
    """The first `rows` rows of a 2-D device part as a contiguous tensor:
    a column slice of a row-major buffer padded by fewer than 8 columns
    (K1's `out[:, :F]` of its (B, F8) output) is read whole over the same
    memory, for the host to drop the padding; any other layout is made
    contiguous on the device."""
    s0 = v.stride(0)
    if (v.stride(1) == 1 and v.shape[1] <= s0 < v.shape[1] + 8
            and (v.storage_offset() + rows * s0) * v.element_size()
            <= v.untyped_storage().nbytes()):
        return v.as_strided((rows, s0), (s0, 1))
    return v[:rows].contiguous()


def _numpy_dtype(v) -> np.dtype:
    if isinstance(v, np.ndarray):
        return v.dtype
    return torch.empty((), dtype=v.dtype).numpy().dtype


class _PinnedRing:
    """`_RING_SLOTS` pinned host slots per field, a copy stream from
    PyTorch's pool, and one host thread (`lander`, started at its first
    use) that moves landed slots into a run's arrays. The slots are
    allocated at the first run of a batch shape and kept by the generator
    while its runs keep that shape, so pinned memory depends on the batch
    and not on a run's length."""

    def __init__(self):
        self.key = None
        self.stream = None
        self.slots: dict = {}  # field -> (slots, rows, width) pinned tensor
        self.lander = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="synference-copy-out")

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.slots.values())

    @staticmethod
    def takes(v) -> bool:
        """Whether a part leaves through the slots: a CUDA tensor."""
        return isinstance(v, torch.Tensor) and v.is_cuda

    @staticmethod
    def key_of(rows: int, parts: dict) -> tuple:
        """The slots' shape for batches of `rows` rows of `parts` ({field:
        (·, width) device tensor})."""
        device = next(iter(parts.values())).device
        return device, rows, tuple((k, v.shape[1], v.dtype)
                                   for k, v in parts.items())

    def fit(self, key: tuple, parts: dict) -> None:
        """Slots of shape `key` (`key_of`), reallocated only when it
        changes. No copy into the old slots may be pending."""
        if key == self.key:
            return
        device, rows, _ = key
        self.slots = {k: torch.empty((_RING_SLOTS, rows, v.shape[1]),
                                     dtype=v.dtype, pin_memory=True)
                      for k, v in parts.items()}
        self.stream = torch.cuda.Stream(device)
        self.key = key

    def copy(self, slot: int, rows: int, parts: dict):
        """Enqueue the copies of `parts`' first `rows` rows into `slot` on
        the copy stream, behind the compute stream's work so far; returns
        the event that marks them done."""
        stream = self.stream
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            for k, v in parts.items():
                self.slots[k][slot, :rows].copy_(v, non_blocking=True)
        return stream.record_event()


class _Staged:
    """A staged batch: its copy's event, its slot of each field, its row
    offset, its device parts, and its landing once handed to the ring's
    thread."""

    def __init__(self, done, slots: dict, lo: int, parts: dict):
        self.done, self.slots, self.lo, self.parts = done, slots, lo, parts
        self.landing = None


class _CopyOut:
    """Lands a run's parts in host arrays of its first `n` rows, batch by
    batch; pad rows past `n` are never copied. A CUDA part is copied on the
    ring's stream, once the compute stream has finished its batch, into a
    pinned slot. Once that copy has finished (`event.query`, looked at as
    each batch is staged) the ring's thread moves the slot into the result
    rows while this thread goes on with the next batches; the ring's thread
    makes no CUDA call. This thread waits (`readback.part`) only to reuse a
    slot or at the end, and lands a copy it had to wait for itself. Host
    tensors and arrays are written in place. The result arrays are new for
    each run: the caller owns them."""

    def __init__(self, n: int, batch_size: int, ring: _PinnedRing):
        self.n, self.batch_size, self.ring = n, batch_size, ring
        self.out: dict = {}
        self.pending: list = []  # `_Staged` batches not yet landed, in order
        self.staged = 0

    def stage(self, lo: int, parts: dict) -> None:
        """Part rows [lo, lo + batch) of each field ({field: (B, width)})."""
        rows = min(self.n, lo + self.batch_size) - lo
        for k, v in parts.items():
            if k not in self.out:
                self.out[k] = np.empty((self.n, v.shape[1]), _numpy_dtype(v))
        dev = {k: _rows_to_copy(v, rows) for k, v in parts.items()
               if self.ring.takes(v)}
        if dev:
            key = _PinnedRing.key_of(self.batch_size, dev)
            # a new shape takes new slots; a slot is reused once landed
            while self.pending and (key != self.ring.key
                                    or len(self.pending) >= _RING_SLOTS):
                self._wait_oldest()
            self.ring.fit(key, dev)
        with span("library.stage"):
            for k, v in parts.items():
                if k not in dev:
                    self.out[k][lo:lo + rows] = (
                        v[:rows] if isinstance(v, np.ndarray)
                        else v[:rows].numpy())
            if dev:
                slot = self.staged % _RING_SLOTS
                self.staged += 1
                # `dev` holds the parts' device memory until their copy
                # has finished
                self.pending.append(_Staged(
                    self.ring.copy(slot, rows, dev),
                    {k: self.ring.slots[k][slot] for k in dev}, lo, dev))
            self._hand_over()

    def _hand_over(self) -> None:
        """Give the ring's thread each batch whose copy has finished (the
        copies finish in order), and drop the batches that have landed."""
        for b in self.pending:
            if b.landing is None:
                if not b.done.query():
                    break
                b.landing = self.ring.lander.submit(self._land, b)
        while (self.pending and self.pending[0].landing is not None
               and self.pending[0].landing.done()):
            self.pending.pop(0).landing.result()

    def _land(self, b: _Staged) -> None:
        """Move a batch's slot into its result rows; its copy has
        finished. Torch's host copy lets go of the interpreter lock, so the
        other thread runs on (numpy's assignment holds the lock for much of
        its copy)."""
        for k, v in b.parts.items():
            rows = v.shape[0]
            torch.from_numpy(self.out[k][b.lo:b.lo + rows]).copy_(
                b.slots[k][:rows, :self.out[k].shape[1]])

    def _wait_oldest(self) -> None:
        b = self.pending.pop(0)
        if b.landing is None:
            if not b.done.query():
                with span("readback.part"):
                    b.done.synchronize()
            self._land(b)
        elif b.landing.done():
            b.landing.result()
        else:
            with span("readback.part"):
                b.landing.result()

    def finish(self) -> dict:
        """Wait for the last landings; {field: (n, width) host array}."""
        with span("library.to_host"):
            while self.pending:
                self._wait_oldest()
        return self.out


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
        spectral_pipeline: a `spectra.SpectralFeaturePipeline`; with
            `want_spectra` the stored spectra are its output on its
            instrument grid (needs a redshift parameter).
        emission_lines: line ids of the grid's line tables; each adds
            `line_flux_{id}` [erg/s/cm²] and `line_ew_{id}` (observed EW,
            Å) supplementary columns, after any `supplementary` ones.
        embed_grid: store the grid's spectra in the Model group (a
            self-contained file); by default only its name, axes and
            content hash.
        device: where the simulator runs; must be the simulator's device.

    `pad_rows` counts the rows its calls have run past their n: a
    device-sampled call pads to whole sub-chunks, a host-sampled one to
    whole batches.
    """

    def __init__(self, simulator: BatchSEDSimulator, param_ranges: dict,
                 unlog_keys: list | None = None, supplementary: tuple = (),
                 engine: str = "lhc", spectral_pipeline=None,
                 emission_lines: tuple = (), embed_grid: bool = False, *,
                 device):
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
        self.spectral_pipeline = spectral_pipeline
        self.emission_lines = tuple(emission_lines)
        self.engine = engine
        self.embed_grid = bool(embed_grid)
        # pinned slots through which runs without resume_path leave the card
        self._pinned = _PinnedRing()
        # rows the calls have computed past their n, summed over the calls
        self.pad_rows = 0
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
    @traced("library.generate")
    def generate(self, n: int, batch_size: int | None = None, seed: int = 0,
                 out_path: str | None = None, want_spectra: bool = False,
                 pmapped_fn=None, resume_path: str | None = None,
                 presort: bool = False, zsorted_fused: bool | str = "auto",
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
        (the staged body) or "auto": K1 on the card wherever K1 runs the
        model, else the staged body. True on a model K1 does not run
        raises.

        `pmapped_fn`: a batch function θ (B, P) on the device -> dict with
        "photometry_njy" (and "fnu_njy" with spectra, the `simulate` outputs
        with supplementary quantities) in place of the simulator: the hook
        of `parallel/`'s sharded functions. It takes the host sampler, and
        receives each batch's absolute row offset when its second positional
        parameter is named `row_offset`. `presort` sorts the draws by
        redshift first (rows are exchangeable; batches then span narrow z
        ranges), for a batch function that windows by redshift.
        """
        sim = self.simulator
        wide = want_spectra or bool(self.supplementary)
        if batch_size is None:
            batch_size = auto_batch_size(
                n, spectra_width=int(sim.grid.n_wav) if wide else None)
        if n == 0:
            lib = self._empty_library(want_spectra)
            self._save(out_path, lib)
            return lib
        device_ok = (pmapped_fn is None and not wide
                     and not self.emission_lines
                     and self.engine in ("lhc", "random")
                     and "redshift" in sim.param_names
                     and _supports(sim, "_window_supported"))
        if device_sampling is None:
            device_sampling = device_ok
        elif device_sampling and not device_ok:
            raise ValueError(
                "device_sampling=True, but this generation needs the host "
                "sampler (spectra, supplementary quantities or emission "
                "lines, a pmapped_fn, a scipy QMC engine, a fixed redshift, "
                "or a model the window engine cannot run)")
        if device_sampling:
            lib = self._generate_device(n, batch_size, seed, resume_path,
                                        zsorted_fused)
        else:
            lib = self._generate_host(n, batch_size, seed, want_spectra,
                                      resume_path, zsorted_fused, pmapped_fn,
                                      presort)
        self._save(out_path, lib)
        return lib

    def _generate_host(self, n, batch_size, seed, want_spectra, resume_path,
                       zsorted_fused, pmapped_fn=None,
                       presort: bool = False) -> dict:
        """θ from the host sampler; through `pmapped_fn` when given, else
        z-sorted through the window engine when it runs the model and its
        window is not the whole table, else the dense `simulate`, one batch
        of `batch_size` rows at a time."""
        sim = self.simulator
        wide = want_spectra or bool(self.supplementary)
        with span("library.draw_host"):
            theta = self.sample_parameters(n,
                                           rng=np.random.default_rng(seed))
        n_pad = int(np.ceil(n / batch_size) * batch_size)
        batch_fn = None
        if pmapped_fn is not None:
            row_order = "input"
            if presort and "redshift" in sim.param_names:
                iz = sim.param_names.index("redshift")
                theta = theta[np.argsort(theta[:, iz], kind="stable")]
                row_order = "zsorted"
            theta_dev = self._padded(theta, n_pad)
            offset = _takes_row_offset(pmapped_fn)

            def batch_fn(t, i):
                out = pmapped_fn(t, i) if offset else pmapped_fn(t)
                return {k: torch.as_tensor(v, device=self.device)
                        for k, v in out.items()}
        elif (not wide and "redshift" in sim.param_names
                and _supports(sim, "_window_supported")):
            iz = sim.param_names.index("redshift")
            ordered = theta[np.argsort(theta[:, iz], kind="stable")]
            theta_dev = self._padded(ordered, n_pad)  # last row: tight windows
            sub = min(1024, batch_size)
            kc, w_cols = sim._zsorted_plan(
                self._run_span(theta_dev[:, iz], batch_size, sub))
            if kc < sim._n_knots and w_cols < sim._l_sup:
                theta, row_order = ordered, "zsorted"
                fuse = _fused_window_body(sim, zsorted_fused)

                def batch_fn(t, i):
                    return {"photometry_njy": sim.photometry_zsorted_device(
                        t, sub_chunk=sub, row_offset=i, kc=kc,
                        w_cols=w_cols, fused=fuse)}
        if batch_fn is None:
            theta_dev, row_order = self._padded(theta, n_pad), "input"
            _fused_window_body(sim, zsorted_fused)  # True on no K1 raises

            def batch_fn(t, i):
                return sim.simulate(t, want_spectra=wide, row_offset=i)

        meta = {"n": n, "batch_size": batch_size, "seed": seed,
                "order": row_order, "sampler": _HOST_SAMPLER}

        def run(i):
            t = theta_dev[i:i + batch_size]
            out = batch_fn(t, i)
            arrays = {"phot": out["photometry_njy"]}
            if want_spectra:
                arrays["spec"] = out["fnu_njy"]
                if self.spectral_pipeline is not None:
                    z = t[:, sim.param_names.index("redshift")]
                    arrays["spec"] = self.spectral_pipeline(out["fnu_njy"], z)
            if self.supplementary:
                from .supplementary import compute_supplementary

                arrays["supp"] = compute_supplementary(self.supplementary, sim,
                                                       t, out)
            if self.emission_lines:
                lq = sim.line_quantities(t, self.emission_lines, row_offset=i)
                arrays["lines"] = np.concatenate([lq["flux"], lq["ew_obs"]],
                                                 axis=1)
            return arrays

        chunks = self._run_batches(run, n, n_pad, batch_size, meta,
                                   resume_path)
        lib = self._library(theta, chunks["phot"])
        if want_spectra:
            lib["spectra"] = chunks["spec"].T
            lib["wavelengths"] = self._wavelengths()
        supp = [chunks[k].T for k in ("supp", "lines") if k in chunks]
        if supp:
            lib["supplementary_parameters"] = np.concatenate(supp, axis=0)
            lib["supplementary_parameter_names"] = self._supp_names()
        return lib

    def _wavelengths(self) -> np.ndarray:
        """The grid of the stored spectra: the pipeline's instrument grid,
        else the simulator's rest grid."""
        if self.spectral_pipeline is not None:
            return np.asarray(self.spectral_pipeline.obs_lam.cpu())
        return np.asarray(self.simulator.grid.lam)

    def _supp_names(self) -> list:
        """Supplementary column names: the quantities, then the line fluxes
        and the line EWs."""
        return (list(self.supplementary)
                + [f"line_flux_{i}" for i in self.emission_lines]
                + [f"line_ew_{i}" for i in self.emission_lines])

    def _generate_device(self, n, batch_size, seed, resume_path,
                         zsorted_fused) -> dict:
        """Photometry-only generation on the device: θ drawn, z-sorted,
        padded to whole sub-chunks (the last batch may be shorter than
        `batch_size`), window-planned once for the run and simulated there;
        two readbacks for the run's plan and none a batch: each batch takes
        its slice of the run's window starts, so the host enqueues the next
        batch while the card runs this one. Each batch's photometry and its
        rows of θ leave the card while the next batches run (`_CopyOut`)."""
        sim = self.simulator
        theta, sub, bs, kc, w_cols, (k0, l0) = self._draw_sorted(
            n, batch_size, seed)
        n_pad = theta.shape[0]
        if kc < sim._n_knots and w_cols < sim._l_sup:
            fuse = _fused_window_body(sim, zsorted_fused)

            def chunk_fn(t, row_offset):
                # a batch starts at a whole sub-chunk and holds whole ones
                own = slice(row_offset // sub, (row_offset + len(t)) // sub)
                return sim.photometry_zsorted_device(
                    t, sub_chunk=sub, row_offset=row_offset, kc=kc,
                    w_cols=w_cols, fused=fuse, starts=(k0[own], l0[own]))
        else:  # the window is the whole table: the dense path
            _fused_window_body(sim, zsorted_fused)  # True on no K1 raises
            chunk_fn = sim.photometry
        meta = {"n": n, "batch_size": bs, "seed": seed, "order": "zsorted",
                "sampler": _DEVICE_SAMPLER}
        chunks = self._run_batches(
            lambda i: {"phot": chunk_fn(theta[i:i + bs], row_offset=i)},
            n, n_pad, bs, meta, resume_path, beside={"theta": theta})
        if "theta" not in chunks:  # a resumed run's parts came batch by batch
            with span("library.to_host"), span("readback.theta"):
                chunks["theta"] = theta[:n].cpu().numpy()
        return self._library(chunks["theta"], chunks["phot"])

    @traced("library.draw_sorted")
    def _draw_sorted(self, n: int, batch_size: int, seed: int):
        """θ drawn on the device, sorted by redshift and padded with its
        last (highest-z) row to whole sub-chunks, not whole batches: the pad
        sub-chunks span no knot, so the run's plan and every real row's
        inputs are those of a whole-batch pad. One window plan for every
        sub-chunk of the run (two readbacks: its span, then its window
        starts). Returns (θ, sub-chunk rows, batch rows, kc, w_cols,
        (k0, l0)): the starts as host int lists, one per sub-chunk of the
        run, or (None, None) when the window is the whole table."""
        sim = self.simulator
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        theta = self.sample_parameters_device(n, gen)
        iz = sim.param_names.index("redshift")
        theta = theta[torch.sort(theta[:, iz], stable=True).indices]
        sub = int(min(1024, batch_size))
        bs = int(np.ceil(batch_size / sub) * sub)
        n_pad = int(np.ceil(n / sub) * sub)
        if n_pad != n:  # pad with the last (highest-z) row: windows stay tight
            theta = torch.cat([theta, theta[-1:].expand(n_pad - n, -1)], dim=0)
        # the simulator's planner, over the whole run
        _, _, kc, w_cols, k0, l0 = sim._plan_windows(theta, sub)
        return theta, sub, bs, kc, w_cols, (k0, l0)

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
        with span("readback.plan_span"):
            return int(torch.stack(spans).max())

    def _run_batches(self, run, n: int, n_pad: int, batch_size: int,
                     meta: dict, resume_path: str | None,
                     beside: dict | None = None) -> dict:
        """Run `run(row offset) -> {field: (B, width) part}` over the
        batches of `batch_size` rows of `n_pad`; the last batch is shorter
        when `batch_size` does not divide `n_pad`. Without `resume_path`
        every field, with the rows of each run-wide (n_pad, ...) device
        tensor in `beside`, leaves the card part by part through `_CopyOut`
        while the next batches run. With it, each batch comes to the host
        as it finishes (`_to_host`) to be written to its chunk file, and a
        restart resumes from the files; `beside` is not copied. Adds the
        rows run past `n` to `pad_rows`. Returns {field: (n, width) host
        array}."""
        n_batches = -(-n_pad // batch_size)

        def launch(lo):
            with span("library.batch"):
                out = run(lo)
            self.pad_rows += max(0, min(lo + batch_size, n_pad) - n)
            return out

        if resume_path is None:
            copy = _CopyOut(n, batch_size, self._pinned)
            for lo in range(0, n_pad, batch_size):
                out = launch(lo)
                for k, v in (beside or {}).items():
                    out[k] = v[lo:lo + batch_size]
                copy.stage(lo, out)
            return copy.finish()
        parts = _load_chunks(resume_path, meta)[:n_batches]
        for ci in range(len(parts), n_batches):
            out = launch(ci * batch_size)
            with span("library.to_host"):
                arrays = {k: _to_host(k, v) for k, v in out.items()}
            _save_chunk(resume_path, ci, meta, arrays)
            parts.append(arrays)
        _remove_chunks(resume_path, n_batches)
        with span("library.to_host"):
            return {k: np.concatenate([p[k] for p in parts])[:n]
                    for k in parts[0]}

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
            lib["wavelengths"] = self._wavelengths()
            lib["spectra"] = np.zeros((len(lib["wavelengths"]), 0), np.float32)
        names = self._supp_names()
        if names:
            lib["supplementary_parameters"] = np.zeros((len(names), 0),
                                                       np.float32)
            lib["supplementary_parameter_names"] = names
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
    if hasattr(sim, "model_extra"):
        grp.attrs["simulator_extra"] = json.dumps(sim.model_extra())
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
    this package or the JAX package: the stored class name is looked up in
    `sed.SIMULATOR_REGISTRY` (an unregistered name raises ValueError) and
    built with the stored arguments, `simulator_extra` (such as the AGN
    grid's `l_norm`) included.

    Args:
        grid: the SPS grid; required when the file stores only a grid
            reference (the default), and checked against the stored
            content hash unless `verify_grid` is False.
        device: where the simulator runs.
        overrides: constructor arguments that replace the stored ones.
    """
    import h5py

    from . import agn  # noqa: F401  (registers the AGN simulators)
    from .sed import SIMULATOR_REGISTRY

    with h5py.File(path, "r") as f:
        if "Model" not in f:
            raise ValueError(f"{path} has no Model group")
        grp = f["Model"]
        cls_name = str(grp.attrs.get("simulator_class", "BatchSEDSimulator"))
        if cls_name not in SIMULATOR_REGISTRY:
            raise ValueError(
                f"{path} was generated by a {cls_name}, which is not a "
                f"registered simulator class ({sorted(SIMULATOR_REGISTRY)})")
        sim_cls = SIMULATOR_REGISTRY[cls_name]
        kwargs = dict(
            sfh=str(grp.attrs["sfh"]), zdist=str(grp.attrs["zdist"]),
            param_names=tuple(_text(grp.attrs["param_names"])),
            emission=EmissionConfig.from_dict(
                json.loads(grp.attrs["emission_config"])),
            cosmology=Cosmology.from_dict(json.loads(grp.attrs["cosmology"])),
            fixed_params=json.loads(grp.attrs["fixed_params"]),
            filters=FilterSet.from_hdf5(grp["instrument"]))
        kwargs.update(json.loads(str(grp.attrs.get("simulator_extra", "{}"))))
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
    return sim_cls(grid=grid, device=device, **kwargs)
