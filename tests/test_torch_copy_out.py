"""How runs without `resume_path` leave the device (`library._CopyOut`).

Every field of such a run (photometry; spectra, the pipeline's features
or the raw f_ν; supplementary columns and emission lines), and on the
device sampler its rows of θ, lands in host arrays of the run's first n
rows, part by part; on the card through a ring of pinned slots on a copy
stream (`tests/test_torch_cuda.py`), on the CPU in place. The result is
bitwise the concatenation of the parts cut to n rows, for n a multiple of
the batch and ragged, and for every layout a part comes in: K1's column
slice of a wider buffer, a contiguous tensor, a host array; and bitwise
what a run with `resume_path` gives, field by field, for spectra with and
without a `SpectralFeaturePipeline` and with supplementary quantities and
emission lines. Each call returns arrays of its own. Runs with
`resume_path` still read each batch back as it finishes
(`readback.photometry`, `readback.spectra`, and θ once at the end).

The ring's thread lands each slot whose copy has finished while the
caller stages the next batches, and the caller lands a copy it had to
wait for; a slot is copied into again only after it has landed. A ring
over host memory whose copies are made at once and whose events report
them finished a random while later holds that under many runs at once,
with the interpreter switching threads every microsecond: a slot reused
too early shows as wrong rows.
"""

import concurrent.futures
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu_torch import library as tl
from synference_tpu_torch.runtime import trace_profile

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (1.0, 1.3),
         "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
         "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
BATCH = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    `tests/test_torch_spans.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    grid = tt.make_synthetic_grid(n_ages=8, n_mets=4, n_wav=1024)
    filt = tt.FilterSet([tt.tophat_filter("F150W", 15000., 3300.),
                         tt.tophat_filter("F277W", 27700., 7000.)])
    sim = tt.BatchSEDSimulator(grid, filt, PNAMES, sfh="lognormal",
                               zdist="delta", emission=tt.EmissionConfig(),
                               device="cpu")
    return tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                               device="cpu")


def _host(v) -> np.ndarray:
    return v if isinstance(v, np.ndarray) else v.numpy()


@pytest.mark.parametrize("kind", ["column_slice", "tensor", "ndarray"])
@pytest.mark.parametrize("batches", [1, 2, 5])
@pytest.mark.parametrize("ragged", [False, True])
def test_photometry_parts_land_in_place(gen, kind, batches, ragged):
    bs, f = 64, 7
    n_pad = batches * bs
    n = n_pad - 13 if ragged else n_pad
    rng = np.random.default_rng(batches)
    wide = torch.as_tensor(rng.normal(size=(n_pad, 8)).astype(np.float32))
    theta = torch.as_tensor(rng.normal(size=(n_pad, 6)).astype(np.float32))

    def run(lo):
        part = wide[lo:lo + bs, :f]  # K1's layout: a slice of (B, F8)
        if kind == "tensor":
            part = part.clone()
        elif kind == "ndarray":
            part = part.numpy().copy()
        return {"phot": part}

    got = gen._run_batches(run, n, n_pad, bs, {}, None,
                           beside={"theta": theta})
    ref = np.concatenate([_host(run(lo)["phot"])
                          for lo in range(0, n_pad, bs)])[:n]
    assert set(got) == {"phot", "theta"}
    assert got["phot"].shape == (n, f) and got["phot"].dtype == np.float32
    assert got["phot"].flags.c_contiguous
    np.testing.assert_array_equal(got["phot"], ref)
    np.testing.assert_array_equal(got["theta"], theta[:n].numpy())
    wide.zero_()  # the result owns its memory
    theta.zero_()
    np.testing.assert_array_equal(got["phot"], ref)
    assert np.abs(got["theta"]).sum() > 0


def test_rows_to_copy_reads_k1_padding_whole():
    """A column slice of a buffer padded by fewer than 8 columns is read
    over the same memory, padding included; any other layout is copied."""
    buf = torch.arange(40 * 8, dtype=torch.float32).reshape(40, 8)
    whole = tl._rows_to_copy(buf[:32, :7], 30)
    assert whole.shape == (30, 8) and whole.is_contiguous()
    assert whole.data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(whole[:, :7].numpy(), buf[:30, :7].numpy())
    rows = tl._rows_to_copy(buf[8:16], 5)  # a contiguous slice at an offset
    assert rows.data_ptr() == buf[8].data_ptr()
    np.testing.assert_array_equal(rows.numpy(), buf[8:13].numpy())
    far = torch.zeros(40, 16)[:, :7]  # 9 padding columns: not read
    assert tl._rows_to_copy(far, 10).shape == (10, 7)
    turned = buf.t()[:, :30]  # (8, 30) with column stride 8
    got = tl._rows_to_copy(turned, 6)
    assert got.shape == (6, 30) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), turned[:6].numpy())


@pytest.mark.parametrize("device_sampling", [True, False])
def test_second_call_leaves_first_arrays(gen, device_sampling):
    kw = dict(batch_size=BATCH, device_sampling=device_sampling)
    first = gen.generate(n=3 * BATCH - 7, seed=1, **kw)
    kept = {k: first[k].copy() for k in ("parameters", "photometry")}
    for seed in (1, 2):
        again = gen.generate(n=3 * BATCH - 7, seed=seed, **kw)
        for k, v in kept.items():
            np.testing.assert_array_equal(first[k], v)
            assert not np.shares_memory(first[k], again[k])


def _program_names(log_dir) -> list:
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [e["name"][len("synference::"):] for e in events
            if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("synference::")]


@pytest.mark.parametrize("device_sampling", [True, False])
def test_resume_branch_reads_each_batch_back(gen, tmp_path,
                                             device_sampling):
    """With `resume_path` each batch's part is read back as it finishes and
    θ once at the end, as before the copy-out; the bits equal a run
    without it, and the chunk files go when the run ends."""
    batches, n = 3, 3 * BATCH - 5
    kw = dict(n=n, batch_size=BATCH, seed=4, device_sampling=device_sampling)
    plain = gen.generate(**kw)
    prefix = tmp_path / "run" / "ck"
    prefix.parent.mkdir()
    with trace_profile(str(tmp_path / "trace")):
        resumed = gen.generate(resume_path=str(prefix), **kw)
    for key in ("parameters", "photometry"):
        np.testing.assert_array_equal(resumed[key], plain[key])
        assert resumed[key].shape[1] == n
    assert list(prefix.parent.iterdir()) == []
    names = _program_names(tmp_path / "trace")
    assert names.count("readback.photometry") == batches
    assert names.count("readback.theta") == (1 if device_sampling else 0)
    assert "library.stage" not in names and "readback.part" not in names


def test_host_sampler_photometry_takes_the_copy_out(gen, tmp_path):
    """The host sampler's photometry-only runs stage each batch too, and
    give the rows of a run that reads each batch back."""
    kw = dict(n=2 * BATCH + 9, batch_size=BATCH, seed=6,
              device_sampling=False)
    with trace_profile(str(tmp_path / "trace")):
        lib = gen.generate(**kw)
    names = _program_names(tmp_path / "trace")
    assert names.count("library.stage") == 3
    assert "readback.photometry" not in names
    ref = gen.generate(resume_path=str(tmp_path / "ck"), **kw)
    for key in ("parameters", "photometry"):
        np.testing.assert_array_equal(lib[key], ref[key])


# the spectra runs: a log-uniform grid the pipeline accepts, emission
# lines from its tables
SPEC_BATCH = 32


@pytest.fixture(scope="module")
def spec_gens():
    grid = tt.make_synthetic_grid(n_ages=8, n_mets=4, n_wav=2048,
                                  lam_min=500.0, lam_max=1.0e5)
    filt = tt.FilterSet([tt.tophat_filter("F150W", 15000., 3300.),
                         tt.tophat_filter("F277W", 27700., 7000.)])
    sim = tt.BatchSEDSimulator(grid, filt, PNAMES, sfh="lognormal",
                               zdist="delta", emission=tt.EmissionConfig(),
                               device="cpu")
    pipe = tt.SpectralFeaturePipeline(
        grid.lam, tt.generate_constant_r_grid(100, 6000, 40000),
        instrument_r=100, norm_window=(15000, 25000), device="cpu")
    lines = tuple(grid.lines["ids"][3:5])
    kinds = {"pipeline": dict(spectral_pipeline=pipe), "raw": {},
             "supp_lines": dict(spectral_pipeline=pipe,
                                supplementary=("m_uv", "beta_uv"),
                                emission_lines=lines)}
    return {k: tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                                   device="cpu", **kw)
            for k, kw in kinds.items()}


_SPEC_KEYS = ("parameters", "photometry", "spectra", "wavelengths",
              "supplementary_parameters")


@pytest.mark.parametrize("kind", ["pipeline", "raw", "supp_lines"])
@pytest.mark.parametrize("batches", [1, 2, 5])
@pytest.mark.parametrize("ragged", [False, True])
def test_spectra_runs_take_the_copy_out(spec_gens, tmp_path, kind, batches,
                                        ragged):
    """Every field of a spectra run stages once a batch, reads nothing
    back field by field, and equals the run through `resume_path`."""
    gen = spec_gens[kind]
    n = batches * SPEC_BATCH - (5 if ragged else 0)
    kw = dict(n=n, batch_size=SPEC_BATCH, seed=batches, want_spectra=True)
    with trace_profile(str(tmp_path / "trace")):
        lib = gen.generate(**kw)
    names = _program_names(tmp_path / "trace")
    assert names.count("library.stage") == batches
    assert names.count("library.to_host") == 1
    assert not [s for s in names if s.startswith("readback.")
                and s != "readback.part"]
    ref = gen.generate(resume_path=str(tmp_path / "ck"), **kw)
    keys = [k for k in _SPEC_KEYS if k in ref]
    assert keys == [k for k in _SPEC_KEYS if k in lib]
    assert ("supplementary_parameters" in keys) == (kind == "supp_lines")
    for key in keys:
        assert lib[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(lib[key], ref[key])
    assert lib["spectra"].shape[1] == n
    assert np.isfinite(lib["spectra"]).all()


def test_second_spectra_call_leaves_first_arrays(spec_gens):
    gen = spec_gens["supp_lines"]
    kw = dict(n=3 * SPEC_BATCH - 7, batch_size=SPEC_BATCH,
              want_spectra=True)
    first = gen.generate(seed=1, **kw)
    keys = ("spectra", "photometry", "supplementary_parameters")
    kept = {k: first[k].copy() for k in keys}
    for seed in (1, 2):
        again = gen.generate(seed=seed, **kw)
        for k in keys:
            np.testing.assert_array_equal(first[k], kept[k])
            assert not np.shares_memory(first[k], again[k])


def test_spectra_resume_branch_reads_each_batch_back(spec_gens, tmp_path):
    """With `resume_path` a spectra run reads each field of each batch
    back as it finishes, stages nothing, and leaves no chunk file."""
    batches = 3
    prefix = tmp_path / "run" / "ck"
    prefix.parent.mkdir()
    with trace_profile(str(tmp_path / "trace")):
        spec_gens["pipeline"].generate(
            n=batches * SPEC_BATCH - 3, batch_size=SPEC_BATCH, seed=8,
            want_spectra=True, resume_path=str(prefix))
    names = _program_names(tmp_path / "trace")
    assert names.count("readback.spectra") == batches
    assert names.count("readback.photometry") == batches
    assert "library.stage" not in names and "readback.part" not in names
    assert list(prefix.parent.iterdir()) == []


class _SlowEvent:
    """A copy's event that finishes `seconds` after it is recorded."""

    def __init__(self, seconds: float):
        self.at = time.monotonic() + seconds

    def query(self) -> bool:
        return time.monotonic() >= self.at

    def synchronize(self) -> None:
        time.sleep(max(0.0, self.at - time.monotonic()))


class _HostRing(tl._PinnedRing):
    """The ring over host memory: CPU tensors take the slots, each copy is
    made at once, and its event reports it finished a random while later."""

    def __init__(self, seed: int):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def takes(v) -> bool:
        return isinstance(v, torch.Tensor)

    def fit(self, key, parts) -> None:
        if key != self.key:
            _, rows, _ = key
            self.slots = {k: torch.empty((tl._RING_SLOTS, rows, v.shape[1]),
                                         dtype=v.dtype)
                          for k, v in parts.items()}
            self.key = key

    def copy(self, slot, rows, parts):
        for k, v in parts.items():
            self.slots[k][slot, :rows].copy_(v)
        return _SlowEvent(float(self.rng.uniform(0.0, 2e-3)))


def _ring_run(seed: int) -> bool:
    """Two runs of ragged n through one host ring: every row in place."""
    ring, bs = _HostRing(seed), 16
    for n in (7 * bs - 5, 4 * bs):
        rng = np.random.default_rng(seed + n)
        phot = torch.as_tensor(rng.normal(size=(n + bs, 8))
                               .astype(np.float32))
        spec = torch.as_tensor(rng.normal(size=(n + bs, 40))
                               .astype(np.float32))
        copy = tl._CopyOut(n, bs, ring)
        for lo in range(0, n, bs):
            copy.stage(lo, {"phot": phot[lo:lo + bs, :7],
                            "spec": spec[lo:lo + bs]})
        got = copy.finish()
        if not (np.array_equal(got["phot"], phot[:n, :7].numpy())
                and np.array_equal(got["spec"], spec[:n].numpy())):
            return False
    ring.lander.shutdown()
    return True


def test_ring_thread_lands_every_slot_under_contention():
    runs = 4 * (os.cpu_count() or 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(runs) as pool:
            results = [f.result(timeout=60)
                       for f in [pool.submit(_ring_run, i)
                                 for i in range(runs)]]
    finally:
        sys.setswitchinterval(old)
    assert results == [True] * runs
