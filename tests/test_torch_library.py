"""Port parity, the library slice: `library.py` against the JAX package.

Device sampling (the default for photometry-only LHC runs): the θ draws come
from a torch.Generator and differ from the JAX package's for the same seed,
so the check is by distribution: rows sorted by redshift and the box covered
(as `tests/test_zsorted.py` checks the JAX generator). The batch is 256 rows:
at this 1024-λ test grid a 512-row sub-chunk of a 1500-draw library spans
the whole knot table, where generation takes the dense path
(`test_whole_table_batches_take_dense_path`). Photometry tolerance on fluxes
above 1e-3 of their row maximum: median < 2e-3, p99 < 5e-3 (both sides run
the fused body).

The host sampler (`draw_from_hypercube`, every engine and both LHC
branches) gives the JAX package's θ bit for bit, and so do host-sampler
libraries (supplementary, scipy QMC engines, a fixed redshift); their
photometry is held to the JAX package's at 1e-4 of the row maximum (the
dense path's end-to-end bound: both run the exact route on the CPU).
Library files, resume chunks of the host sampler and `grid_content_hash`
are interchangeable between the packages; resume chunks of the device
samplers are not (each package draws other θ), and each package refuses the
other's.

Deliberate differences, each checked here: where the JAX package warns and
falls back (`device_sampling=True` it cannot honour, an unsupported
`zsorted_fused=True`) the port raises; a library of a simulator class the
port does not have raises instead of building the base simulator; the
window-body probe propagates a failing body instead of scoring it as
infinitely slow; "auto" resolves to the staged body on the CPU without a
probe, and on the card takes K1 for runs too short to probe (the JAX
package takes its staged body there, to spare the other body's compile;
K1 is built in advance).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 4.0),
         "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
         "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
_CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
_CENTERS = [9000., 11500., 15000., 20000., 27700., 35600., 44400.]
_WIDTHS = [2000., 2600., 3300., 4600., 7000., 7800., 10200.]


def _close_to_row_max(got, ref, tol=1e-4):
    """(F, N) photometry within `tol` of each row's (object's) maximum."""
    got, ref = np.asarray(got).T, np.asarray(ref).T
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert (np.abs(got - ref) <= tol * np.abs(ref).max(axis=1,
                                                      keepdims=True)).all()


def _pkg_sim(pkg, **kw):
    grid = pkg.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    filt = pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])
    return pkg.BatchSEDSimulator(grid, filt, PNAMES, sfh="lognormal",
                                 zdist="delta",
                                 emission=pkg.EmissionConfig(), **kw)


@pytest.fixture(scope="module")
def port_gen():
    sim = _pkg_sim(tt, device="cpu")
    return tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                               device="cpu")


@pytest.fixture(scope="module")
def library(port_gen):
    return port_gen.generate(n=1500, batch_size=256, seed=3,
                             zsorted_fused=True)


def test_generate_sorted_and_covers_box(library):
    th = library["parameters"].T
    assert th.shape == (1500, len(PNAMES)) and th.dtype == np.float32
    assert library["photometry"].shape == (len(_CODES), 1500)
    assert library["parameter_names"] == list(PNAMES)
    assert library["filter_codes"] == _CODES
    assert np.all(np.diff(th[:, PNAMES.index("redshift")]) >= 0)
    assert th[:, 0].min() < 7.7 and th[:, 0].max() > 10.8
    for j, name in enumerate(PNAMES):
        lo, hi = PRIOR.get(name, PRIOR.get(f"log10_{name}"))
        v = np.log10(th[:, j]) if name == "peak_age" else th[:, j]
        assert lo <= v.min() and v.max() <= hi, name
        # stratified LHC: every tenth of the range holds ~150 draws
        counts = np.histogram(v, bins=10, range=(lo, hi))[0]
        assert counts.min() >= 140, (name, counts)


def test_generate_matches_jax_window_engine(port_gen, library):
    th = library["parameters"].T.copy()
    sim = port_gen.simulator
    theta_pad, sub, kc, w_cols, _, _ = sim._plan_windows(th, 256)
    jsim = _pkg_sim(jst, photometry_backend="pallas",
                    photometry_variant="interp")
    ref = np.asarray(jsim.photometry_zsorted_device(
        jnp.asarray(th), sub_chunk=sub, kc=kc, w_cols=w_cols, fused=True))
    port = library["photometry"].T
    assert np.isfinite(port).all() and (port >= 0).all()
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-30)
    rel = rel[ref > 1e-3 * ref.max(axis=1, keepdims=True)]
    assert np.median(rel) < 2e-3, np.median(rel)
    assert np.quantile(rel, 0.99) < 5e-3, np.quantile(rel, 0.99)


def test_seeded_and_body_independent(port_gen, library):
    again = port_gen.generate(n=1500, batch_size=256, seed=3,
                              zsorted_fused=False)
    np.testing.assert_array_equal(again["parameters"], library["parameters"])
    rel = (np.abs(again["photometry"] - library["photometry"])
           / np.maximum(np.abs(library["photometry"]), 1e-30))
    assert np.quantile(rel, 0.99) < 5e-3
    other = port_gen.generate(n=1500, batch_size=256, seed=4)
    assert not np.array_equal(other["parameters"], library["parameters"])


def test_empty_library(port_gen):
    lib = port_gen.generate(n=0)
    assert lib["parameters"].shape == (len(PNAMES), 0)
    assert lib["photometry"].shape == (len(_CODES), 0)


@pytest.mark.parametrize("kw,err,match", [
    (dict(pmapped_fn=lambda th: th), NotImplementedError, "ROADMAP M14"),
    (dict(device_sampling=True, want_spectra=True), ValueError,
     "host sampler"),
])
def test_unported_generation_paths_raise(port_gen, kw, err, match):
    """Mesh-sharded batches are not ported; a device sampling the request
    cannot use raises (the JAX package warns and takes the host sampler)."""
    args = dict(n=1500, batch_size=256, seed=0)
    args.update(kw)
    with pytest.raises(err, match=match):
        port_gen.generate(**args)


def test_whole_table_batches_take_dense_path(port_gen):
    """A 512-row sub-chunk's window is the whole table here, so every batch
    takes the dense `photometry()`: on the CPU the exact route, held to the
    JAX package's exact route on the same θ."""
    lib = port_gen.generate(n=1500, batch_size=512, seed=3)
    th = lib["parameters"].T.copy()
    _, _, kc, w_cols, k0, _ = port_gen.simulator._plan_windows(th, 512)
    assert k0 is None
    jsim = _pkg_sim(jst, photometry_backend="xla")
    ref = np.asarray(jsim.photometry(jnp.asarray(th)))
    port = lib["photometry"].T
    assert np.isfinite(port).all() and (port >= 0).all()
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-30)
    rel = rel[ref > 1e-3 * ref.max(axis=1, keepdims=True)]
    assert np.median(rel) < 2e-3, np.median(rel)
    assert np.quantile(rel, 0.99) < 5e-3, np.quantile(rel, 0.99)


def test_fixed_redshift_generation_raises():
    """Generation with a fixed redshift runs on the host sampler, θ equal to
    the JAX package's bit for bit and photometry within 1e-4 of the row
    maximum; asking for the device sampler there raises (the JAX package
    warns and takes the host sampler)."""
    def make(pkg, **kw):
        return pkg.BatchSEDSimulator(
            pkg.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024),
            pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                           zip(_CODES, _CENTERS, _WIDTHS)]),
            tuple(p for p in PNAMES if p != "redshift"),
            fixed_params={"redshift": 2.0}, **kw)

    prior = {k: v for k, v in PRIOR.items() if k != "redshift"}
    gen = tt.LibraryGenerator(make(tt, device="cpu"), prior,
                              unlog_keys=["log10_peak_age"], device="cpu")
    with pytest.raises(ValueError, match="host sampler"):
        gen.generate(n=256, device_sampling=True)
    lib = gen.generate(n=300, batch_size=128, seed=5)
    ref = jst.LibraryGenerator(make(jst, photometry_backend="xla"), prior,
                               unlog_keys=["log10_peak_age"]).generate(
        n=300, batch_size=128, seed=5)
    np.testing.assert_array_equal(lib["parameters"], ref["parameters"])
    _close_to_row_max(lib["photometry"], ref["photometry"])


def test_fused_true_on_unsupported_model_raises():
    sim = _pkg_sim(tt, device="cpu", photometry_interp_order=2)
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              device="cpu")
    with pytest.raises(ValueError, match="fused window body"):
        gen.generate(n=256, batch_size=256, zsorted_fused=True)


def test_generator_checks():
    sim = _pkg_sim(tt, device="cpu")
    with pytest.raises(ValueError, match="not covered"):
        tt.LibraryGenerator(sim, {"redshift": (0.1, 2.0)}, device="cpu")
    with pytest.raises(ValueError, match="differs"):
        tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                            device="meta")
    with pytest.raises(ValueError, match="lo < hi"):
        tt.draw_from_hypercube({"tau": (1.0, 1.0)}, 8, rng=0)
    with pytest.raises(ValueError, match="lo < hi"):
        tt.draw_from_hypercube_device({"tau": (1.0, 1.0)}, 8,
                                      torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="sobol/halton"):
        tt.draw_from_hypercube_device({"tau": (0.0, 1.0)}, 8,
                                      torch.Generator(), engine="sobol")
    assert tt.auto_batch_size(1000) == 1024
    assert tt.auto_batch_size(10**7) == 65536


# -- host sampler ------------------------------------------------------------
@pytest.mark.parametrize("engine,n", [("lhc", 300), ("lhc", 100_000),
                                      ("sobol", 256), ("halton", 200),
                                      ("random", 300)])
def test_host_sampler_matches_jax_bitwise(engine, n):
    """Every engine, both LHC branches (scipy below 10⁵ rows, the
    stratified permutation from 10⁵): the same float32 bits."""
    from synference_tpu.library import draw_from_hypercube as jdraw

    got = tt.draw_from_hypercube(PRIOR, n, rng=7, engine=engine,
                                 unlog_keys=["log10_peak_age"])
    ref = jdraw(PRIOR, n, rng=7, engine=engine,
                unlog_keys=["log10_peak_age"])
    assert list(got) == list(ref)
    for key in ref:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], ref[key])


@pytest.fixture(scope="module")
def supp_pair():
    """Host-sampler generators over the same model in both packages."""
    supp = ("m_uv", "sfr_100", "mass_weighted_age", "t50")
    port = tt.LibraryGenerator(_pkg_sim(tt, device="cpu"), PRIOR,
                               unlog_keys=["log10_peak_age"],
                               supplementary=supp, device="cpu")
    ref = jst.LibraryGenerator(_pkg_sim(jst, photometry_backend="xla"),
                               PRIOR, unlog_keys=["log10_peak_age"],
                               supplementary=supp)
    return port, ref


def test_supplementary_generation_matches_jax(supp_pair, tmp_path):
    """θ bit for bit, photometry at 1e-4 of the row maximum, supplementary
    columns finite and, medians, at 1e-4 relative (the end-to-end bound of
    `tests/test_torch_supplementary.py`); the file loads in the JAX
    package."""
    from synference_tpu.library import load_library_hdf5 as jload

    port, ref_gen = supp_pair
    path = str(tmp_path / "port.h5")
    lib = port.generate(n=300, batch_size=128, seed=1, out_path=path)
    ref = ref_gen.generate(n=300, batch_size=128, seed=1)
    np.testing.assert_array_equal(lib["parameters"], ref["parameters"])
    _close_to_row_max(lib["photometry"], ref["photometry"])
    s, r = lib["supplementary_parameters"], ref["supplementary_parameters"]
    assert s.shape == (4, 300) and np.isfinite(s).all()
    rel = np.abs(s - r) / np.maximum(np.abs(r), 1e-30)
    assert (np.median(rel, axis=1) < 1e-4).all(), np.median(rel, axis=1)
    back = jload(path)
    np.testing.assert_array_equal(back["supplementary_parameters"], s)
    assert back["supplementary_parameter_names"] == list(port.supplementary)
    assert back["filter_codes"] == _CODES


def test_want_spectra_generation_matches_jax(supp_pair):
    port, ref_gen = supp_pair
    gen = tt.LibraryGenerator(port.simulator, PRIOR,
                              unlog_keys=["log10_peak_age"], device="cpu")
    jgen = jst.LibraryGenerator(ref_gen.simulator, PRIOR,
                                unlog_keys=["log10_peak_age"])
    lib = gen.generate(n=200, batch_size=128, seed=2, want_spectra=True)
    ref = jgen.generate(n=200, batch_size=128, seed=2, want_spectra=True)
    np.testing.assert_array_equal(lib["parameters"], ref["parameters"])
    np.testing.assert_array_equal(lib["wavelengths"], ref["wavelengths"])
    assert lib["spectra"].shape == (1024, 200)
    _close_to_row_max(lib["spectra"], ref["spectra"])
    _close_to_row_max(lib["photometry"], ref["photometry"])


# -- HDF5 --------------------------------------------------------------------
def _arrays(n=40):
    rng = np.random.default_rng(0)
    return dict(
        parameters=rng.uniform(0, 1, (3, n)).astype(np.float32),
        parameter_names=["a", "b", "c"],
        filter_codes=["JWST/NIRCam.F200W", "JWST/NIRCam.F444W"],
        photometry=rng.uniform(0, 10, (2, n)).astype(np.float32),
        spectra=rng.uniform(0, 1, (5, n)).astype(np.float32),
        supplementary_parameters=rng.uniform(0, 1, (2, n)).astype(np.float32),
        supplementary_parameter_names=["m_uv", "t50"],
        parameter_units=["", "Msun", "yr"],
        extra_datasets={"Wavelengths": np.linspace(1e3, 2e3, 5)})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_written_by_either_loads_in_the_other(writer, tmp_path):
    from synference_tpu import library as jl

    save = (tt.save_library_hdf5 if writer == "port"
            else jl.save_library_hdf5)
    load = jl.load_library_hdf5 if writer == "port" else tt.load_library_hdf5
    arrays = _arrays()
    path = str(tmp_path / "lib.h5")
    save(path, **arrays)
    back = load(path)
    ref = (tt.load_library_hdf5 if writer == "port"
           else jl.load_library_hdf5)(path)
    assert sorted(back) == sorted(ref)
    for key, val in ref.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(back[key], val)
        else:
            assert back[key] == val, key
    np.testing.assert_array_equal(back["photometry"], arrays["photometry"])
    assert back["wavelengths"].shape == (5,)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_filter_code_fallback_and_empty(writer, tmp_path):
    """Filter codes over the 64 KB attribute-header limit (6000
    variable-length strings) go to a dataset with a pointer attribute; an n = 0 library keeps the schema."""
    from synference_tpu import library as jl

    save = (tt.save_library_hdf5 if writer == "port"
            else jl.save_library_hdf5)
    load = jl.load_library_hdf5 if writer == "port" else tt.load_library_hdf5
    codes = [f"Survey/Instrument.F{i:05d}" for i in range(6000)]
    path = str(tmp_path / "wide.h5")
    save(path, parameters=np.zeros((1, 3), np.float32),
         parameter_names=["a"], filter_codes=codes,
         photometry=np.ones((len(codes), 3), np.float32))
    import h5py

    with h5py.File(path) as f:
        assert "FilterCodes" in f["Grid"]
    assert load(path)["filter_codes"] == codes
    empty = str(tmp_path / "empty.h5")
    save(empty, parameters=np.zeros((2, 0), np.float32),
         parameter_names=["a", "b"], filter_codes=["F1"],
         photometry=np.zeros((1, 0), np.float32))
    lib = load(empty)
    assert lib["parameters"].shape == (2, 0)
    assert lib["photometry"].shape == (1, 0)


def test_empty_generation_writes_the_schema(supp_pair, tmp_path):
    from synference_tpu.library import load_library_hdf5 as jload

    port, ref_gen = supp_pair
    path = str(tmp_path / "zero.h5")
    lib = port.generate(n=0, out_path=path)
    ref = ref_gen.generate(n=0)
    assert sorted(lib) == sorted(ref)
    for key in lib:
        if isinstance(lib[key], np.ndarray):
            assert lib[key].shape == np.asarray(ref[key]).shape, key
    assert jload(path)["supplementary_parameters"].shape == (4, 0)


def test_library_creator_roundtrip(tmp_path):
    arrays = _arrays()
    path = str(tmp_path / "byo.h5")
    tt.LibraryCreator(arrays["parameters"].T, arrays["parameter_names"],
                      photometry=arrays["photometry"].T,
                      filter_codes=arrays["filter_codes"]).save(path)
    back = tt.load_library_hdf5(path)
    np.testing.assert_array_equal(back["parameters"], arrays["parameters"])
    np.testing.assert_array_equal(back["photometry"], arrays["photometry"])


def test_grid_content_hash_matches_jax():
    from synference_tpu.library import grid_content_hash as jhash

    from synference_tpu_torch.library import grid_content_hash

    for kw in (dict(n_ages=16, n_mets=4, n_wav=1024),
               dict(n_ages=32, n_mets=5, n_wav=512, seed=0)):
        got = grid_content_hash(tt.make_synthetic_grid(**kw))
        assert got == jhash(jst.make_synthetic_grid(**kw))
        assert len(got) == 64
    multi = dict(n_u=2, n_ages=8, n_mets=3, n_wav=256)
    assert grid_content_hash(tt.make_synthetic_multiaxis_grid(**multi)) == \
        jhash(jst.make_synthetic_multiaxis_grid(**multi))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_simulator_from_library_both_ways(writer, supp_pair, tmp_path):
    """A library's Model group rebuilds the simulator in the other package:
    photometry on the same θ within 1e-4 of the row maximum (both exact
    routes); a grid whose content hash differs is refused."""
    from synference_tpu import library as jl

    port, ref_gen = supp_pair
    path = str(tmp_path / "lib.h5")
    gen = port if writer == "port" else ref_gen
    gen.generate(n=64, batch_size=64, seed=3, out_path=path)
    grid_t, grid_j = port.simulator.grid, ref_gen.simulator.grid
    sim = tt.simulator_from_library(path, grid=grid_t, device="cpu")
    jsim = jl.simulator_from_library(path, grid=grid_j,
                                     photometry_backend="xla")
    assert sim.param_names == jsim.param_names == PNAMES
    assert sim.filters.codes == _CODES
    assert sim.emission == port.simulator.emission
    theta = tt.load_library_hdf5(path)["parameters"].T.copy()
    _close_to_row_max(sim.photometry(theta).numpy().T,
                      np.asarray(jsim.photometry(theta)).T)
    other = tt.make_synthetic_grid(n_ages=15, n_mets=4, n_wav=1024)
    with pytest.raises(ValueError, match="content hash"):
        tt.simulator_from_library(path, grid=other, device="cpu")
    with pytest.raises(ValueError, match="grid reference"):
        tt.simulator_from_library(path, device="cpu")


def test_embedded_grid_and_unknown_simulator_class(supp_pair, tmp_path):
    """embed_grid=True makes a self-contained file; a simulator class the
    port does not have raises instead of building the base simulator."""
    import h5py

    port, _ = supp_pair
    path = str(tmp_path / "embedded.h5")
    tt.LibraryGenerator(port.simulator, PRIOR, unlog_keys=["log10_peak_age"],
                        embed_grid=True, device="cpu").generate(
        n=32, batch_size=32, out_path=path)
    sim = tt.simulator_from_library(path, device="cpu")
    assert sim.grid.n_wav == port.simulator.grid.n_wav
    with h5py.File(path, "a") as f:
        f["Model"].attrs["simulator_class"] = "AGNSimulator"
    with pytest.raises(NotImplementedError, match="M14 item 3"):
        tt.simulator_from_library(path, device="cpu")


# -- resume --------------------------------------------------------------------
class _Stop(Exception):
    pass


def _interrupt_after(monkeypatch, n_saves: int):
    """Make the n_saves+1-th `np.savez` (a chunk file) raise `_Stop`."""
    real, calls = np.savez, []

    def savez(*args, **kw):
        if len(calls) == n_saves:
            raise _Stop
        calls.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(np, "savez", savez)
    return calls


def _chunk_files(prefix):
    return sorted(p for p in os.listdir(os.path.dirname(prefix))
                  if p.startswith(os.path.basename(prefix)))


@pytest.mark.parametrize("path", ["host", "device"])
def test_resume_equals_uninterrupted(path, port_gen, supp_pair, tmp_path,
                                     monkeypatch):
    """A run interrupted after two batches resumes from its chunk files
    to the same bits as an uninterrupted run; the files go at the end."""
    gen = supp_pair[0] if path == "host" else port_gen
    args = dict(n=700, batch_size=128 if path == "host" else 256, seed=4)
    whole = gen.generate(**args)
    prefix = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _interrupt_after(m, 2)
        with pytest.raises(_Stop):
            gen.generate(resume_path=prefix, **args)
    assert _chunk_files(prefix) == ["ck.chunk000000.npz", "ck.chunk000001.npz"]
    with np.load(prefix + ".chunk000000.npz") as ck:
        assert str(ck["sampler"]) == ("host" if path == "host"
                                      else "torch-device")
    resumed = gen.generate(resume_path=prefix, **args)
    assert _chunk_files(prefix) == []
    for key, val in whole.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(resumed[key], val)


def test_jax_host_chunks_resume_in_port(supp_pair, tmp_path, monkeypatch):
    """Host-sampler θ is the same in both packages, so chunks the JAX
    package wrote are taken: their rows keep the JAX bits, the rest is the
    port's own."""
    port, ref_gen = supp_pair
    args = dict(n=400, batch_size=128, seed=6)
    prefix = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _interrupt_after(m, 2)
        with pytest.raises(_Stop):
            ref_gen.generate(resume_path=prefix, **args)
    with np.load(prefix + ".chunk000001.npz") as ck:
        jax_rows = ck["phot"]
    lib = port.generate(resume_path=prefix, **args)
    whole = port.generate(**args)
    np.testing.assert_array_equal(lib["parameters"], whole["parameters"])
    np.testing.assert_array_equal(lib["photometry"][:, 128:256], jax_rows.T)
    np.testing.assert_array_equal(lib["photometry"][:, 256:],
                                  whole["photometry"][:, 256:])
    assert not np.array_equal(jax_rows.T, whole["photometry"][:, 128:256])
    _close_to_row_max(lib["photometry"], whole["photometry"])
    assert _chunk_files(prefix) == []


def test_device_chunks_refused_across_packages(port_gen, tmp_path,
                                               monkeypatch):
    """Each package's device sampler draws other θ, so neither takes the
    other's device chunks: the JAX package tags its own "device", the port
    "torch-device"."""
    args = dict(n=1024, batch_size=256, seed=8)
    prefix = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _interrupt_after(m, 2)
        with pytest.raises(_Stop):
            port_gen.generate(resume_path=prefix, **args)
    jgen = jst.LibraryGenerator(
        _pkg_sim(jst, photometry_backend="pallas",
                 photometry_variant="interp"), PRIOR,
        unlog_keys=["log10_peak_age"])
    jlib = jgen.generate(resume_path=prefix, zsorted_fused=False, **args)
    jfresh = jgen.generate(zsorted_fused=False, **args)
    np.testing.assert_array_equal(jlib["parameters"], jfresh["parameters"])
    np.testing.assert_array_equal(jlib["photometry"], jfresh["photometry"])
    assert _chunk_files(prefix) == []
    with monkeypatch.context() as m:
        _interrupt_after(m, 2)
        with pytest.raises(_Stop):
            jgen.generate(resume_path=prefix, zsorted_fused=False, **args)
    with np.load(prefix + ".chunk000000.npz") as ck:
        assert str(ck["sampler"]) == "device"
    lib = port_gen.generate(resume_path=prefix, **args)
    fresh = port_gen.generate(**args)
    np.testing.assert_array_equal(lib["parameters"], fresh["parameters"])
    np.testing.assert_array_equal(lib["photometry"], fresh["photometry"])


# -- the window-body choice -----------------------------------------------------
def test_auto_takes_staged_body_on_cpu_without_probe(port_gen, library,
                                                     monkeypatch):
    from synference_tpu_torch import library as tl

    def no_probe(*a, **k):
        raise AssertionError("probed on the CPU")

    monkeypatch.setattr(tl, "_probe_bodies", no_probe)
    lib = port_gen.generate(n=1500, batch_size=256, seed=3)
    assert port_gen.last_probe == {"source": "cpu", "fused": False}
    staged = port_gen.generate(n=1500, batch_size=256, seed=3,
                               zsorted_fused=False)
    np.testing.assert_array_equal(lib["photometry"], staged["photometry"])


_DIGEST = """
import json, sys
import synference_tpu_torch as tt
from synference_tpu_torch.library import zsorted_probe_digest
sim = tt.BatchSEDSimulator(
    tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024),
    tt.FilterSet([tt.tophat_filter("F200W", 20000.0, 4600.0)]),
    ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
     "tau_v"), device="cpu")
print(json.dumps([zsorted_probe_digest(sim, (1024, 12, 768), 65536, name)
                  for name in ("NVIDIA H100 80GB HBM3", "other card")]))
"""


def test_probe_digest_equal_across_processes():
    """The persisted choice's key is a sha256 digest, equal in two
    processes (Python's salted `hash()` would differ), and depends on the
    card."""
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = [json.loads(subprocess.run(
        [sys.executable, "-c", _DIGEST], cwd=root, capture_output=True,
        text=True, timeout=300, check=True).stdout) for _ in range(2)]
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1] and len(runs[0][0]) == 64


def test_probe_digest_names_the_window_body_code(port_gen, monkeypatch):
    """A rewrite of either window body (K1's sources, the staged body's
    module) voids a persisted choice: the code's digest is in the key."""
    from synference_tpu_torch import library as tl

    sim = port_gen.simulator
    key = (sim, (1024, 12, 768), 65536, "NVIDIA H100 80GB HBM3")
    before = tl.zsorted_probe_digest(*key)
    assert len(tl._window_body_code_digest()) == 64
    monkeypatch.setattr(tl, "_window_body_code_digest", lambda: "0" * 64)
    assert tl.zsorted_probe_digest(*key) != before


class _CardSimStub:
    """The little of a card simulator that `_choose_zsorted_fused` reads."""

    device = torch.device("cuda")

    def __init__(self, mega: bool):
        self._mega = mega

    def _window_mega_supported(self):
        return self._mega


@pytest.mark.parametrize("n_batches, mega, expected", [
    (1, True, {"source": "short run", "fused": True}),
    (3, True, {"source": "short run", "fused": True}),
    (2, False, {"source": "unsupported", "fused": False}),
])
def test_auto_rule_on_the_card_without_probe(port_gen, monkeypatch,
                                             n_batches, mega, expected):
    """On the card "auto" takes K1 for runs of fewer than 4 batches,
    without timing either body, where K1 runs the model, and the staged
    body where it does not; the staged body is never taken by default on a
    model K1 supports."""
    from synference_tpu_torch import library as tl

    def no_probe(*a, **k):
        raise AssertionError("probed a short run")

    monkeypatch.setattr(tl, "_probe_bodies", no_probe)
    monkeypatch.setattr(port_gen, "simulator", _CardSimStub(mega))
    fused = port_gen._choose_zsorted_fused("auto", 1024, 12, 768,
                                           torch.zeros(4096, 6), n_batches)
    assert fused is expected["fused"]
    assert port_gen.last_probe == expected


def test_auto_probes_long_runs_on_the_card(port_gen, monkeypatch, tmp_path):
    """From 4 batches on, "auto" on the card probes once, stores the choice
    on the simulator and in the probe file under its digest, and reads it
    back from either (the timing itself is the card tests')."""
    from synference_tpu_torch import library as tl

    calls = []

    def probe(sim, theta, sub, kc, w_cols):
        calls.append((sub, kc, w_cols))
        return {"staged_ms": 2.0, "fused_ms": 1.0, "fused": True}

    monkeypatch.setattr(tl, "_probe_bodies", probe)
    monkeypatch.setattr(tl, "ZSORTED_PROBE_FILE", tmp_path / "probe.json")
    monkeypatch.setattr(tl, "zsorted_probe_digest",
                        lambda sim, plan, batch, name: "d" * 64)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "card")
    stub = _CardSimStub(True)
    monkeypatch.setattr(port_gen, "simulator", stub)
    theta = torch.zeros(4096, 6)
    assert port_gen._choose_zsorted_fused("auto", 1024, 12, 768, theta, 4)
    assert port_gen.last_probe["source"] == "probe" and calls
    assert port_gen._choose_zsorted_fused("auto", 1024, 12, 768, theta, 4)
    assert port_gen.last_probe["source"] == "simulator" and len(calls) == 1
    monkeypatch.setattr(port_gen, "simulator", _CardSimStub(True))
    assert port_gen._choose_zsorted_fused("auto", 1024, 12, 768, theta, 9)
    assert port_gen.last_probe == {"staged_ms": 2.0, "fused_ms": 1.0,
                                   "fused": True, "digest": "d" * 64,
                                   "source": "file"}
    assert len(calls) == 1


def test_probe_propagates_a_failing_body(port_gen, monkeypatch):
    """A window body that fails in the probe raises out of it; it is not
    scored as infinitely slow (the JAX package catches every exception
    there)."""
    from synference_tpu_torch import library as tl

    sim = port_gen.simulator
    theta, sub, bs, kc, w_cols = port_gen._draw_sorted(1024, 256, seed=0)
    monkeypatch.setattr(tl, "_probe_ms", lambda fn: (fn(), 1.0)[1])
    record = tl._probe_bodies(sim, theta[:bs], sub, kc, w_cols)
    assert record == {"staged_ms": 1.0, "fused_ms": 1.0, "fused": False}

    def broken(theta, fused=False, **kw):
        if fused:
            raise RuntimeError("K1 failed to launch")
        return theta

    monkeypatch.setattr(sim, "photometry_zsorted_device", broken)
    with pytest.raises(RuntimeError, match="K1 failed"):
        tl._probe_bodies(sim, theta[:bs], sub, kc, w_cols)


def test_generator_options_not_ported_raise(port_gen):
    sim = port_gen.simulator
    with pytest.raises(NotImplementedError, match="M10"):
        tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                            spectral_pipeline=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="M9"):
        tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                            emission_lines=("Ha",), device="cpu")
    with pytest.raises(ValueError, match="unknown supplementary"):
        tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                            supplementary=("nope",), device="cpu")
