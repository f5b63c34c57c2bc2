"""Port parity, the library slice: `library.py` against the JAX package.

Device sampling (the default for photometry-only LHC runs): the θ draws come
from a torch.Generator and differ from the JAX package's for the same seed,
so the check is by distribution: rows sorted by redshift and the box covered
(as `tests/test_zsorted.py` checks the JAX generator). The batch is 256 rows:
at this 1024-λ test grid a 512-row sub-chunk of a 1500-draw library spans
the whole knot table, where generation takes the dense path
(`test_whole_table_batches_take_dense_path`). Photometry tolerance on fluxes
above 1e-3 of their row maximum: median < 2e-3, p99 < 5e-3 (both sides run
the fused body). A device-sampled run pads to whole sub-chunks, not whole
batches, so its last batch may be short: its θ and photometry equal those
of the same rows padded to whole batches bit for bit (staged body, K1's
plain version, the dense path), `pad_rows` counts the rows run past n, and
a run whose short last chunk runs after a restart, or is read from its
file, resumes to the same bits. The run is planned once: each batch takes
its slice of the run plan's window starts and reads none back, and the
library equals bit for bit the run in which each batch plans its own
starts (1 to 5 batches, ragged and whole n, the one-screen and the
Charlot & Fall models); starts of the wrong length raise.

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
port does not have raises instead of building the base simulator; "auto"
takes the window body by one rule, K1 on the card wherever K1 runs the
model and the staged body elsewhere, where the JAX package times both
bodies once per configuration.
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# -- the pad of device-sampled runs -------------------------------------------
@pytest.fixture(scope="module")
def narrow_gen(port_gen):
    """The module's model over redshifts 0.1-2: a 1024-row sub-chunk of a
    few thousand draws plans a window narrower than the table, so batches
    above the sub-chunk run the window engine."""
    return tt.LibraryGenerator(port_gen.simulator,
                               dict(PRIOR, redshift=(0.1, 2.0)),
                               unlog_keys=["log10_peak_age"], device="cpu")


def _whole_batch_twin(gen, n, batch_size, seed, fused):
    """θ and photometry of a device-sampled run padded to whole batches:
    θ as `_draw_sorted` draws it, padded with its last row, and each batch
    through the chunk function `_generate_device` picks. Returns (θ (n, P),
    photometry (n, F), whether the window engine ran)."""
    sim = gen.simulator
    theta, sub, bs, kc, w_cols, _ = gen._draw_sorted(n, batch_size, seed)
    n_whole = -(-n // bs) * bs
    theta = torch.cat([theta, theta[-1:].expand(n_whole - len(theta), -1)])
    # the pad sub-chunks span no knot: the whole-batch pad plans the same
    assert sim._plan_windows(theta, sub)[2:4] == (kc, w_cols)
    window = kc < sim._n_knots and w_cols < sim._l_sup
    parts = []
    for i in range(0, n_whole, bs):
        t = theta[i:i + bs]
        parts.append(sim.photometry_zsorted_device(
            t, sub_chunk=sub, row_offset=i, kc=kc, w_cols=w_cols,
            fused=fused) if window else sim.photometry(t, row_offset=i))
    return theta[:n].numpy(), torch.cat(parts)[:n].numpy(), window


@pytest.mark.parametrize("body,fused", [("window", False), ("window", True),
                                        ("dense", False)],
                         ids=["staged", "k1", "dense"])
def test_sub_chunk_pad_equals_whole_batch_pad(port_gen, narrow_gen, body,
                                              fused):
    """2500 rows in batches of 2048 run 3072 rows, not 4096: the last batch
    holds one sub-chunk of 1024. θ and photometry equal those of the same
    rows padded to whole batches, bit for bit, on the window engine's
    bodies and on the dense path (the window is the whole table there)."""
    gen = narrow_gen if body == "window" else port_gen
    args = dict(n=2500, batch_size=2048, seed=11)
    before = gen.pad_rows
    lib = gen.generate(zsorted_fused=fused, **args)
    assert gen.pad_rows - before == 3072 - 2500
    theta, phot, window = _whole_batch_twin(gen, fused=fused, **args)
    assert window == (body == "window")
    np.testing.assert_array_equal(lib["parameters"].T, theta)
    np.testing.assert_array_equal(lib["photometry"].T, phot)


@pytest.mark.parametrize("n,batch_size,pad", [
    (2500, 2048, 3072 - 2500),  # to whole 1024-row sub-chunks
    (4096, 2048, 0),  # whole batches: no pad
    (700, 256, 768 - 700),  # the batch is the sub-chunk
    (1, 2048, 1023),
])
def test_pad_rows_counts_rows_past_n(narrow_gen, n, batch_size, pad):
    """A device-sampled call adds ⌈n/sub⌉·sub − n to `pad_rows`, sub =
    min(1024, batch_size); a host-sampled call pads to whole batches."""
    before = narrow_gen.pad_rows
    lib = narrow_gen.generate(n=n, batch_size=batch_size, seed=2)
    assert lib["photometry"].shape[1] == n
    assert narrow_gen.pad_rows - before == pad
    before = narrow_gen.pad_rows
    narrow_gen.generate(n=n, batch_size=batch_size, seed=2,
                        device_sampling=False)
    assert narrow_gen.pad_rows - before == -(-n // batch_size) * batch_size - n


# -- the run's window starts, one slice a batch ------------------------------
@pytest.fixture(scope="module")
def slice_gens():
    """The module's grid and bands over redshifts 0.5-1.5, with one dust
    screen and with Charlot & Fall's two (τ_BC over the 24 cells younger
    than 10^7 yr): a 1024-row sub-chunk of any run plans a window narrower
    than the table."""
    prior = dict(PRIOR, redshift=(0.5, 1.5))
    cf00 = tt.EmissionConfig(reprocessed_types=("total",),
                             dust_law="power_law",
                             dust_params=(("slope", -0.7),),
                             tau_v_bc_param="tau_v_bc")
    one = _pkg_sim(tt, device="cpu")
    two = tt.BatchSEDSimulator(one.grid, one.filters, PNAMES + ("tau_v_bc",),
                               sfh="lognormal", zdist="delta", emission=cf00,
                               device="cpu")
    return {"one-screen": tt.LibraryGenerator(
                one, prior, unlog_keys=["log10_peak_age"], device="cpu"),
            "cf00": tt.LibraryGenerator(
                two, dict(prior, tau_v_bc=(0.0, 2.0)),
                unlog_keys=["log10_peak_age"], device="cpu")}


@pytest.mark.parametrize("model", ["one-screen", "cf00"])
@pytest.mark.parametrize("batches", [1, 2, 3, 5])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "whole"])
def test_batches_take_their_slice_of_the_run_plan(slice_gens, monkeypatch,
                                                  model, batches, ragged):
    """Batches of 2048 rows hold two 1024-row sub-chunks (a ragged n's
    last batch one): each batch is handed its slice of the run plan's
    window starts, and the library equals, bit for bit, that of the run in
    which each batch plans its own starts (the staged body)."""
    gen = slice_gens[model]
    sim = gen.simulator
    args = dict(n=batches * 2048 - (1100 if ragged else 0), batch_size=2048,
                seed=2 ** 31 + batches)
    _, sub, _, kc, w_cols, (k0, l0) = gen._draw_sorted(**args)
    assert kc < sim._n_knots and w_cols < sim._l_sup  # the window engine
    assert len(k0) == len(l0) == -(-args["n"] // sub)
    orig = type(sim).photometry_zsorted_device
    handed = []

    def recorded(self, theta, *a, starts=None, **kw):
        handed.append(starts)
        return orig(self, theta, *a, starts=starts, **kw)

    def own_starts(self, theta, *a, starts=None, **kw):
        return orig(self, theta, *a, **kw)

    monkeypatch.setattr(type(sim), "photometry_zsorted_device", recorded)
    lib = gen.generate(**args)
    assert [len(s[0]) for s in handed] == [2] * (batches - 1) + [
        1 if ragged else 2]
    assert [x for s in handed for x in s[0]] == k0
    assert [x for s in handed for x in s[1]] == l0
    monkeypatch.setattr(type(sim), "photometry_zsorted_device", own_starts)
    twin = gen.generate(**args)
    for key in ("parameters", "photometry"):
        np.testing.assert_array_equal(lib[key], twin[key])


@pytest.mark.parametrize("model", ["one-screen", "cf00"])
@pytest.mark.parametrize("fused", [False, True], ids=["staged", "k1"])
@pytest.mark.parametrize("rows", [3072, 2500])
def test_supplied_starts_equal_planned_starts(slice_gens, model, fused,
                                             rows):
    """`photometry_zsorted_device` with the run plan's starts supplied
    gives the bits of the same call planning its own, on whole and ragged
    rows (padded to 3 sub-chunks), on the staged body and K1's plain
    version."""
    gen = slice_gens[model]
    theta, sub, _, kc, w_cols, starts = gen._draw_sorted(3072, 2048, 4)
    kw = dict(sub_chunk=sub, kc=kc, w_cols=w_cols, fused=fused)
    planned = gen.simulator.photometry_zsorted_device(theta[:rows], **kw)
    given = gen.simulator.photometry_zsorted_device(theta[:rows],
                                                    starts=starts, **kw)
    assert given.shape == (rows, len(_CODES))
    np.testing.assert_array_equal(given.numpy(), planned.numpy())


@pytest.mark.parametrize("change,match", [
    (lambda k0, l0, plan: ((k0[:-1], l0[:-1]), plan), "one entry per"),
    (lambda k0, l0, plan: ((k0 + k0[-1:], l0 + l0[-1:]), plan),
     "one entry per"),
    (lambda k0, l0, plan: ((k0, l0[:-1]), plan), "one entry per"),
    (lambda k0, l0, plan: ((k0, l0), dict(plan, kc=None)), "plan's"),
], ids=["short", "long", "short-l0", "no-plan"])
def test_starts_of_the_wrong_length_raise(slice_gens, change, match):
    """Supplied starts need one (k0, l0) pair per sub-chunk and the plan
    they were made with: anything else raises ValueError."""
    gen = slice_gens["one-screen"]
    theta, sub, _, kc, w_cols, (k0, l0) = gen._draw_sorted(3072, 2048, 4)
    starts, plan = change(k0, l0, dict(kc=kc, w_cols=w_cols))
    with pytest.raises(ValueError, match=match):
        gen.simulator.photometry_zsorted_device(
            theta, sub_chunk=sub, starts=starts, **plan)


def test_empty_library(port_gen):
    lib = port_gen.generate(n=0)
    assert lib["parameters"].shape == (len(PNAMES), 0)
    assert lib["photometry"].shape == (len(_CODES), 0)


@pytest.mark.parametrize("kw,err,match", [
    (dict(pmapped_fn=lambda th: th, device_sampling=True), ValueError,
     "pmapped_fn"),
    (dict(device_sampling=True, want_spectra=True), ValueError,
     "host sampler"),
])
def test_unported_generation_paths_raise(port_gen, kw, err, match):
    """A device sampling the request cannot use raises (the JAX package
    warns and takes the host sampler): spectra, or a `pmapped_fn` (the
    sharded batch functions of `parallel/`, which take the host
    sampler)."""
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
    """embed_grid=True makes a self-contained file; a simulator class that
    is not in `SIMULATOR_REGISTRY` raises instead of building the base
    simulator (the JAX package's fallback)."""
    import h5py

    port, _ = supp_pair
    path = str(tmp_path / "embedded.h5")
    tt.LibraryGenerator(port.simulator, PRIOR, unlog_keys=["log10_peak_age"],
                        embed_grid=True, device="cpu").generate(
        n=32, batch_size=32, out_path=path)
    sim = tt.simulator_from_library(path, device="cpu")
    assert sim.grid.n_wav == port.simulator.grid.n_wav
    with h5py.File(path, "a") as f:
        f["Model"].attrs["simulator_class"] = "NoSuchSimulator"
    with pytest.raises(ValueError, match="not a registered simulator"):
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


@pytest.mark.parametrize("path", ["host", "device", "device-short"])
def test_resume_equals_uninterrupted(path, port_gen, narrow_gen, supp_pair,
                                     tmp_path, monkeypatch):
    """A run interrupted after two batches resumes from its chunk files
    to the same bits as an uninterrupted run; the files go at the end. In
    "device-short" the device run's last batch is one 1024-row sub-chunk
    of a 2048-row batch, and it runs after the restart."""
    gen = {"host": supp_pair[0], "device": port_gen,
           "device-short": narrow_gen}[path]
    args = {"host": dict(n=700, batch_size=128, seed=4),
            "device": dict(n=700, batch_size=256, seed=4),
            "device-short": dict(n=5000, batch_size=2048, seed=4)}[path]
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


def test_short_last_chunk_resumes_from_its_file(narrow_gen, tmp_path,
                                                monkeypatch):
    """A device run's short last chunk (one 1024-row sub-chunk of a
    2048-row batch) is written and taken on a restart as any other: a run
    whose every chunk is on disk launches no batch and returns the bits of
    an uninterrupted run."""
    from synference_tpu_torch import library as tl

    args = dict(n=5000, batch_size=2048, seed=4)
    whole = narrow_gen.generate(**args)
    prefix = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        m.setattr(tl, "_remove_chunks", lambda *a: None)
        narrow_gen.generate(resume_path=prefix, **args)
    assert len(_chunk_files(prefix)) == 3
    with np.load(prefix + ".chunk000002.npz") as ck:
        assert ck["phot"].shape == (1024, len(_CODES))
        assert int(ck["batch_size"]) == 2048
    before = narrow_gen.pad_rows
    resumed = narrow_gen.generate(resume_path=prefix, **args)
    assert narrow_gen.pad_rows == before  # no batch ran
    assert _chunk_files(prefix) == []
    for key in ("parameters", "photometry"):
        np.testing.assert_array_equal(resumed[key], whole[key])


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
def test_default_generate_on_cpu_is_the_staged_body(port_gen):
    """On the CPU a default generate takes the staged body: its library
    equals zsorted_fused=False bit for bit."""
    lib = port_gen.generate(n=1500, batch_size=256, seed=3)
    staged = port_gen.generate(n=1500, batch_size=256, seed=3,
                               zsorted_fused=False)
    np.testing.assert_array_equal(lib["parameters"], staged["parameters"])
    np.testing.assert_array_equal(lib["photometry"], staged["photometry"])


class _CardSimStub:
    """The little of a simulator that `_fused_window_body` reads."""

    def __init__(self, mega: bool, device: str):
        self._mega = mega
        self.device = torch.device(device)

    def _window_mega_supported(self):
        return self._mega


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("mega", [True, False], ids=["k1", "no-k1"])
@pytest.mark.parametrize("requested", ["auto", True, False])
def test_fused_window_body_rule(requested, mega, device):
    """One rule picks the window body: True and False are honoured (True
    where K1 does not run the model raises), and "auto" takes K1 exactly on
    the card where K1 runs the model, whatever the run's length."""
    from synference_tpu_torch.library import _fused_window_body

    sim = _CardSimStub(mega, device)
    if requested is True and not mega:
        with pytest.raises(ValueError, match="zsorted_fused=True"):
            _fused_window_body(sim, requested)
        return
    expected = (device == "cuda" and mega) if requested == "auto" \
        else requested
    assert _fused_window_body(sim, requested) is expected


def test_generator_options_not_ported_raise(port_gen):
    """spectral_pipeline and emission_lines are ported (held to the JAX
    package in tests/test_torch_spectra.py and test_torch_lines.py): they
    are kept, and emission lines take the host sampler."""
    sim = port_gen.simulator
    pipe = tt.SpectralFeaturePipeline(
        sim.grid.lam, tt.generate_constant_r_grid(100, 6000.0, 53000.0),
        device="cpu")
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              spectral_pipeline=pipe, device="cpu")
    assert gen.spectral_pipeline is pipe
    np.testing.assert_array_equal(gen._wavelengths(), pipe.obs_lam.numpy())
    gen = tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                              emission_lines=("Ha",), device="cpu")
    assert gen._supp_names() == ["line_flux_Ha", "line_ew_Ha"]
    with pytest.raises(ValueError, match="device_sampling=True"):
        gen.generate(8, device_sampling=True)
    with pytest.raises(ValueError, match="unknown supplementary"):
        tt.LibraryGenerator(sim, PRIOR, unlog_keys=["log10_peak_age"],
                            supplementary=("nope",), device="cpu")
