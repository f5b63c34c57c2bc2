"""Port parity, the slice as a whole: the port's `LibraryGenerator.generate`
(device sampling, z-sort, one global window plan, the fused body) on the CPU,
held to the JAX package's `photometry_zsorted_device` on the same θ.

The θ draws come from a torch.Generator and differ from the JAX package's
for the same seed, so the check is by distribution: rows sorted by redshift
and the box covered (as `tests/test_zsorted.py` checks the JAX generator).
The batch is 256 rows: at this 1024-λ test grid a 512-row sub-chunk of a
1500-draw library spans the whole knot table, where generation takes the
dense path (`test_whole_table_batches_take_dense_path`). Photometry tolerance on fluxes above 1e-3 of their
row maximum: median < 2e-3, p99 < 5e-3 (both sides run the fused body).
"""

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
    (dict(zsorted_fused="auto"), NotImplementedError, "ROADMAP M5"),
    (dict(out_path="lib.h5"), NotImplementedError, "out_path"),
    (dict(resume_path="ck"), NotImplementedError, "resume_path"),
    (dict(want_spectra=True), NotImplementedError, "want_spectra"),
    (dict(pmapped_fn=lambda th: th), NotImplementedError, "pmapped_fn"),
])
def test_unported_generation_paths_raise(port_gen, kw, err, match):
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
    """The JAX package generates fixed-redshift libraries on its host
    sampler, which is not ported."""
    sim = tt.BatchSEDSimulator(
        tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024),
        tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                      zip(_CODES, _CENTERS, _WIDTHS)]),
        tuple(p for p in PNAMES if p != "redshift"),
        fixed_params={"redshift": 2.0}, device="cpu")
    prior = {k: v for k, v in PRIOR.items() if k != "redshift"}
    gen = tt.LibraryGenerator(sim, prior, unlog_keys=["log10_peak_age"],
                              device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP M5"):
        gen.generate(n=256)


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
        tt.draw_from_hypercube({"tau": (1.0, 1.0)}, 8,
                               torch.Generator().manual_seed(0))
    assert tt.auto_batch_size(1000) == 1024
    assert tt.auto_batch_size(10**7) == 65536
