"""Port parity, emission lines: `BatchSEDSimulator.line_quantities` against
the JAX package's on the same θ and tables, the tests of
`tests/test_lines.py` on the port, and `LibraryGenerator(emission_lines=...)`
columns in memory and in HDF5, in the JAX package's layout.

Setup as `tests/test_lines.py`: a 24×4×4096 synthetic grid with line
tables, one F200W tophat, a Gaussian-burst SFH, delta Z, the "total"
reprocessed channel; also a Pacman case (fesc as a θ column, birth-cloud
screen).

Tolerances: relative 1e-4 on every quantity (the luminosity is float64
from fp32 contractions; measured ≤ 1.3e-6 with the JAX tables loaded);
`ew_obs = ew_rest (1+z)` to 1e-5 as in the JAX test.
"""

import functools
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt

from test_torch_dense import _jax_state

PARAMS = ("log10_mass", "redshift", "burst_age", "sigma",
          "log10_metallicity", "tau_v")
LINES = ("H 1 6562.80A", "O 3 5006.84A")
PRIOR = {"log10_mass": (8.0, 10.5), "redshift": (0.5, 4.0),
         "burst_age": (3e6, 8e6), "sigma": (5e5, 2e6),
         "log10_metallicity": (-3.5, -1.6), "tau_v": (0.0, 1.0)}
CASES = {
    "total": (dict(reprocessed_types=("total",)), ()),
    "pacman": (dict(incident_type="incident",
                    reprocessed_types=("transmitted", "nebular"),
                    fesc="fesc", tau_v_bc_param="tau_v_bc"),
               ("fesc", "tau_v_bc")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(case="total"):
    em, extra = CASES[case]
    out = []
    for pkg in (jst, tt):
        grid = pkg.make_synthetic_grid(n_ages=24, n_mets=4, n_wav=4096,
                                       line_strength=50.0)
        filt = pkg.FilterSet([pkg.tophat_filter("F200W", 20000.0, 4600.0)])
        kw = dict(device="cpu") if pkg is tt else {}
        out.append(pkg.BatchSEDSimulator(
            grid, filt, PARAMS + extra, sfh="gaussian_burst", zdist="delta",
            emission=pkg.EmissionConfig(**em), photometry_backend="xla",
            **kw))
    out[1].load_state(_jax_state(out[0]))
    return out


def _theta(n=8, seed=0, case="total"):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(8, 10.5, n), rng.uniform(0.5, 4.0, n),
            rng.uniform(3e6, 8e6, n), rng.uniform(5e5, 2e6, n),
            rng.uniform(-3.5, -1.6, n), rng.uniform(0.0, 1.0, n)]
    if case == "pacman":
        cols += [rng.uniform(0, 0.4, n), rng.uniform(0, 1.5, n)]
    return np.stack(cols, axis=1).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_line_quantities_match_jax(case):
    jsim, tsim = _pair(case)
    theta = _theta(16, 1, case)
    port = tsim.line_quantities(theta)
    ref = jsim.line_quantities(jnp.asarray(theta))
    assert port["ids"] == list(ref["ids"])
    for key in ("luminosity", "flux", "ew_rest", "ew_obs"):
        assert port[key].shape == np.asarray(ref[key]).shape
        np.testing.assert_allclose(port[key], np.asarray(ref[key]),
                                   rtol=1e-4, atol=0)
    assert port["luminosity"].dtype == np.float64


def test_shapes_subsets_and_scaling():
    _, sim = _pair()
    theta = _theta(8)
    lq = sim.line_quantities(theta)
    assert lq["flux"].shape == (8, 5)
    for k in ("luminosity", "flux", "ew_rest", "ew_obs"):
        assert np.isfinite(lq[k]).all() and (lq[k] >= 0).all()
    np.testing.assert_allclose(lq["ew_obs"], lq["ew_rest"] * (1 + theta[:, 1:2]),
                               rtol=1e-5)
    sub = sim.line_quantities(theta[:4], line_ids=["H 1 6562.80A"])
    assert sub["flux"].shape == (4, 1) and sub["ids"] == ["H 1 6562.80A"]
    dusty, clear = theta[:4].copy(), theta[:4].copy()
    dusty[:, 5], clear[:, 5] = 2.0, 0.0
    assert (sim.line_quantities(dusty)["flux"]
            < sim.line_quantities(clear)["flux"]).all()


def test_ew_matches_window_integration():
    """Table EWs against continuum-window integration of the realized
    spectrum (independent routes; the JAX test's bound)."""
    grid = tt.make_synthetic_grid(n_ages=24, n_mets=4, n_wav=4096,
                                  line_strength=5.0e5)
    sim = tt.BatchSEDSimulator(
        grid, tt.FilterSet([tt.tophat_filter("F200W", 20000.0, 4600.0)]),
        PARAMS, sfh="gaussian_burst",
        emission=tt.EmissionConfig(reprocessed_types=("total",)),
        photometry_backend="xla", device="cpu")
    theta = _theta(8)
    lq = sim.line_quantities(theta)
    out = sim.simulate(theta, want_spectra=True)
    win = tt.compute_supplementary(["ew_halpha", "ew_hbeta", "ew_oiii"], sim,
                                   theta, out).numpy()
    for j, lid in enumerate(["H 1 6562.80A", "H 1 4861.32A", "O 3 5006.84A"]):
        tab = lq["ew_rest"][:, lq["ids"].index(lid)]
        assert np.median(np.abs(tab - win[:, j])
                         / np.maximum(win[:, j], 1e-10)) < 0.3


def test_no_tables_raises():
    _, sim = _pair()
    grid = tt.make_synthetic_grid(n_ages=8, n_mets=3, n_wav=512)
    grid.lines = None
    bare = tt.BatchSEDSimulator(grid, sim.filters, PARAMS,
                                sfh="gaussian_burst", device="cpu")
    with pytest.raises(ValueError, match="line tables"):
        bare.line_quantities(_theta(2))


def test_library_line_columns_match_jax(tmp_path):
    jsim, tsim = _pair()
    kw = dict(supplementary=("m_uv",), emission_lines=LINES)
    port = tt.LibraryGenerator(tsim, PRIOR, device="cpu", **kw).generate(
        64, batch_size=32, seed=3)
    ref = jst.LibraryGenerator(jsim, PRIOR, **kw).generate(64, batch_size=32,
                                                           seed=3)
    names = ["m_uv"] + [f"line_flux_{i}" for i in LINES] + [
        f"line_ew_{i}" for i in LINES]
    assert port["supplementary_parameter_names"] == names
    assert ref["supplementary_parameter_names"] == names
    np.testing.assert_array_equal(port["parameters"], ref["parameters"])
    cols = port["supplementary_parameters"]
    assert cols.shape == (5, 64) and np.isfinite(cols).all()
    np.testing.assert_allclose(cols[1:], ref["supplementary_parameters"][1:],
                               rtol=1e-4)
    # lines alone (no other supplementary quantity): the z-sorted engine
    # runs and the columns follow the sorted rows
    only = tt.LibraryGenerator(tsim, PRIOR, emission_lines=LINES,
                               device="cpu")
    lib = only.generate(64, batch_size=32, seed=3)
    assert lib["supplementary_parameters"].shape == (4, 64)
    theta = lib["parameters"].T
    direct = tsim.line_quantities(theta, LINES)
    np.testing.assert_allclose(lib["supplementary_parameters"][0],
                               direct["flux"][:, 0], rtol=1e-6)
    empty = only.generate(0)
    assert empty["supplementary_parameters"].shape == (4, 0)
    if importlib.util.find_spec("h5py") is None:
        return
    path = str(tmp_path / "lines.h5")
    tt.LibraryGenerator(tsim, PRIOR, device="cpu", **kw).generate(
        64, batch_size=32, seed=3, out_path=path)
    for loaded in (tt.load_library_hdf5(path),
                   jst.library.load_library_hdf5(path)):
        assert list(loaded["supplementary_parameter_names"]) == names
        np.testing.assert_array_equal(loaded["supplementary_parameters"],
                                      cols)
