"""Port parity, the z-sorted window engine: the port's
`photometry_zsorted_device` (staged and fused bodies) against the JAX
package's on the same sorted θ, with the port loaded with the JAX
simulator's tables (`load_state`) so both compute on identical inputs.

Setup as `tests/test_zsorted.py`: a 16×4×1024 grid, 7 tophats, 1536 sorted
θ, 128-row sub-chunks, the JAX simulator on the Pallas interp engine (its
fused body in interpret mode on the CPU).

Tolerance on fluxes above 1e-3 of their row maximum: staged vs staged
median < 1e-4, p99 < 2e-3 (same arithmetic, float32 summation order, rare
bf16 rounding flips); fused vs fused median < 2e-3, p99 < 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
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


def _sorted_theta(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(7.5, 11, n), np.sort(rng.uniform(0.05, 8, n)),
        rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
        rng.uniform(-3.9, -1.6, n), rng.uniform(0, 2, n),
    ]).astype(np.float32)


# the tables the window engine reads
_WINDOW_KEYS = ("t_mix", "m_igm", "den_knots", "dust_curve_sup", "wlam_sup",
                "age_table", "d19_table")


def _jax_state(jsim):
    t_mix, m_igm, den_knots = jsim._zsorted_tables()
    return {
        "t_mix": np.asarray(t_mix), "m_igm": np.asarray(m_igm),
        "den_knots": np.asarray(den_knots),
        "dust_curve_sup": np.asarray(jsim._dust_curve_sup),
        "wlam_sup": np.asarray(jsim._wlam_sup),
        "age_table": np.asarray(jsim._age_table),
        "d19_table": np.asarray(jsim._d19_table),
    }


@pytest.fixture(scope="module")
def sims():
    jgrid = jst.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    jfilt = jst.FilterSet([jst.tophat_filter(c, ct, w) for c, ct, w in
                           zip(_CODES, _CENTERS, _WIDTHS)])
    jsim = jst.BatchSEDSimulator(
        jgrid, jfilt, PNAMES, sfh="lognormal", zdist="delta",
        emission=jst.EmissionConfig(),
        photometry_backend="pallas", photometry_variant="interp")
    tgrid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    tfilt = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])
    tsim = tt.BatchSEDSimulator(tgrid, tfilt, PNAMES, sfh="lognormal",
                                zdist="delta", emission=tt.EmissionConfig(),
                                device="cpu")
    own = {k: getattr(tsim, f"_{k}").numpy().copy() for k in _WINDOW_KEYS}
    tsim.load_state(_jax_state(jsim))
    return jsim, tsim, own


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-30)
    return rel[ref > 1e-3 * ref.max(axis=1, keepdims=True)]


def test_own_tables_match_jax(sims):
    """The port's own tables (before load_state) agree with the JAX
    simulator's: identical host-numpy den knots and weights, float32
    rounding elsewhere (the IGM and knot tables go through pow/exp chains)."""
    jsim, _, own = sims
    ref = _jax_state(jsim)
    for key in ("den_knots", "wlam_sup", "t_mix"):
        np.testing.assert_array_equal(own[key], ref[key], err_msg=key)
    for key in ("m_igm", "dust_curve_sup", "age_table", "d19_table"):
        np.testing.assert_allclose(own[key], ref[key], rtol=1e-5, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
def test_parity_vs_jax_device_engine(sims, fused):
    jsim, tsim, _ = sims
    theta = _sorted_theta(1536, seed=6)
    z = theta[:, PNAMES.index("redshift")]
    # the window must engage, or the comparison would be vacuous (the
    # port's planner raises when the window is the whole table)
    _, _, kc, w_cols, _, _ = tsim._plan_windows(theta, 128)
    assert kc < tsim._n_knots and w_cols < tsim._l_sup
    assert jsim._zsorted_window_plan(z, 128) is not None
    port = tsim.photometry_zsorted_device(theta, sub_chunk=128, fused=fused)
    ref = jsim.photometry_zsorted_device(jnp.asarray(theta), sub_chunk=128,
                                         fused=fused)
    rel = _rel(port, ref)
    median, p99 = (2e-3, 5e-3) if fused else (1e-4, 2e-3)
    assert np.median(rel) < median, np.median(rel)
    assert np.quantile(rel, 0.99) < p99, np.quantile(rel, 0.99)


def test_fused_parity_vs_jax_with_ragged_sub_chunks(sims):
    """The fused body, one grouped K1 call per batch, with sub-chunks of 96
    rows (not a multiple of the kernels' 128-row tile) and a padded last
    one, against the JAX package's fused body at the same tolerance."""
    jsim, tsim, _ = sims
    theta = _sorted_theta(1000, seed=10)
    _, _, kc, w_cols, _, _ = tsim._plan_windows(theta, 96)
    assert kc < tsim._n_knots and w_cols < tsim._l_sup
    port = tsim.photometry_zsorted_device(theta, sub_chunk=96, fused=True)
    ref = jsim.photometry_zsorted_device(jnp.asarray(theta), sub_chunk=96,
                                         fused=True)
    rel = _rel(port, ref)
    assert np.median(rel) < 2e-3, np.median(rel)
    assert np.quantile(rel, 0.99) < 5e-3, np.quantile(rel, 0.99)


def test_window_starts_match_host_plan(sims):
    """The port's device plan (kc, w_cols, k0 and l0 per sub-chunk) equals
    the JAX package's host plan (float64 knot intervals)."""
    jsim, tsim, _ = sims
    theta = _sorted_theta(1536, seed=7)
    _, sub, kc, w_cols, k0, l0 = tsim._plan_windows(theta, 128)
    kc_h, w_h, k0_h, l0_h = jsim._zsorted_window_plan(theta[:, 1], sub)
    assert (kc, w_cols) == (kc_h, w_h)
    np.testing.assert_array_equal(k0, k0_h)
    np.testing.assert_array_equal(l0, l0_h)


def test_padding_non_multiple_batch(sims):
    _, tsim, _ = sims
    theta = _sorted_theta(1500, seed=8)
    out = tsim.photometry_zsorted_device(theta, sub_chunk=128)
    assert out.shape == (1500, len(_CODES))
    head = tsim.photometry_zsorted_device(theta[:1280], sub_chunk=128)
    np.testing.assert_allclose(out[:1280].numpy(), head.numpy(), rtol=1e-6)


def test_host_form_parity_vs_fused(sims):
    """`photometry_zsorted` (the host-call form, planned on the device) as
    `tests/test_zsorted.py::test_parity_vs_fused`: against the dense fused
    interp photometry (the JAX simulator's, the port's being the exact
    route on the CPU) at that test's bound (p99 < 2e-3) and against the JAX
    package's host form at the staged-vs-staged bound, with padding."""
    jsim, tsim, _ = sims
    for n, seed in ((1536, 0), (1228, 3)):
        theta = _sorted_theta(n, seed=seed)
        port = tsim.photometry_zsorted(theta, sub_chunk=128)
        assert isinstance(port, np.ndarray) and port.shape == (n, len(_CODES))
        rel = _rel(port, jsim.photometry(jnp.asarray(theta)))
        assert np.quantile(rel, 0.99) < 2e-3
        rel = _rel(port, jsim.photometry_zsorted(theta, sub_chunk=128))
        assert np.median(rel) < 1e-4 and np.quantile(rel, 0.99) < 2e-3
    with pytest.raises(ValueError, match="sorted"):
        tsim.photometry_zsorted(_sorted_theta(64)[::-1].copy())
    with pytest.raises(ValueError, match="smaller than this batch needs"):
        tsim.photometry_zsorted(_sorted_theta(1536), sub_chunk=128, kc=4,
                                w_cols=64)


def test_undersized_plan_is_rejected(sims):
    """A caller-supplied plan smaller than the batch needs would clamp the
    windows and return wrong fluxes; validate_plan turns that into an
    error (the JAX package has no test of this)."""
    _, tsim, _ = sims
    theta = _sorted_theta(1536, seed=9)
    with pytest.raises(ValueError, match="smaller than this batch needs"):
        tsim.photometry_zsorted_device(theta, sub_chunk=128, kc=4, w_cols=64,
                                       validate_plan=True)
    _, _, kc, w_cols, _, _ = tsim._plan_windows(theta, 128)
    tsim.photometry_zsorted_device(theta, sub_chunk=128, kc=kc,
                                   w_cols=w_cols, validate_plan=True)


def test_unported_paths_raise(sims):
    """conv and particle SFZHs are ported now: both run the window engine
    (tests/test_torch_conv.py and test_torch_particles.py hold them to the
    JAX package); bad state still raises."""
    _, tsim, _ = sims
    theta = _sorted_theta(512, seed=4)
    for kw in (dict(photometry_variant="conv"), dict(n_particles=64)):
        sim = tt.BatchSEDSimulator(tsim.grid, tsim.filters, PNAMES,
                                   device="cpu", **kw)
        assert sim._window_supported()
        out = sim.photometry_zsorted_device(theta, sub_chunk=128)
        assert out.shape == (512, len(_CODES)) and torch.isfinite(out).all()
    with pytest.raises(KeyError, match="unknown state"):
        tsim.load_state({"spectra": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tsim.load_state({"t_mix": np.zeros((3, 3), np.float32)})


def test_fused_gate(sims):
    _, tsim, _ = sims
    assert tsim._window_mega_supported()
    sim = tt.BatchSEDSimulator(
        tsim.grid, tsim.filters, PNAMES, device="cpu",
        emission=tt.EmissionConfig(fesc=0.3, reprocessed_types=("total",)))
    assert not sim._window_supported()
    with pytest.raises(ValueError, match=r"call \.photometry\(\) instead"):
        sim.photometry_zsorted_device(_sorted_theta(256), sub_chunk=64)
