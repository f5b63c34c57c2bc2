"""Port parity, K2 (the full-table SED → photometry kernel).

Holds the port's plain K2 (`fused_sed_photometry_reference`, K1's plain
version over the whole tables) to the JAX package's `fused_sed_photometry`
— its Pallas megakernel run in interpret mode on the CPU — on identical
inputs, and the dense `photometry()` that reaches it (pallas backend, interp
variant) to the JAX package's; checks the wrapper's refusals. The kernel
itself runs only on a card (`tests/test_torch_cuda.py`).

Setup: the 32×5×512 test grid, 7 tophat bands, lognormal SFH, delta Z,
Calzetti screen, Inoue14 IGM.

Tolerances, as relative differences on fluxes above 1e-3 of their row
maximum. Against JAX: median < 2e-3, p99 < 5e-3 (both sides round the knot
product's inputs to bf16; a 1-ulp fp32 difference in L_ν flips one rounding).
K2's route against the plain `_photometry_fused` route in this package:
p99 < 1e-5, max < 2e-3 (only the place of dλ/λ differs, so flips are rare;
one moves a ~20-column band by up to ~2e-3).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.ops.fused_sed import fused_sed_photometry as jax_k2
from synference_tpu_torch.ops import fused_sed as k2

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


def _sim(pkg, order=3, fesc=0.0):
    grid = pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    filt = pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])
    dev = {"device": "cpu"} if pkg is tt else {}
    return pkg.BatchSEDSimulator(
        grid, filt, PNAMES, sfh="lognormal", zdist="delta",
        emission=pkg.EmissionConfig(fesc=fesc), photometry_backend="pallas",
        photometry_variant="interp", photometry_interp_order=order, **dev)


@functools.lru_cache(maxsize=None)
def _sims(order=3, fesc=0.0):
    """(JAX simulator, port simulator with the JAX tables loaded), built
    once per module for each configuration."""
    jsim, tsim = _sim(jst, order, fesc), _sim(tt, order, fesc)
    t_mix, m_igm, den_knots = jsim._zsorted_tables()
    tsim.load_state({
        "t_mix": np.asarray(t_mix), "m_igm": np.asarray(m_igm),
        "den_knots": np.asarray(den_knots),
        "dust_curve_sup": np.asarray(jsim._dust_curve_sup),
        "wlam_sup": np.asarray(jsim._wlam_sup),
        "age_table": np.asarray(jsim._age_table),
        "d19_table": np.asarray(jsim._d19_table),
        "components": {k: np.asarray(v) for k, v in jsim._components.items()},
        "dust_curve": np.asarray(jsim._dust_curve)})
    return jsim, tsim


def _theta(n, seed=0):
    """Unsorted θ (the dense path takes rows in any order)."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(7.5, 11, n), rng.uniform(0.05, 8, n),
        rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
        rng.uniform(-3.9, -1.6, n), rng.uniform(0, 2, n),
    ]).astype(np.float32)


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-30)
    return rel[ref > 1e-3 * ref.max(axis=1, keepdims=True)]


def _assert_close(port, ref, median=2e-3, p99=5e-3):
    rel = _rel(port, ref)
    assert np.median(rel) < median, np.median(rel)
    assert np.quantile(rel, 0.99) < p99, np.quantile(rel, 0.99)


def _k2_inputs(tsim, theta):
    params = tsim.theta_dict(torch.as_tensor(theta))
    sfzh, _ = tsim._sfzh(params)
    z = params["redshift"]
    return sfzh, tsim._shift_of_z(z), params["tau_v"], tsim._scale_of_z(z)


def test_prepared_tables_match_jax():
    """The port's K2 tables are the JAX ones without the TPU padding."""
    jsim, tsim = _sims()
    jt, _ = jsim._mega_setup()
    c, n_l, kf, _ = jt["dims"]
    t = tsim._mega_tables
    np.testing.assert_array_equal(t["sed"].numpy(),
                                  np.asarray(jt["sed"])[:c, :n_l])
    np.testing.assert_array_equal(t["knot"].float().numpy(),
                                  np.asarray(jt["knot"], np.float32)[:n_l, :kf])
    np.testing.assert_array_equal(t["den"].numpy().reshape(-1),
                                  np.asarray(jt["den"])[0, :kf])
    np.testing.assert_array_equal(t["curve"].numpy(),
                                  np.asarray(jt["curve"])[0, :n_l])


@pytest.mark.parametrize("order", [1, 3])
def test_plain_k2_matches_jax_interpret(order):
    jsim, tsim = _sims(order)
    sfzh, s, tau_v, scale = _k2_inputs(tsim, _theta(256, seed=order))
    port = k2.fused_sed_photometry_reference(
        sfzh, s, tau_v, scale, tsim._mega_tables, tsim._n_knots,
        tsim._knot_delta, tsim._f8, order=order)
    tables, block_b = jsim._mega_setup()
    ref = jax_k2(*(jnp.asarray(x.numpy()) for x in (sfzh, s, tau_v, scale)),
                 tables, jsim._n_knots, jsim._knot_delta, tsim._f8,
                 order=order, block_b=block_b)
    n_f = len(_CODES)
    _assert_close(port[:, :n_f], np.asarray(ref)[:, :n_f])


@pytest.mark.parametrize("order,fesc", [(1, 0.0), (3, 0.0), (3, 0.25)])
def test_dense_photometry_matches_jax(order, fesc):
    """`photometry()` on unsorted θ: K2's route in both packages (the plain
    version here, the interpret-mode megakernel there)."""
    jsim, tsim = _sims(order, fesc)
    assert tsim._mega_supported() and jsim._mega_supported()
    before = k2.fused_sed_photometry.launches
    theta = _theta(128, seed=10 + order)
    _assert_close(tsim.photometry(theta), jsim.photometry(jnp.asarray(theta)))
    assert k2.fused_sed_photometry.launches == before  # CPU: plain version


@pytest.mark.parametrize("order", [1, 3])
def test_k2_route_matches_plain_fused_route(order):
    tsim = _sim(tt, order)
    theta = torch.as_tensor(_theta(300, seed=20 + order))
    mega = tsim.photometry(theta).numpy()
    res = tsim._core(theta, False, fused=True)
    plain = tsim._photometry_fused(res["_lnu"], res["_z"]).numpy()
    rel = _rel(mega, plain)
    assert np.quantile(rel, 0.99) < 1e-5, np.quantile(rel, 0.99)
    assert rel.max() < 2e-3, rel.max()


def _meta_call(**over):
    b, c, n_l, n_knots, f8 = 64, 48, 256, 12, 8
    meta = dict(device="meta")
    tables = dict(sed=torch.empty(c, n_l, **meta),
                  curve=torch.empty(n_l, **meta),
                  knot=torch.empty(n_l, n_knots * f8, dtype=torch.bfloat16,
                                   **meta),
                  den=torch.empty(n_knots, f8, **meta))
    tables.update(over.pop("tables", {}))
    a = dict(sfzh=torch.empty(b, c, **meta), s=torch.empty(b, **meta),
             tau_v=torch.empty(b, **meta), scale=torch.empty(b, **meta),
             tables=tables, n_knots=n_knots, delta=2, f8=f8)
    a.update(over)
    return a


def test_wrapper_refuses_non_cpu_tensors_it_cannot_launch_on():
    before = k2.fused_sed_photometry.launches
    with pytest.raises(ValueError, match="fused_sed_photometry: tensors on"):
        k2.fused_sed_photometry(**_meta_call())
    assert k2.fused_sed_photometry.launches == before


def test_cuda_input_checks_name_k2():
    """K2 shares K1's input checks, with its own name in the errors."""
    a = _meta_call(tables=dict(knot=torch.empty(256, 96, device="meta")))
    t = a["tables"]
    with pytest.raises(ValueError, match="fused_sed_photometry: knot_w"):
        k2._check_cuda_inputs(a["sfzh"], a["s"], a["tau_v"], a["scale"],
                              t["sed"], t["curve"], t["knot"], t["den"],
                              a["n_knots"], a["delta"], a["f8"], 3,
                              who="fused_sed_photometry")
