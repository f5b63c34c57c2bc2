"""Port parity, the table-free `conv` photometry engine and "auto".

The port's `conv_photometry_num` against the JAX package's on the same
flux rows, extended table and shifts (plain and windowed), then the conv
variant through the simulator's routes: `photometry()` (the λ-support path
with the IGM as a row lerp), `simulate(want_spectra=True)` and the z-sorted
window engine (staged body; K1 is interp-only).

Deliberate difference: "auto" keeps the interp knot matrix at any size on
every device. The JAX package switches to conv above 64 MiB of knot matrix
only because of its TPU's remote-compile request cap; the port has no such
cap, so `_pick_variant("auto", ...)` is "interp" however many knots.

Tolerances, on values above 1e-3 of their row's maximum:
- port conv vs JAX conv on identical inputs: p99 relative < 1e-5 (both
  round the inputs to bf16 and accumulate in fp32; measured p99 ≤ 2e-7);
- port conv vs port interp, and each against the exact "xla" route: the
  JAX package's own conv/interp bound (tests/test_pallas_kernel.py):
  median < 2e-3, p99 < 2e-2 on bands above 1e-2 of the row maximum; the
  λ-support route against the spectra route: p99 < 5e-3 (its bound there;
  the bf16 inputs are rounded at another scale);
- the window engine against the dense conv route: median < 2e-3, p99 <
  5e-3 (the same bf16 knot products over another knot matrix build).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.ops import photometry_kernel as jpk
from synference_tpu_torch.ops import photometry_kernel as tpk

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


@functools.lru_cache(maxsize=None)
def _sim(variant, backend="pallas", shape=(32, 5, 512)):
    grid = tt.make_synthetic_grid(n_ages=shape[0], n_mets=shape[1],
                                  n_wav=shape[2], seed=0)
    filt = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                         zip(_CODES, _CENTERS, _WIDTHS)])
    kw = {} if backend == "xla" else dict(photometry_variant=variant)
    return tt.BatchSEDSimulator(grid, filt, PNAMES, photometry_backend=backend,
                                device="cpu", **kw)


def _theta(n, seed=0, sort=False):
    rng = np.random.default_rng(seed)
    theta = np.column_stack([
        rng.uniform(7.5, 11, n), rng.uniform(0.05, 11, n),
        rng.uniform(5e7, 1e9, n), rng.uniform(0.1, 1.2, n),
        rng.uniform(-3.9, -1.5, n), rng.uniform(0, 3, n)]).astype(np.float32)
    return theta[np.argsort(theta[:, 1])] if sort else theta


def _sig_rel(port, ref, floor=1e-2):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    scale = np.abs(ref).max(axis=1, keepdims=True)
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-3 * scale)
    return rel[np.abs(ref) > floor * scale]


@pytest.mark.parametrize("windowed", [False, True])
def test_conv_num_matches_jax(windowed):
    sim = _sim("conv")
    rng = np.random.default_rng(1)
    l0, l1 = sim._sup
    fw = rng.lognormal(0, 1, (64, l1 - l0)).astype(np.float32)
    s = rng.uniform(0, sim._max_shift, 64).astype(np.float32)
    table = sim._filter_table.numpy()
    cols = sim._filter_cols if windowed else None
    kw = dict(delta=sim._knot_delta, order=3, l_offset=l0, filter_cols=cols)
    port = tpk.conv_photometry_num(torch.as_tensor(fw),
                                   torch.as_tensor(table), sim._n_knots,
                                   torch.as_tensor(s), **kw).numpy()
    ref = np.asarray(jpk.conv_photometry_num(
        jnp.asarray(fw), jnp.asarray(table), sim._n_knots, jnp.asarray(s),
        **kw))
    rel = _sig_rel(port, ref, floor=1e-3)
    assert np.quantile(rel, 0.99) < 1e-5


def test_conv_windowed_equals_plain_gather():
    """The windowed engine changes only the grouping of the same products."""
    sim = _sim("conv")
    rng = np.random.default_rng(2)
    l0, l1 = sim._sup
    fw = torch.as_tensor(rng.lognormal(0, 1, (32, l1 - l0)).astype(np.float32))
    s = torch.as_tensor(rng.uniform(0, sim._max_shift, 32).astype(np.float32))
    args = (fw, sim._filter_table, sim._n_knots, s)
    kw = dict(delta=sim._knot_delta, l_offset=l0)
    a = tpk.conv_photometry_num(*args, **kw)
    b = tpk.conv_photometry_num(*args, filter_cols=sim._filter_cols, **kw)
    assert np.quantile(_sig_rel(b, a, floor=1e-3), 0.99) < 1e-6


def test_conv_routes_match_interp_and_exact():
    conv, interp, xla = _sim("conv"), _sim("interp"), _sim("", "xla")
    assert conv._variant == "conv" and conv._knot_matrix is None
    assert conv._lam_support is not None
    theta = _theta(256, seed=3)
    theta[0, 1], theta[1, 1] = 0.0, 11.9  # z end points
    px = xla.photometry(theta).numpy()
    for sim in (conv, interp):
        rel = _sig_rel(sim.photometry(theta), px)
        assert np.median(rel) < 2e-3 and np.quantile(rel, 0.99) < 2e-2
    rel = _sig_rel(conv.photometry(theta), interp.photometry(theta))
    assert np.median(rel) < 2e-3 and np.quantile(rel, 0.99) < 2e-2
    out = conv.simulate(theta[:32], want_spectra=True)
    assert out["lnu"].shape[1] == conv.grid.n_wav
    rel = _sig_rel(out["photometry_njy"], px[:32])
    assert np.quantile(rel, 0.99) < 2e-2
    # the λ-support path (IGM as a row lerp, scalar distance) against the
    # spectra path's full observation: the bf16 rounding of the product's
    # input falls on values scaled differently (the JAX package's bound)
    rel = _sig_rel(conv.photometry(theta[:32]), out["photometry_njy"],
                   floor=1e-3)
    assert np.quantile(rel, 0.99) < 5e-3


def test_conv_window_engine_staged():
    conv = _sim("conv", shape=(16, 4, 1024))  # windows narrower than 1024 λ
    assert conv._window_supported() and not conv._window_mega_supported()
    assert not conv._mega_supported()
    theta = _theta(2048, seed=4, sort=True)
    _, sub, kc, w_cols, k0, _ = conv._plan_windows(theta, 64)
    assert k0 is not None, "the plan must be narrower than the table"
    out = conv.photometry_zsorted_device(theta, sub_chunk=64)
    rel = _sig_rel(out, conv.photometry(theta))
    assert np.median(rel) < 2e-3 and np.quantile(rel, 0.99) < 5e-3
    assert conv._conv_m_igm.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="FUSED"):
        conv.photometry_zsorted_device(theta, sub_chunk=64, fused=True)


def test_auto_keeps_interp_at_any_size():
    """The JAX package's "auto" picks conv for a knot matrix above 64 MiB
    (its TPU compile-request cap); the port keeps interp."""
    sim = _sim("interp")
    assert sim._pick_variant("auto") == "interp"
    auto = tt.BatchSEDSimulator(sim.grid, sim.filters, PNAMES, device="cpu",
                                photometry_backend="pallas")
    assert auto._variant == "interp"
    with pytest.raises(ValueError, match="unknown photometry_variant"):
        sim._pick_variant("exact")
    jsim = jst.BatchSEDSimulator(
        jst.make_synthetic_grid(n_ages=4, n_mets=2, n_wav=2048, seed=0),
        jst.FilterSet([jst.tophat_filter(f"B{i}", 9000. + 1600 * i, 900.)
                       for i in range(16)]),
        PNAMES, photometry_backend="pallas", photometry_knot_delta=1)
    knot_bytes = 2048 * (jsim._max_shift + 2) * 16 * 4
    assert jsim._pallas_variant == "conv" and knot_bytes > 64 * 2**20
