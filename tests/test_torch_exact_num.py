"""Port parity, K3 (the exact-shift numerators of the "roll" and "bank"
variants).

Holds the port's sub-column table, shift snapping and plain K3
(`shift_photometry_num_reference`) to the JAX package's
`build_subshift_table[_device]`, `shift_decompose` and both Pallas numerator
kernels — run under `pltpu.force_tpu_interpret_mode()` on the CPU, as
`tests/test_pallas_kernel.py` runs them — and the dense spectra path of both
variants to the JAX package's. The kernel itself runs only on a card
(`tests/test_torch_cuda.py`).

Not carried over: the 128-lane table padding, the `pltpu.roll` of the flux
row, the 128 pre-rolled bank copies (`build_shift_bank_device`,
`bank_decompose`, `bank_nbytes`), `pick_block_b` and the batch padding to
whole blocks. Both variant names run the one kernel.

Tolerances: numerators rtol 2e-5, atol 1e-4, as `tests/test_pallas_kernel.py`
holds the JAX kernels; tables against the JAX on-device table rtol 1e-5,
atol 1e-7 (float32 pow and interpolation; measured equal), against the
float64 host table atol 1e-5; photometry and f_ν end to end |Δ| < 1e-4 of
the row's largest value (the SFZH's own float32 difference, see
`tests/test_torch_dense.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.ops import photometry_kernel as jpk
from synference_tpu_torch.ops import photometry_kernel as pk

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


def _grid_filters(pkg):
    grid = pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    filt = pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])
    return grid, filt


def _dlog(grid):
    return float(np.diff(np.log10(grid.lam)).mean())


@pytest.fixture(scope="module")
def tables():
    """(port table, JAX device table, JAX host table) at max_shift 200."""
    grid, filt = _grid_filters(tt)
    jgrid, jfilt = _grid_filters(jst)
    args = (_dlog(grid), 200, grid.n_wav)
    return (pk.build_subshift_table(filt, grid.lam, *args, "cpu").numpy(),
            np.asarray(jpk.build_subshift_table_device(jfilt, jgrid.lam,
                                                       *args)),
            jpk.build_subshift_table(jfilt, jgrid.lam, *args))


def test_subshift_table_matches_jax(tables):
    port, dev, host = tables
    n_cols = 512 + 200
    assert port.shape == (pk.N_SUB, 8, n_cols)
    np.testing.assert_allclose(port, dev[:, :, :n_cols], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port, host[:, :, :n_cols], atol=1e-5)


def test_shift_decompose_matches_jax():
    s = np.asarray([0.0, 1.3, 57.9, 300.26, 599.0, 0.0625, 1e9, -3.0],
                   np.float32)
    port = pk.shift_decompose(torch.as_tensor(s), 600)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jpk.shift_decompose(jnp.asarray(s), 600)))


def _num_inputs(tables, b=16, seed=0):
    port, dev, _ = tables
    rng = np.random.default_rng(seed)
    fw = rng.random((b, 512)).astype(np.float32)
    s = rng.uniform(0, 199, b).astype(np.float32)
    s4 = np.asarray(jpk.shift_decompose(jnp.asarray(s), 200))
    return fw, s4


def test_plain_k3_matches_pallas_roll(tables):
    port_table, dev, _ = tables
    fw, s4 = _num_inputs(tables)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpk.pallas_photometry_num(
            jnp.asarray(fw), jnp.asarray(dev), jnp.asarray(s4), block_b=8))
    out = pk.shift_photometry_num(torch.tensor(fw), torch.tensor(port_table),
                                  torch.tensor(s4))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=1e-4)


def test_plain_k3_matches_pallas_bank(tables):
    port_table, _, _ = tables
    grid, filt = _grid_filters(jst)
    fw, s4 = _num_inputs(tables, seed=1)
    bank = jpk.build_shift_bank_device(filt, grid.lam, _dlog(grid), 200,
                                       grid.n_wav)
    tid, off = jpk.bank_decompose(jnp.asarray(s4))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpk.pallas_photometry_num_bank(
            jnp.asarray(fw), bank, tid, off, block_b=8))
    out = pk.shift_photometry_num(torch.tensor(fw), torch.tensor(port_table),
                                  torch.tensor(s4))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=1e-4)


def test_plain_k3_clips_shifts_to_the_table(tables):
    """Shifts past the table's reach read its last window, as the kernel
    does, instead of reading outside it."""
    port_table, _, _ = tables
    fw, _ = _num_inputs(tables, b=3)
    table = torch.as_tensor(port_table)
    top = pk.N_SUB * 200 + 7  # m = 200 = n_cols − L, rs = 7
    far = torch.as_tensor([top, top + 80, 10**6 + 7], dtype=torch.int32)
    out = pk.shift_photometry_num(torch.as_tensor(fw), table, far)
    want = (table[7, :, 200:][None] * torch.as_tensor(fw)[:, None]).sum(-1)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6)


def _sim(pkg, variant):
    grid, filt = _grid_filters(pkg)
    dev = {"device": "cpu"} if pkg is tt else {}
    return pkg.BatchSEDSimulator(
        grid, filt, PNAMES, sfh="lognormal", zdist="delta",
        emission=pkg.EmissionConfig(), photometry_backend="pallas",
        photometry_variant=variant, **dev)


def _theta(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(8, 11, n), rng.uniform(0.05, 8, n),
        rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
        rng.uniform(-3.5, -2, n), rng.uniform(0, 2, n)]).astype(np.float32)


def _row_rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    return float((np.abs(port - ref)
                  / np.abs(ref).max(axis=-1, keepdims=True)).max())


@pytest.mark.parametrize("variant", ["roll", "bank"])
def test_exact_variants_match_jax(variant):
    jsim, tsim = _sim(jst, variant), _sim(tt, variant)
    assert tsim._variant == variant and tsim._lam_support is None
    assert not tsim._window_supported() and not tsim._mega_supported()
    n_cols = tsim._subshift_table.shape[2]
    table = jpk.build_subshift_table_device(
        jsim.filters, jsim.grid.lam, jsim._filter_dlog, jsim._max_shift,
        jsim.grid.n_wav)
    tsim.load_state({
        "subshift_table": np.asarray(table)[:, :, :n_cols],
        "den_table": np.asarray(jsim._den_table),
        "components": {k: np.asarray(v) for k, v in jsim._components.items()},
        "igm_table": np.asarray(jsim._igm_table),
        "age_table": np.asarray(jsim._age_table),
        "d19_table": np.asarray(jsim._d19_table)})
    theta = _theta(16, seed=3)
    with pltpu.force_tpu_interpret_mode():
        ref = jsim.simulate(jnp.asarray(theta), want_spectra=True)
    out = tsim.simulate(theta, want_spectra=True)
    for key in ("photometry_njy", "fnu_njy"):
        assert _row_rel(out[key], ref[key]) < 1e-4, key
    np.testing.assert_array_equal(tsim.photometry(theta).numpy(),
                                  out["photometry_njy"].numpy())


def test_roll_and_bank_identical():
    theta = _theta(24, seed=4)
    roll = _sim(tt, "roll").simulate(theta, want_spectra=True)
    bank = _sim(tt, "bank").simulate(theta, want_spectra=True)
    for key in roll:
        np.testing.assert_array_equal(roll[key].numpy(), bank[key].numpy())


@pytest.mark.parametrize("bad,match", [
    (dict(fw=torch.empty(4, 512, device="meta")), "neither CPU nor CUDA"),
])
def test_wrapper_refuses_non_cpu_tensors_it_cannot_launch_on(bad, match):
    before = pk.shift_photometry_num.launches
    a = dict(fw=torch.empty(4, 512), table=torch.empty(8, 8, 712),
             s4=torch.zeros(4, dtype=torch.int32))
    a.update(bad)
    with pytest.raises(ValueError, match=match):
        pk.shift_photometry_num(**a)
    assert pk.shift_photometry_num.launches == before
