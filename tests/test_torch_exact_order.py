"""Port parity, K3's data path on the CPU: the row order, the row keys and
the band-adjacent table that the CUDA kernel (`csrc/shift_num.cu`) reads.

The kernel itself runs only on a card (`tests/test_torch_cuda.py`). What
surrounds it is plain PyTorch and is held here: `shift_row_order` returns a
stable permutation that groups the table row rs and orders the integer
shift m; `band_adjacent_table` round-trips; and the plain version that walks
the kernel's path (`shift_photometry_num_ordered_reference`: rows in shift
order, shifts decoded from the sorted keys, bands read from the band-adjacent
table, results scattered back) equals the straightforward plain version and
both JAX Pallas numerator kernels, run under
`pltpu.force_tpu_interpret_mode()` on the CPU as `tests/test_pallas_kernel.py`
runs them, on the seeded numpy inputs of `tests/test_torch_exact_num.py`.

Tolerance against the Pallas kernels: relative difference < 1e-5 on fluxes
above 1e-3 of their row maximum (float32 sums of 512 positive products in
another order; measured max 2.1e-7). Against the port's own plain version:
rtol 1e-5, atol 1e-6 of the row maximum.
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

_CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
_CENTERS = [9000., 11500., 15000., 20000., 27700., 35600., 44400.]
_WIDTHS = [2000., 2600., 3300., 4600., 7000., 7800., 10200.]
_MAX_SHIFT = 200


def _grid_filters(pkg):
    grid = pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    filt = pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])
    return grid, filt


def _dlog(grid):
    return float(np.diff(np.log10(grid.lam)).mean())


@pytest.fixture(scope="module")
def tables():
    """(port table, JAX device table) at max_shift 200."""
    grid, filt = _grid_filters(tt)
    jgrid, jfilt = _grid_filters(jst)
    args = (_dlog(grid), _MAX_SHIFT, grid.n_wav)
    return (pk.build_subshift_table(filt, grid.lam, *args, "cpu"),
            np.asarray(jpk.build_subshift_table_device(jfilt, jgrid.lam,
                                                       *args)))


def _num_inputs(b=16, seed=0):
    """The inputs of `tests/test_torch_exact_num.py::_num_inputs`."""
    rng = np.random.default_rng(seed)
    fw = rng.random((b, 512)).astype(np.float32)
    s = rng.uniform(0, _MAX_SHIFT - 1, b).astype(np.float32)
    return fw, np.asarray(jpk.shift_decompose(jnp.asarray(s), _MAX_SHIFT))


def _rel_significant(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)
    return rel[ref > 1e-3 * ref.max(axis=1, keepdims=True)]


# ---------------------------------------------------------------------------
# the row order
# ---------------------------------------------------------------------------
_ORDER_CASES = {
    "random": lambda rng: rng.integers(0, 8 * 300, 500),
    "one-shift": lambda rng: np.full(77, 1001),
    "each-rs": lambda rng: 800 + np.arange(8),
    "sorted": lambda rng: np.sort(rng.integers(0, 8 * 300, 200)),
    "clipped": lambda rng: rng.integers(-50, 8 * 300 + 400, 300),
    "single": lambda rng: np.asarray([13]),
}


@pytest.mark.parametrize("case", sorted(_ORDER_CASES))
def test_row_order_is_a_stable_grouping_permutation(case):
    n_l, n_cols = 1024, 1024 + 300
    s4 = torch.as_tensor(_ORDER_CASES[case](np.random.default_rng(3)),
                         dtype=torch.int32)
    order, keys = pk.shift_row_order(s4, n_l, n_cols)
    b = s4.shape[0]
    assert order.dtype == torch.int64 and tuple(order.shape) == (b,)
    assert sorted(order.tolist()) == list(range(b))  # a permutation
    m, rs = pk._shift_parts(s4, n_l, n_cols)
    n_m = n_cols - n_l + 1
    want = rs * n_m + m  # rs groups, m ascending within each
    np.testing.assert_array_equal(keys.long().numpy(), want[order].numpy())
    assert bool((keys[1:] >= keys[:-1]).all())
    # stable: equal keys keep the caller's row order
    same = keys[1:] == keys[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    # the kernel decodes (rs, m) from the sorted key alone
    np.testing.assert_array_equal((keys.long() // n_m).numpy(),
                                  rs[order].numpy())
    np.testing.assert_array_equal((keys.long() % n_m).numpy(),
                                  m[order].numpy())


@pytest.mark.parametrize("n_m,dtype", [(1, torch.int16), (643, torch.int16),
                                       (4095, torch.int16),
                                       (4096, torch.int32),
                                       (20000, torch.int32)])
def test_row_keys_take_int16_where_they_fit(n_m, dtype):
    s4 = torch.as_tensor([0, 7, 8 * (n_m - 1) + 7, 8 * n_m + 5, -3, 10**6 + 2],
                         dtype=torch.int32)
    keys = pk.shift_row_keys_reference(s4, n_m)
    assert keys.dtype == dtype
    top = n_m - 1
    want = [0, 7 * n_m, 7 * n_m + top, 5 * n_m + top, 0,
            ((10**6 + 2) % 8) * n_m + min((10**6 + 2) // 8, top)]
    assert keys.tolist() == want
    assert max(want) <= torch.iinfo(dtype).max


# ---------------------------------------------------------------------------
# the band-adjacent table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("f8,n_cols", [(8, 712), (16, 700), (8, 64),
                                       (128, 33)])
def test_band_adjacent_table_round_trips(f8, n_cols):
    rng = np.random.default_rng(f8 + n_cols)
    table = torch.as_tensor(rng.random((pk.N_SUB, f8, n_cols)),
                            dtype=torch.float32)
    laid = pk.band_adjacent_table(table)
    ncp = -(-n_cols // 32) * 32
    assert tuple(laid.shape) == (pk.N_SUB, f8 // 4, ncp, 4)
    assert laid.is_contiguous()
    # band f of column j sits at [rs, f // 4, j, f % 4]; padding is zero
    for rs, f, j in [(0, 0, 0), (3, 5, n_cols - 1), (7, f8 - 1, n_cols // 2)]:
        assert laid[rs, f // 4, j, f % 4] == table[rs, f, j]
    assert not bool(laid[:, :, n_cols:].any())
    back = pk.band_adjacent_table_inverse(laid, n_cols)
    assert torch.equal(back, table)


def test_band_adjacent_table_is_made_once_per_table():
    table = torch.rand(pk.N_SUB, 8, 40)
    laid = pk._laid_table(table)
    assert pk._laid_table(table) is laid
    table.mul_(2.0)  # a new version of the same tensor: laid out again
    again = pk._laid_table(table)
    assert again is not laid
    assert torch.equal(pk.band_adjacent_table_inverse(again, 40), table)
    other = table.clone()
    assert pk._laid_table(other) is not again
    n = len(pk._LAID)
    del table, other
    assert len(pk._LAID) == n - 2  # dropped with their tensors


# ---------------------------------------------------------------------------
# the plain version along the kernel's path
# ---------------------------------------------------------------------------
def test_ordered_plain_k3_matches_pallas_roll(tables):
    port_table, dev = tables
    fw, s4 = _num_inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpk.pallas_photometry_num(
            jnp.asarray(fw), jnp.asarray(dev), jnp.asarray(s4), block_b=8))
    out = pk.shift_photometry_num_ordered_reference(
        torch.tensor(fw), port_table, torch.tensor(s4))
    assert _rel_significant(out.numpy(), ref).max() < 1e-5


def test_ordered_plain_k3_matches_pallas_bank(tables):
    port_table, _ = tables
    grid, filt = _grid_filters(jst)
    fw, s4 = _num_inputs(seed=1)
    bank = jpk.build_shift_bank_device(filt, grid.lam, _dlog(grid),
                                       _MAX_SHIFT, grid.n_wav)
    tid, off = jpk.bank_decompose(jnp.asarray(s4))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpk.pallas_photometry_num_bank(
            jnp.asarray(fw), bank, tid, off, block_b=8))
    out = pk.shift_photometry_num_ordered_reference(
        torch.tensor(fw), port_table, torch.tensor(s4))
    assert _rel_significant(out.numpy(), ref).max() < 1e-5


_SHAPES = {
    # b, L, n_cols, f8
    "one-row": (1, 100, 170, 8),
    "three-rows": (3, 100, 170, 8),
    "ragged": (37, 101, 173, 8),
    "no-shift": (20, 64, 64, 8),
    "sixteen-bands": (29, 96, 160, 16),
    "many-bands": (9, 40, 70, 128),
    "wide-keys": (50, 40, 40 + 5000, 8),
}


@pytest.mark.parametrize("case", sorted(_SHAPES))
def test_ordered_plain_k3_matches_plain(case):
    b, n_l, n_cols, f8 = _SHAPES[case]
    rng = np.random.default_rng(b + n_l)
    fw = torch.as_tensor(rng.random((b, n_l)), dtype=torch.float32)
    table = torch.as_tensor(rng.random((pk.N_SUB, f8, n_cols)),
                            dtype=torch.float32)
    # shifts below 0 and past the table's reach are clipped alike
    s4 = torch.as_tensor(rng.integers(-5, 8 * (n_cols - n_l) + 40, b),
                         dtype=torch.int32)
    ref = pk.shift_photometry_num_reference(fw, table, s4)
    out = pk.shift_photometry_num_ordered_reference(fw, table, s4, rows=7)
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, f8)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6 * float(ref.max()))
    # the CPU wrapper is the plain version
    assert torch.equal(pk.shift_photometry_num(fw, table, s4), ref)


def test_ordered_plain_k3_rows_come_back_in_input_order():
    """Sorted and unsorted shifts: row b of the result belongs to row b of
    the input either way."""
    rng = np.random.default_rng(5)
    fw = torch.as_tensor(rng.random((64, 80)), dtype=torch.float32)
    table = torch.as_tensor(rng.random((pk.N_SUB, 8, 200)),
                            dtype=torch.float32)
    s4 = torch.as_tensor(rng.integers(0, 8 * 120, 64), dtype=torch.int32)
    out = pk.shift_photometry_num_ordered_reference(fw, table, s4)
    perm = torch.argsort(s4.long(), stable=True)
    out_sorted = pk.shift_photometry_num_ordered_reference(
        fw[perm], table, s4[perm].contiguous())
    np.testing.assert_allclose(out_sorted.numpy(), out[perm].numpy(),
                               rtol=1e-6)
