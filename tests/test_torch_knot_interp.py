"""Port parity, knot-matrix photometry: `build_knot_matrix_device`,
`build_den_table` and `_knot_interp` (orders 1 and 3) of the port against
`synference_tpu/ops/photometry_kernel.py` on the same inputs.

The port reads the four knot rows k−1..k+2 by direct index; the JAX
package's one-hot batched-matmul gather is a TPU workaround and is not
carried over. Tolerance: float32 rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.ops import photometry_kernel as jpk
from synference_tpu_torch.ops import photometry_kernel as tpk

_LAM = np.geomspace(300.0, 1e7, 1024)
_DLOG = float(np.diff(np.log10(_LAM)).mean())
_CODES = ["F090W", "F200W", "F444W"]
_CENTERS = [9000.0, 20000.0, 44400.0]
_WIDTHS = [2000.0, 4600.0, 10200.0]


def _filters(pkg):
    return pkg.FilterSet([pkg.tophat_filter(c, ct, w) for c, ct, w in
                          zip(_CODES, _CENTERS, _WIDTHS)])


@pytest.mark.parametrize("l_range", [None, (100, 600)])
def test_knot_matrix(l_range):
    """The port replicates jnp.interp's float32 arithmetic, so the tables
    agree to float32 rounding."""
    port, n_port = tpk.build_knot_matrix_device(
        _filters(tt), _LAM, _DLOG, 200, len(_LAM), "cpu", delta=4,
        l_range=l_range)
    ref, n_ref = jpk.build_knot_matrix_device(
        _filters(jst), _LAM, _DLOG, 200, len(_LAM), delta=4, l_range=l_range)
    assert n_port == n_ref
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_den_table_identical():
    wlam = (np.gradient(_LAM) / _LAM).astype(np.float32)
    np.testing.assert_array_equal(
        tpk.build_den_table(_filters(tt), _LAM, wlam, _DLOG, 200),
        jpk.build_den_table(_filters(jst), _LAM, wlam, _DLOG, 200))


_N_KNOTS, _DELTA = 12, 4
_TOP = (_N_KNOTS - 1) * _DELTA


def _shifts(rng, n):
    """Interior shifts plus both table edges, the top interval, and shifts
    past the clip on either side."""
    edges = np.array([0.0, 1e-4, _DELTA - 1e-3, _DELTA, _TOP - _DELTA,
                      _TOP - 0.5, _TOP - 1e-3, _TOP, _TOP + 3.0, -2.0])
    return np.concatenate([edges, rng.uniform(0, _TOP, n - len(edges))]
                          ).astype(np.float32)


def _knot_values(rng, b, scale):
    """Smooth positive knot rows with a kink and a flat stretch, at the L_ν
    scale of the fused photometry path (~1e30) or at unit scale."""
    k = np.arange(_N_KNOTS)[None, :, None]
    base = 1.0 + 0.5 * np.sin(0.7 * k + rng.uniform(0, 6, (b, 1, 5)))
    base[:, 5:7] = base[:, 5:6]  # flat -> zero FB slope
    base[:, 8] *= 3.0  # kink -> sign change of the differences
    return (base * scale).astype(np.float32)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("scale", [1.0, 1e30])
def test_knot_interp_batched(order, scale):
    rng = np.random.default_rng(order)
    vals = _knot_values(rng, 64, scale)
    s = _shifts(rng, 64)
    port = tpk._knot_interp(torch.as_tensor(vals), torch.as_tensor(s),
                            _N_KNOTS, _DELTA, order)
    ref = jpk._knot_interp(jnp.asarray(vals), jnp.asarray(s), _N_KNOTS,
                           _DELTA, order)
    assert np.isfinite(port.numpy()).all()
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("order", [1, 3])
def test_knot_interp_shared_table(order):
    rng = np.random.default_rng(10 + order)
    table = _knot_values(rng, 1, 1.0)[0]  # (K, F) shared by the batch
    s = _shifts(rng, 50)
    port = tpk._knot_interp(torch.as_tensor(table), torch.as_tensor(s),
                            _N_KNOTS, _DELTA, order)
    ref = jpk._knot_interp(jnp.asarray(table), jnp.asarray(s), _N_KNOTS,
                           _DELTA, order)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5)


def test_knot_interp_rejects_other_orders():
    with pytest.raises(ValueError, match="order"):
        tpk._knot_interp(torch.ones(2, 4, 1), torch.zeros(2), 4, 2, 2)
