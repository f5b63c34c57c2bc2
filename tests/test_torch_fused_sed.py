"""Port parity, K1 (the windowed SED → photometry kernel).

Holds the port's plain K1 (`fused_window_photometry_reference`) to the JAX
package's `fused_window_photometry` — its Pallas kernel run in interpret mode
on the CPU — on identical window inputs, and to the port's staged window
body; checks that the CUDA wrapper refuses tensors it cannot launch on
instead of computing. The kernel itself runs only on a card
(`tests/test_torch_cuda.py`).

Mosaic workarounds of the TPU kernel that the port does not carry over:
8-row galaxy-block padding, 128-lane padding with power-of-two knot slots,
lane-mask row selection with the log-step `pltpu.roll` band reduction, and
the one-hot batched-matmul knot gather. The port reads the four knot rows
k−1..k+2 of each galaxy by direct index.

Tolerances, as relative differences on fluxes above 1e-3 of their row
maximum. Against JAX: median < 2e-3, p99 < 5e-3. Both sides round the knot
product's inputs to bf16; a 1-ulp fp32 difference in lnu can flip one bf16
rounding (0.4%), which the terms of a band average down. Plain K1 against the
staged body, both in this package: p99 < 1e-5, max < 2e-3 (measured p99 0,
max 2.1e-4: only dλ/λ's place differs, so flips are rare, and one moves a
~30-column band by at most ~1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu.ops.fused_sed import fused_window_photometry as jax_k1
from synference_tpu_torch.ops import fused_sed as k1

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


def _sim(order=3, emission=None):
    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    filters = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                            zip(_CODES, _CENTERS, _WIDTHS)])
    return tt.BatchSEDSimulator(grid, filters, PNAMES,
                                emission=emission or tt.EmissionConfig(),
                                photometry_interp_order=order, device="cpu")


def _sorted_theta(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(7.5, 11, n), np.sort(rng.uniform(0.05, 8, n)),
        rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
        rng.uniform(-3.9, -1.6, n), rng.uniform(0, 2, n),
    ]).astype(np.float32)


def _assert_close(port, ref, median=2e-3, p99=5e-3):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-30)
    sig = ref > 1e-3 * ref.max(axis=1, keepdims=True)
    assert np.median(rel[sig]) < median, np.median(rel[sig])
    assert np.quantile(rel[sig], 0.99) < p99, np.quantile(rel[sig], 0.99)


def _window_args(sim, n=1536, sub=128, seed=0):
    """K1 arguments of every sub-chunk of a z-sorted batch."""
    theta, sub, kc, w_cols, k0, l0 = sim._plan_windows(
        _sorted_theta(n, seed), sub)
    return [a for _, _, _, a in sim._window_calls(theta, sub, w_cols, kc,
                                                  k0, l0)]


@pytest.mark.parametrize("order", [1, 3])
def test_plain_k1_matches_jax_interpret(order):
    sim = _sim(order)
    for a in _window_args(sim)[::5]:
        port = k1.fused_window_photometry_reference(**a)
        np_args = {k: (v.float().numpy() if torch.is_tensor(v) else v)
                   for k, v in a.items()}
        ref = jax_k1(*(jnp.asarray(np_args[k]) for k in (
            "sfzh", "s_rel", "tau_v", "scale", "sed_w", "curve_w", "knot_w",
            "den_w")), a["kc"], a["delta"], a["f8"], order=order,
            fesc=a["fesc"])
        _assert_close(port[:, :len(_CODES)], np.asarray(ref)[:, :len(_CODES)])


def test_plain_k1_matches_jax_interpret_with_fesc():
    """fesc ≠ 0 without reprocessed types: fw = lnu·(fesc + (1−fesc)·att)."""
    sim = _sim(emission=tt.EmissionConfig(fesc=0.25))
    a = _window_args(sim, seed=2)[1]
    assert a["fesc"] == 0.25
    port = k1.fused_window_photometry_reference(**a)
    ref = jax_k1(*(jnp.asarray(a[k].float().numpy()) for k in (
        "sfzh", "s_rel", "tau_v", "scale", "sed_w", "curve_w", "knot_w",
        "den_w")), a["kc"], a["delta"], a["f8"], order=3, fesc=0.25)
    _assert_close(port[:, :len(_CODES)], np.asarray(ref)[:, :len(_CODES)])


@pytest.mark.parametrize("order", [1, 3])
def test_plain_k1_matches_staged_body(order):
    """The fused body (dλ/λ folded into the spectra) against the staged body
    (dλ/λ applied after the screen), through the window engine."""
    sim = _sim(order)
    theta = _sorted_theta(1536, seed=4)
    # the window must engage (the planner raises when it is the whole table)
    _, _, kc, w_cols, _, _ = sim._plan_windows(theta, 128)
    assert kc < sim._n_knots and w_cols < sim._l_sup
    fused = sim.photometry_zsorted_device(theta, sub_chunk=128, fused=True)
    staged = sim.photometry_zsorted_device(theta, sub_chunk=128,
                                           fused=False).numpy()
    rel = np.abs(fused.numpy() - staged) / np.maximum(np.abs(staged), 1e-30)
    rel = rel[staged > 1e-3 * staged.max(axis=1, keepdims=True)]
    assert np.quantile(rel, 0.99) < 1e-5, np.quantile(rel, 0.99)
    assert rel.max() < 2e-3, rel.max()


def _meta_args(**over):
    b, c, w, kc, f8 = 64, 48, 256, 8, 8
    meta = dict(device="meta")
    a = dict(sfzh=torch.empty(b, c, **meta), s_rel=torch.empty(b, **meta),
             tau_v=torch.empty(b, **meta), scale=torch.empty(b, **meta),
             sed_w=torch.empty(c, w, **meta), curve_w=torch.empty(w, **meta),
             knot_w=torch.empty(w, kc * f8, dtype=torch.bfloat16, **meta),
             den_w=torch.empty(kc, f8, **meta), kc=kc, delta=2, f8=f8)
    a.update(over)
    return a


def test_wrapper_refuses_non_cpu_tensors_it_cannot_launch_on():
    """A non-CPU request never falls back to the plain version: tensors on a
    device that is neither CPU nor CUDA raise, and no launch is counted."""
    before = k1.fused_window_photometry.launches
    with pytest.raises(ValueError, match="neither CPU nor CUDA"):
        k1.fused_window_photometry(**_meta_args())
    assert k1.fused_window_photometry.launches == before


@pytest.mark.parametrize("bad,match", [
    (dict(knot_w=torch.empty(256, 64, device="meta")), "knot_w must be"),
    (dict(sfzh=torch.empty(64, 48, dtype=torch.float64, device="meta")),
     "sfzh must be"),
    (dict(den_w=torch.empty(8, 7, device="meta")), "den_w has shape"),
    (dict(sed_w=torch.empty(256, 48, device="meta").T), "unit column stride"),
    (dict(tau_v=torch.empty(128, device="meta")[::2]), "must be contiguous"),
    (dict(order=2), "order must be"),
    (dict(f8=256, knot_w=torch.empty(256, 2048, dtype=torch.bfloat16,
                                     device="meta"),
          den_w=torch.empty(8, 256, device="meta")), "f8 <= 128"),
])
def test_cuda_input_checks(bad, match):
    """The checks the wrapper runs before a launch, on shape-only tensors."""
    a = _meta_args(**bad)
    with pytest.raises(ValueError, match=match):
        k1._check_cuda_inputs(*(a[k] for k in (
            "sfzh", "s_rel", "tau_v", "scale", "sed_w", "curve_w", "knot_w",
            "den_w")), a["kc"], a["delta"], a["f8"], a.get("order", 3))


def test_cuda_input_checks_accept_window_views():
    """Row-strided window views of the simulator's tables pass as they are."""
    a = _meta_args()
    big = torch.empty(48, 1024, device="meta")
    a["sed_w"] = big[:, 100:356]
    k1._check_cuda_inputs(*(a[k] for k in (
        "sfzh", "s_rel", "tau_v", "scale", "sed_w", "curve_w", "knot_w",
        "den_w")), a["kc"], a["delta"], a["f8"], 3)
