"""The kernels on the card: K1, K2 and K3 against their plain PyTorch
versions on the simulator's own inputs, at small and ragged shapes. Needs an
NVIDIA Hopper card and nvcc; skips elsewhere (the kernels have no CPU
build). Imports no JAX, so it runs on a machine with the port alone:

    python -m pytest tests/test_torch_cuda.py -q

Tolerance, as relative differences on fluxes above 1e-3 of their row
maximum: p99 < 1e-5 and max < 2e-3, for K1 against its plain version and for
the fused window body against the staged one. Both sides run an fp32 first
product and a bf16 knot product; they differ in float32 summation order
(and the staged body applies dλ/λ after the screen), which now and then
flips the bf16 rounding of one knot-product input. At these 1024-λ shapes a
band spans ~30 columns, so one flip moves a flux by up to ~1e-3 (one bf16
ulp, 2^-7, times one column's share). Measured on an H100: p99 ≤ 1.9e-7, max
≤ 2.5e-4 (kernel vs plain); p99 1.8e-7, max 3.8e-4 (fused vs staged). The
p99 bound is the one that separates rounding order from a cheaper product:
the plain version with a TF32 first product reaches p99 6.7e-4, with bf16
inputs to it 2.5e-3 (`test_bound_rejects_lower_precision_first_product`).
`chip_smoke.py` holds K1 to max < 1e-5 at the north-star sub-chunk, where
bands span hundreds of columns.

K1 and K2 are also held to the exact first product (float64, rounded once
to fp32: `fused_window_photometry_exact`): p99 < 1e-5 and max < 1e-3, the
per-flux parts of `exact_gate`, whose share part `chip_smoke.py` holds at
the main-path shapes; one TF32 product and bf16 inputs miss the p99
(`test_bound_rejects_lower_precision_first_product`). The kernels' first
product is an fp32 FMA chain over cells in ascending order, fed by TMA, so
each shape is also covered at a cell count that is a multiple of 4 but not
of the 32-cell ring stage.

K2 (the dense path's full-table kernel) runs the same arithmetic over the
whole λ support and is held to the same bound and power check, at batch
sizes 1, 3, 13 and 777. K3 (exact-shift numerators) sums fp32 products of
positive values in another order than its plain version: max relative
difference < 1e-5, at those batch sizes and at 16 and 128 bands, a flux
length that ends inside a chunk, a table without shifts, one shift for every
row, eight rows of eight table rows, row- and column-sliced flux views, a
table slab wider than shared memory, and keys that need 32 bits. A K3 row's
bits do not depend on the batch around it, and its row keys equal their
plain version.

The quickstart slice on the card: the native OOD scores (float64) and
`MissingPhotometryHandler` (draws passed in) against the CPU,
`compute_supplementary` against the CPU on the same simulate() outputs,
device-sampler resume bit for bit, nine batches copied out through the
pinned slots bit for bit against per-part reads (with the slots' pinned
bytes fixed as n grows), the same for a spectra run through a
`SpectralFeaturePipeline`, its features and photometry both through the
slots, and `generate` at the defaults taking K1 once per batch on runs of
2 and 4 batches, with the bits of `zsorted_fused=True`, and a failing K1
failing the run; a run padded to whole sub-chunks, its last batch short,
launches K1 once a batch with the bits of its whole-batch-padded twin.

The inference slice on the card: every name of the flow zoo, two members,
card against CPU from the same parameters and base draws (`log_prob` and
samples to 1e-4) and one finite training step; `run_batched_mcmc` card
against CPU from the same draws (1e-5) and its sync guard raising on a
log-density that reads back.

The gradient slice on the card: each of the five kernel wrappers raises on
an input that requires grad, on a forward-AD dual and inside
`torch.func.jacfwd`; Fisher, MAP, VI and HMC launch no kernel (the
simulator's `_mega_off`) and restore the flag; HMC's graphed
value-and-gradient pass equals the eager one bit for bit and the CPU's
within 1e-4; `fit_catalogue_hmc` from the same draws on the card and the
CPU (chaotic: within 5e-2 of the prior width), the card's call running
whole under `set_sync_debug_mode("error")`.

The AGN slice on the card: the analytic and the grid AGN simulator launch
no K1, K2 or K3 from `photometry()` or `generate()` (the forward-model
gate) and match their CPU route; a stellar-plus-AGN composite launches K2
once per `photometry()` and equals the sum of its components' plain
routes within the bound above.

The simformer, HPO and `parallel/` slice on the card: the simformer's
graphed reverse-SDE sampler and graphed probability-flow ODE equal their
eager runs bit for bit and the CPU's score within 1e-4; on a one-rank NCCL
group the sharded photometry launches K2 once per call and equals
`photometry()` bit for bit, and the sharded training step (its `all_reduce`
included) equals the trainer's step bit for bit.

The birth-cloud slice (Charlot & Fall 2000 dust) on the card, at the
north-star width (C 768, the first 300 cells young): K1 lone (F8 8) and
in clusters (F8 64) over 32768 z-sorted rows, and K2 from `photometry()`
of 16384 unsorted rows, each pass `exact_gate` whole against the two
populations' exact first products; at F8 64 K1 equals its 8-band slices
bit for bit; with τ_BC = 0 each equals the one-screen kernel bit for bit;
`generate(2²⁰)` of the model launches K1 16 times and no K2 or dense
`simulate`. The one-screen main paths (`generate(2²⁰)` at 7 bands,
`generate(10⁵)` at 63) keep the sha256 of their θ and photometry that
they read on an H100 80GB HBM3 before the birth-cloud kernels, and the
birth-cloud path (`generate(2²⁰)` at 7 bands) the sha256 it read before
the escape kernels.

The Pacman slice (fesc a θ column: the incident light escapes unscreened,
the reprocessed light sits behind the ISM screen) on the card, at the
north-star width: the escape K1 lone (F8 8) and in clusters (F8 64) over
32768 z-sorted rows, and the escape K2 from `photometry()` of 16384
unsorted rows, rows at fesc = 0, 1 and between, each pass `exact_gate`
whole against both tables' exact first products; two runs of each give
the same bits, at F8 64 K1 equals its 8-band slices bit for bit, and with
fesc = 0 each equals the one-screen kernel on the reprocessed table bit
for bit (its chain, rescaled by 1·exp(−τ_V k), then adds exact zeros);
`generate(2²⁰)` of the model launches the escape K1 16 times, no other
kernel of K1's name, and no K2 or dense `simulate`.

The SFZH slice on the card (`csrc/sfzh.cu`, the lognormal × delta-Z
SFZH in one pass): `_sfzh` through the kernel equals its plain route
(`_mega_off`) bit for bit, SFZH and age marginal, at 1, 8, 32, 33, 1024,
32768, 32769, 34816 and 65536 rows (each side of torch's scan-width
rule; one row takes the plain route), with rows at the prior's and the
grid's edges and a history with no mass on the grid; `generate(2²⁰)` at
the north-star width launches it 16 times, and a `_mega_off` simulator's
`generate` none.

K1 and K2 share one core (`csrc/sed_tile.cuh`). K1's one launch over a
batch of sub-chunks is held to the same bound with per-sub-chunk windows
at unaligned columns, ragged tiles and B = 1, 3, 13; both kernels at 128
bands; K2 for rows at one redshift, sorted, unsorted and spanning the
whole knot table (several passes of knots), and on the headline's
384 × 1006 table; and two runs of each give the same bits.
"""

import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu_torch.ops import fused_sed as k1
from synference_tpu_torch.ops import photometry_kernel as pk
from synference_tpu_torch.ops import sfzh as sfzh_op

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
_CODES = ["F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W"]
_CENTERS = [9000., 11500., 15000., 20000., 27700., 35600., 44400.]
_WIDTHS = [2000., 2600., 3300., 4600., 7000., 7800., 10200.]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K1 has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sim(device, order, fesc=0.0, variant="auto"):
    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    filters = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                            zip(_CODES, _CENTERS, _WIDTHS)])
    return tt.BatchSEDSimulator(grid, filters, PNAMES,
                                emission=tt.EmissionConfig(fesc=fesc),
                                photometry_interp_order=order,
                                photometry_variant=variant, device=device)


def _sorted_theta(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(7.5, 11, n), np.sort(rng.uniform(0.05, 8, n)),
        rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
        rng.uniform(-3.9, -1.6, n), rng.uniform(0, 2, n),
    ]).astype(np.float32)


def _rel(out, ref):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)
    return rel[ref > 1e-3 * ref.max(axis=1, keepdims=True)]


def _assert_close(out, ref):
    rel = _rel(out, ref)
    assert np.quantile(rel, 0.99) < 1e-5, np.quantile(rel, 0.99)
    assert rel.max() < 2e-3, rel.max()


def _assert_exact(out, exact, plain):
    """The kernel against the exact first product: `exact_gate`'s p99 <
    1e-5 and max < 1e-3. Its third part, a share of fluxes off by more than
    1e-5 at most twice the fp32 plain version's plus 1e-4, is held at the
    main-path shapes (`chip_smoke.py`, 65536 rows): at these shapes, a few
    hundred to a few thousand fluxes, 1e-4 is less than one flux and a
    single bf16 flip decides it."""
    g = k1.exact_gate(out, exact, plain)
    assert g["p99"] < 1e-5 and g["max"] < 1e-3, g
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("order,fesc", [(1, 0.0), (3, 0.0), (3, 0.25)])
def test_kernel_matches_plain(cuda, order, fesc):
    sim = _sim(cuda, order, fesc)
    theta, sub, kc, w_cols, k0, l0 = sim._plan_windows(
        _sorted_theta(1536, seed=order), 128)
    before = k1.fused_window_photometry.launches
    for _, _, _, a in sim._window_calls(theta, sub, w_cols, kc, k0, l0):
        out = k1.fused_window_photometry(**a)
        torch.cuda.synchronize()
        ref = k1.fused_window_photometry_reference(**a)
        _assert_close(out, ref)
        _assert_exact(out, k1.fused_window_photometry_exact(**a), ref)
    assert k1.fused_window_photometry.launches == before + len(k0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_bound_rejects_lower_precision_first_product(cuda, precision):
    """The bound has the power to catch a first product computed in TF32 or
    from bf16 inputs: the plain version doing so misses its p99 limit."""
    sim = _sim(cuda, 3)
    theta, sub, kc, w_cols, k0, l0 = sim._plan_windows(
        _sorted_theta(1536, seed=3), 128)
    rels = []
    for _, _, _, a in sim._window_calls(theta, sub, w_cols, kc, k0, l0):
        ref = k1.fused_window_photometry_reference(**a)
        if precision == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            low = k1.fused_window_photometry_reference(**a)
            torch.backends.cuda.matmul.allow_tf32 = False
        else:
            low = k1.fused_window_photometry_reference(**dict(
                a, sfzh=a["sfzh"].bfloat16().float(),
                sed_w=a["sed_w"].bfloat16().float()))
        rels.append(_rel(low, ref))
        exact = k1.fused_window_photometry_exact(**a)
        assert k1.exact_gate(low, exact, ref)["p99"] > 1e-5
    p99 = np.quantile(np.concatenate(rels), 0.99)
    assert p99 > 1e-5, p99


@pytest.mark.cuda
def test_window_engine_fused_matches_staged(cuda):
    sim = _sim(cuda, 3)
    theta = _sorted_theta(1536, seed=5)
    fused = sim.photometry_zsorted_device(theta, sub_chunk=128, fused=True)
    staged = sim.photometry_zsorted_device(theta, sub_chunk=128, fused=False)
    _assert_close(fused, staged)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [45, 36])
def test_ragged_shapes(cuda, c):
    """Batch, cell and window sizes that are not multiples of the tiles:
    45 cells (a padded A copy) and 36 (sfzh read as it is, a last ring stage
    of 4 cells)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, w, kc, f8 = 77, 131, 6, 8
    a = dict(
        sfzh=torch.rand(b, c, generator=g, device=cuda) * 1e9,
        s_rel=torch.rand(b, generator=g, device=cuda) * (kc - 1) * 3,
        tau_v=torch.rand(b, generator=g, device=cuda),
        scale=torch.rand(b, generator=g, device=cuda) + 0.5,
        sed_w=torch.rand(c, w + 9, generator=g, device=cuda)[:, 4:4 + w] * 1e20,
        curve_w=torch.rand(w, generator=g, device=cuda),
        knot_w=torch.rand(w, kc * f8, generator=g, device=cuda).to(
            torch.bfloat16),
        den_w=torch.rand(kc, f8, generator=g, device=cuda) + 1.0,
        kc=kc, delta=3, f8=f8)
    out = k1.fused_window_photometry(**a)
    torch.cuda.synchronize()
    ref = k1.fused_window_photometry_reference(**a)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_window_photometry_exact(**a), ref)


def _unsorted_theta(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.column_stack([
        rng.uniform(7.5, 11, n), rng.uniform(0.05, 8, n),
        rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
        rng.uniform(-3.9, -1.6, n), rng.uniform(0, 2, n),
    ]).astype(np.float32))


def _k2_args(sim, theta):
    """K2's arguments as `_photometry_mega` passes them."""
    params = sim.theta_dict(theta.to(sim.device))
    sfzh, _ = sim._sfzh(params)
    z = params["redshift"]
    return (sfzh, sim._shift_of_z(z), params["tau_v"], sim._scale_of_z(z),
            sim._mega_tables, sim._n_knots, sim._knot_delta, sim._f8)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 13, 777])
@pytest.mark.parametrize("order,fesc", [(1, 0.0), (3, 0.0), (3, 0.25)])
def test_k2_matches_plain(cuda, b, order, fesc):
    sim = _sim(cuda, order, fesc)
    assert sim._mega_supported()
    args = _k2_args(sim, _unsorted_theta(b, seed=b))
    kw = dict(order=order, fesc=fesc)
    before = k1.fused_sed_photometry.launches
    out = k1.fused_sed_photometry(*args, **kw)
    torch.cuda.synchronize()
    assert k1.fused_sed_photometry.launches == before + 1
    ref = k1.fused_sed_photometry_reference(*args, **kw)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_sed_photometry_reference(
        *args, **kw, first_product=k1.exact_first_product), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_k2_bound_rejects_lower_precision_first_product(cuda, precision):
    sim = _sim(cuda, 3)
    sfzh, s, tau_v, scale, tables, n_knots, delta, f8 = _k2_args(
        sim, _unsorted_theta(777, seed=11))
    rest = (n_knots, delta, f8)
    ref = k1.fused_sed_photometry_reference(sfzh, s, tau_v, scale, tables,
                                            *rest)
    if precision == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        low = k1.fused_sed_photometry_reference(sfzh, s, tau_v, scale,
                                                tables, *rest)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        low = k1.fused_sed_photometry_reference(
            sfzh.bfloat16().float(), s, tau_v, scale,
            dict(tables, sed=tables["sed"].bfloat16().float()), *rest)
    p99 = np.quantile(_rel(low, ref), 0.99)
    assert p99 > 1e-5, p99
    exact = k1.fused_sed_photometry_reference(
        sfzh, s, tau_v, scale, tables, *rest,
        first_product=k1.exact_first_product)
    assert k1.exact_gate(low, exact, ref)["p99"] > 1e-5


@pytest.mark.cuda
def test_k2_reads_the_spectra_it_is_given(cuda):
    """The kernels' B operand follows "sed": the simulator's tables give the
    same bits on every call, a table written in place and another table in
    a copied dict are read as they are now, never as an earlier operand."""
    sim = _sim(cuda, 3)
    sfzh, s, tau_v, scale, tables, *rest = _k2_args(
        sim, _unsorted_theta(777, seed=13))
    first = k1.fused_sed_photometry(sfzh, s, tau_v, scale, tables, *rest)
    assert torch.equal(
        first, k1.fused_sed_photometry(sfzh, s, tau_v, scale, tables, *rest))
    other = dict(tables, sed=tables["sed"] * 0.5)
    out = k1.fused_sed_photometry(sfzh, s, tau_v, scale, other, *rest)
    _assert_close(out, k1.fused_sed_photometry_reference(
        sfzh, s, tau_v, scale, other, *rest))
    sed = tables["sed"].clone()
    tables = dict(tables, sed=sed)
    k1.fused_sed_photometry(sfzh, s, tau_v, scale, tables, *rest)
    sed.mul_(0.5)  # in place, after a launch made its operand
    out = k1.fused_sed_photometry(sfzh, s, tau_v, scale, tables, *rest)
    torch.cuda.synchronize()
    _assert_close(out, k1.fused_sed_photometry_reference(
        sfzh, s, tau_v, scale, tables, *rest))
    assert not torch.equal(out, first)


@pytest.mark.cuda
def test_dense_photometry_launches_k2_once(cuda):
    sim = _sim(cuda, 3)
    assert sim.photometry_backend == "pallas"
    before = k1.fused_sed_photometry.launches
    out = sim.photometry(_unsorted_theta(2000, seed=12))
    torch.cuda.synchronize()
    assert k1.fused_sed_photometry.launches == before + 1
    assert out.shape == (2000, len(_CODES))
    assert bool(torch.isfinite(out).all()) and bool((out >= 0).all())


def _tables(device, c, n_l, n_knots, f8, seed, col0=3):
    """Random kernel tables on the card; "sed" rows start `col0` floats into
    a wider buffer (unaligned for col0 % 4 != 0)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return dict(
        sed=torch.rand(c, n_l + 8, generator=g, device=device)[
            :, col0:col0 + n_l] * 1e20,
        curve=torch.rand(n_l, generator=g, device=device),
        knot=torch.rand(n_l, n_knots * f8, generator=g, device=device).to(
            torch.bfloat16),
        den=torch.rand(n_knots, f8, generator=g, device=device) + 1.0)


def _rows(device, b, c, s, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return dict(sfzh=torch.rand(b, c, generator=g, device=device) * 1e9,
                s=torch.as_tensor(s, dtype=torch.float32, device=device),
                tau_v=torch.rand(b, generator=g, device=device),
                scale=torch.rand(b, generator=g, device=device) + 0.5)


def _grouped_args(device, b, sub, f8=8, seed=0):
    """Grouped K1 over ceil(b/sub) sub-chunks, each with its own unaligned
    window (k0, l0) and shifts inside it."""
    c, n_l, n_knots, kc, w, delta = 45, 300, 12, 6, 131, 3
    n_sub = -(-b // sub)
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, n_knots - kc + 1, n_sub)
    l0 = rng.integers(0, n_l - w + 1, n_sub)
    s = (np.repeat(k0, sub)[:b] * delta
         + rng.uniform(0, (kc - 1) * delta, b))
    return dict(**_rows(device, b, c, s, seed),
                tables=_tables(device, c, n_l, n_knots, f8, seed), k0=k0,
                l0=l0, sub=sub, w_cols=w, kc=kc, delta=delta, f8=f8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sub", [(1, 1), (3, 2), (13, 5), (700, 200)])
@pytest.mark.parametrize("order", [1, 3])
def test_grouped_k1_matches_plain(cuda, b, sub, order):
    """One launch over every sub-chunk, per-sub-chunk windows at unaligned
    columns, ragged last tiles and sub-chunks."""
    a = _grouped_args(cuda, b, sub, seed=b)
    assert np.any(a["l0"] % 4) or b < 13
    before = k1.fused_window_photometry.launches
    out = k1.fused_window_photometry_grouped(**a, order=order)
    torch.cuda.synchronize()
    assert k1.fused_window_photometry.launches == before + 1
    ref = k1.fused_window_photometry_grouped_reference(**a, order=order)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_window_photometry_grouped_reference(
        **a, order=order, first_product=k1.exact_first_product), ref)


@pytest.mark.cuda
def test_window_engine_launches_k1_once_per_batch(cuda):
    """The fused window body is one K1 launch per batch, also with a
    sub-chunk that is not a multiple of the 128-row tile."""
    sim = _sim(cuda, 3)
    theta = _sorted_theta(1536, seed=6)
    before = k1.fused_window_photometry.launches
    fused = sim.photometry_zsorted_device(theta, sub_chunk=96, fused=True)
    torch.cuda.synchronize()
    assert k1.fused_window_photometry.launches == before + 1
    _assert_close(fused, sim.photometry_zsorted_device(theta, sub_chunk=96,
                                                       fused=False))


@pytest.mark.cuda
def test_kernels_at_f8_128(cuda):
    """128 bands: K1 (grouped) and K2 walk 16 band groups."""
    a = _grouped_args(cuda, 300, 100, f8=128, seed=4)
    out = k1.fused_window_photometry_grouped(**a)
    torch.cuda.synchronize()
    ref = k1.fused_window_photometry_grouped_reference(**a)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_window_photometry_grouped_reference(
        **a, first_product=k1.exact_first_product), ref)
    n_knots, delta = 12, 3
    tables = _tables(cuda, 45, 300, n_knots, 128, seed=5)
    rng = np.random.default_rng(5)
    r = _rows(cuda, 300, 45, rng.uniform(0, (n_knots - 1) * delta, 300), 5)
    args = (r["sfzh"], r["s"], r["tau_v"], r["scale"], tables, n_knots,
            delta, 128)
    out = k1.fused_sed_photometry(*args)
    torch.cuda.synchronize()
    ref = k1.fused_sed_photometry_reference(*args)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_sed_photometry_reference(
        *args, first_product=k1.exact_first_product), ref)


def _spans(kind, b, n_knots, delta, rng):
    top = (n_knots - 1) * delta
    if kind == "single-z":
        return np.full(b, 0.37 * top)
    if kind == "sorted":
        return np.sort(rng.uniform(0, top, b))
    if kind == "unsorted":
        return rng.uniform(0, top, b)
    # whole-table: every block's galaxies reach from the first knot to the
    # last (b = 13 fits one block)
    return np.linspace(-1.0, top + 1.0, b)


# W = 1351 columns is 11 chunks of 128: a partial last super-chunk for
# clusters of 2, 3 and 8 blocks
_BANDS_W = 1351


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "whole-table"])
@pytest.mark.parametrize("f8", [16, 24, 64, 128])
def test_band_clusters_match_plain_and_8_band_slices(cuda, f8, kind):
    """K1 (grouped) and K2 at F8 > 8 run in clusters of `cluster_size(F8)`
    band groups that share each galaxy tile's first product: within the
    plain bound of their plain versions, and bit for bit the kernel
    launched on each 8-band slice of the tables, for rows in knot order,
    out of it and spanning the whole table (several passes of knots)."""
    assert 11 * 128 - 128 < _BANDS_W < 11 * 128
    c, delta, b = 45, 3, 300
    rng = np.random.default_rng(f8)
    # K1: 3 sub-chunks of 100 rows, each with its own window of 12 knots
    # (3 passes for whole-table spans) at an unaligned column
    n_knots, kc, sub = 20, 12, 100
    k0 = rng.integers(0, n_knots - kc + 1, 3)
    l0 = np.array([0, 77, 1500 - _BANDS_W])
    s = np.repeat(k0, sub) * delta + np.concatenate(
        [_spans(kind, sub, kc, delta, rng) for _ in k0])
    a = dict(**_rows(cuda, b, c, s, f8),
             tables=_tables(cuda, c, 1500, n_knots, f8, seed=f8), k0=k0,
             l0=l0, sub=sub, w_cols=_BANDS_W, kc=kc, delta=delta, f8=f8)
    before = k1.fused_window_photometry.launches
    out = k1.fused_window_photometry_grouped(**a)
    torch.cuda.synchronize()
    assert k1.fused_window_photometry.launches == before + 1
    ref = k1.fused_window_photometry_grouped_reference(**a)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_window_photometry_grouped_reference(
        **a, first_product=k1.exact_first_product), ref)
    slices = torch.cat([k1.fused_window_photometry_grouped(
        **dict(a, tables=k1.band_group_tables(a["tables"], g, n_knots),
               f8=8))
        for g in range(f8 // 8)], dim=1)
    assert torch.equal(out, slices)
    # K2: the whole 1351-column table of 40 knots
    n_knots = 40
    tables = _tables(cuda, c, _BANDS_W, n_knots, f8, seed=f8 + 1)
    r = _rows(cuda, b, c, _spans(kind, b, n_knots, delta, rng), f8 + 1)
    args = (r["sfzh"], r["s"], r["tau_v"], r["scale"])
    rest = (n_knots, delta)
    out = k1.fused_sed_photometry(*args, tables, *rest, f8)
    torch.cuda.synchronize()
    ref = k1.fused_sed_photometry_reference(*args, tables, *rest, f8)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_sed_photometry_reference(
        *args, tables, *rest, f8, first_product=k1.exact_first_product), ref)
    slices = torch.cat([k1.fused_sed_photometry(
        *args, k1.band_group_tables(tables, g, n_knots), *rest, 8)
        for g in range(f8 // 8)], dim=1)
    assert torch.equal(out, slices)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b", [("single-z", 777), ("sorted", 777),
                                    ("unsorted", 777), ("whole-table", 13),
                                    ("whole-table", 3)])
def test_k2_knot_spans(cuda, kind, b):
    """K2 is right for every span of knots a block's rows can cover: one
    pass of 8 knots or many."""
    n_knots, delta, f8, c = 40, 3, 8, 45
    rng = np.random.default_rng(b)
    tables = _tables(cuda, c, 300, n_knots, f8, seed=b)
    r = _rows(cuda, b, c, _spans(kind, b, n_knots, delta, rng), b)
    args = (r["sfzh"], r["s"], r["tau_v"], r["scale"], tables, n_knots,
            delta, f8)
    out = k1.fused_sed_photometry(*args)
    torch.cuda.synchronize()
    ref = k1.fused_sed_photometry_reference(*args)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_sed_photometry_reference(
        *args, first_product=k1.exact_first_product), ref)


@pytest.mark.cuda
def test_k2_headline_rows(cuda):
    """The headline's table shape: 384 cells × 1006 columns (rows of 1006
    floats, not 16-byte aligned), 162 knots of 8 bands."""
    n_knots, delta, f8, c, n_l = 162, 4, 8, 384, 1006
    g = torch.Generator(device=cuda).manual_seed(9)
    tables = _tables(cuda, c, n_l, n_knots, f8, seed=9)
    tables["sed"] = torch.rand(c, n_l, generator=g, device=cuda) * 1e20
    rng = np.random.default_rng(9)
    r = _rows(cuda, 1000, c, rng.uniform(0, 640, 1000), 9)
    args = (r["sfzh"], r["s"], r["tau_v"], r["scale"], tables, n_knots,
            delta, f8)
    out = k1.fused_sed_photometry(*args)
    torch.cuda.synchronize()
    ref = k1.fused_sed_photometry_reference(*args)
    _assert_close(out, ref)
    _assert_exact(out, k1.fused_sed_photometry_reference(
        *args, first_product=k1.exact_first_product), ref)


@pytest.mark.cuda
def test_kernels_bitwise_deterministic(cuda):
    """No atomics and no split sums: two runs give the same bits."""
    a = _grouped_args(cuda, 700, 200, seed=2)
    assert torch.equal(k1.fused_window_photometry_grouped(**a),
                       k1.fused_window_photometry_grouped(**a))
    sim = _sim(cuda, 3)
    args = _k2_args(sim, _unsorted_theta(2000, seed=3))
    assert torch.equal(k1.fused_sed_photometry(*args),
                       k1.fused_sed_photometry(*args))
    for case in (777, "ragged-l", "wide-slab"):
        k3 = _k3_case(cuda, case)
        assert torch.equal(pk.shift_photometry_num(*k3),
                           pk.shift_photometry_num(*k3))


def _k3_case(device, case):
    """(fw, table, s4) of a K3 case: an int is a batch of the simulator's
    own flux rows, a name a synthetic shape."""
    if isinstance(case, int):
        sim = _sim(device, 3, variant="roll")
        theta = _unsorted_theta(case, seed=case).to(device)
        res = sim.simulate(theta, want_spectra=True)
        s4 = pk.shift_decompose(sim._shift_of_z(theta[:, 1]), sim._max_shift)
        return res["fnu_njy"] * sim._wlam, sim._subshift_table, s4
    # b, L, table columns, F8; L = 1003 and 515 end inside a flux chunk
    b, n_l, n_cols, f8 = {
        "f8-16": (777, 1000, 1300, 16), "f8-128": (300, 515, 700, 128),
        "ragged-l": (1000, 1003, 1400, 8), "no-shift": (500, 512, 512, 8),
        "one-s4": (2000, 1024, 1324, 8), "each-rs": (8, 1024, 1324, 8),
        "row-slice": (777, 1024, 1324, 8), "col-slice": (777, 1020, 1324, 8),
        "wide-slab": (300, 10000, 13000, 8), "int32-keys": (900, 600, 5600, 8),
    }[case]
    g = torch.Generator(device=device).manual_seed(len(case))
    fw = torch.rand(2 * b, n_l + 4, generator=g, device=device)
    table = torch.rand(pk.N_SUB, f8, n_cols, generator=g, device=device)
    s4 = torch.randint(0, pk.N_SUB * (n_cols - n_l) + 8, (b,), generator=g,
                       device=device, dtype=torch.int32)
    if case == "one-s4":
        s4 = torch.full_like(s4, 1001)
    if case == "each-rs":
        s4 = 800 + torch.arange(8, dtype=torch.int32, device=device)
    if case == "row-slice":  # every other row: 16-byte copies, wider stride
        return fw[::2, :n_l], table, s4
    if case == "col-slice":  # rows start 4 bytes off: the 4-byte copies
        return fw[:b, 1:n_l + 1], table, s4
    return fw[:b, :n_l].contiguous(), table, s4


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    1, 3, 13, 777, "f8-16", "f8-128", "ragged-l", "no-shift", "one-s4",
    "each-rs", "row-slice", "col-slice", "wide-slab", "int32-keys"])
def test_k3_matches_plain(cuda, case):
    fw, table, s4 = _k3_case(cuda, case)
    before = pk.shift_photometry_num.launches
    out = pk.shift_photometry_num(fw, table, s4)
    torch.cuda.synchronize()
    assert pk.shift_photometry_num.launches == before + 1
    ref = pk.shift_photometry_num_reference(fw, table, s4)
    n_f = len(_CODES) if isinstance(case, int) else table.shape[1]
    assert _rel(out[:, :n_f], ref[:, :n_f]).max() < 1e-5
    # a view and its contiguous copy (4-byte or 16-byte copies, any row
    # stride) give the same bits
    assert torch.equal(out, pk.shift_photometry_num(fw.contiguous(), table,
                                                    s4))


@pytest.mark.cuda
def test_k3_rows_do_not_depend_on_the_batch(cuda):
    """A row alone, in a sorted batch or in an unsorted one: the same bits,
    in the caller's row order."""
    fw, table, s4 = _k3_case(cuda, "ragged-l")
    out = pk.shift_photometry_num(fw, table, s4)
    perm = torch.argsort(s4.long(), stable=True)
    assert torch.equal(pk.shift_photometry_num(fw[perm], table,
                                               s4[perm].contiguous()),
                       out[perm])
    for b in (0, 499, 999):
        assert torch.equal(pk.shift_photometry_num(
            fw[b:b + 1], table, s4[b:b + 1]), out[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("n_m", [1, 301, 4095, 4096, 20000])
def test_k3_row_keys_match_plain(cuda, n_m):
    g = torch.Generator(device=cuda).manual_seed(n_m)
    s4 = torch.randint(-40, pk.N_SUB * n_m + 400, (5000,), generator=g,
                       device=cuda, dtype=torch.int32)
    keys = pk._shift_row_keys(s4, n_m)
    ref = pk.shift_row_keys_reference(s4, n_m)
    assert keys.dtype == ref.dtype and torch.equal(keys, ref)
    assert torch.equal(pk.shift_row_keys_reference(s4.cpu(), n_m), ref.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["roll", "bank"])
def test_exact_spectra_launch_k3_once(cuda, variant):
    sim = _sim(cuda, 3, variant=variant)
    before = pk.shift_photometry_num.launches
    out = sim.simulate(_unsorted_theta(500, seed=13), want_spectra=True)
    torch.cuda.synchronize()
    assert pk.shift_photometry_num.launches == before + 1
    assert bool(torch.isfinite(out["photometry_njy"]).all())


# -- the NPE path on the card: plain PyTorch, held to the CPU -----------------
# fp32 with TF32 off on both sides; cuBLAS and the CPU sum in another order:
# log_prob and samples to 1e-4, one optimiser step to 1e-5 of a weight.
_NSF = dict(hidden_features=16, num_transforms=3, num_bins=4,
            support_low=(-2.0, -2.0), support_high=(2.0, 2.0))


def _flow_on_both(cuda, k=3, seed=0):
    from synference_tpu_torch.flows import base

    cpu_flow = base.build_flow("nsf", 2, 4, device="cpu", **_NSF)
    card_flow = base.build_flow("nsf", 2, 4, device=cuda, **_NSF)
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-1.5, 1.5, (512, 2)).astype(np.float32)
    x = rng.standard_normal((512, 4)).astype(np.float32)
    params = cpu_flow.init(torch.Generator().manual_seed(seed), theta, x,
                           n_members=k)
    for block in params["flow"]["blocks"]:  # leave the identity
        block[-1]["w"] = 0.1 * torch.as_tensor(
            rng.standard_normal(tuple(block[-1]["w"].shape)),
            dtype=torch.float32)
    on_card = base.params_from_numpy(base.params_to_numpy(params), cuda)
    return cpu_flow, card_flow, params, on_card, theta, x


@pytest.mark.cuda
def test_flow_log_prob_and_samples_match_cpu(cuda):
    cpu_flow, card_flow, params, on_card, theta, x = _flow_on_both(cuda)
    with torch.no_grad():
        lp = card_flow.log_prob(on_card, theta, x)
        ref = cpu_flow.log_prob(params, theta, x)
        assert lp.device.type == "cuda" and lp.shape == (3, 512)
        np.testing.assert_allclose(lp.cpu().numpy(), ref.numpy(), atol=1e-4)
        base = np.random.default_rng(1).standard_normal(
            (3, 16, 32, 2)).astype(np.float32)
        s = card_flow.sample_batch(on_card, x[:16], 32, base=base)
        ref = cpu_flow.sample_batch(params, x[:16], 32, base=base)
        np.testing.assert_allclose(s.cpu().numpy(), ref.numpy(), atol=1e-4)
        own = card_flow.sample_batch(
            on_card, x[:16], 32, torch.Generator(device=cuda).manual_seed(0))
    assert own.device.type == "cuda"
    assert (own > -2.0).all() and (own < 2.0).all()


@pytest.mark.cuda
def test_posterior_sample_batch_matches_cpu(cuda):
    cpu_flow, card_flow, params, on_card, theta, x = _flow_on_both(cuda)
    base = np.random.default_rng(2).standard_normal(
        (3, 8, 4 * 4, 2)).astype(np.float32)
    out = []
    for flow, p, dev in ((cpu_flow, params, "cpu"),
                         (card_flow, on_card, cuda)):
        post = tt.EnsemblePosterior(
            flow, p, tt.BoxUniform((-1.0, -1.0), (1.0, 1.0), device=dev))
        with torch.no_grad():
            out.append(post.sample_batch_with_acceptance(x[:8], 10,
                                                         base=base))
    np.testing.assert_allclose(out[1][0].cpu().numpy(), out[0][0].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out[1][1].cpu().numpy(), out[0][1].numpy(),
                               atol=1e-7)


@pytest.mark.cuda
def test_single_metrics_run_on_the_card_and_match_cpu(cuda):
    """numpy in, `device=` says where: counts exact, float32 sums to 1e-6."""
    from synference_tpu_torch import diagnostics as td

    rng = np.random.default_rng(5)
    truths = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    samples = (truths[:, None, :] + 0.3 * rng.standard_normal(
        (40, 64, 3))).astype(np.float32)
    u = rng.uniform(size=truths.shape).astype(np.float32)
    pit = td.pit_values(samples, truths, device=cuda)
    assert pit.device.type == "cuda"
    np.testing.assert_array_equal(
        pit.cpu().numpy(),
        td.pit_values(samples, truths, device="cpu").numpy())
    ranks = td.sbc_ranks(samples, truths, device=cuda)
    assert ranks.device.type == "cuda"
    np.testing.assert_array_equal(
        ranks.cpu().numpy(),
        td.sbc_ranks(samples, truths, device="cpu").numpy())
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.pit_ks_statistic(pit, device=cuda),
                               td.pit_ks_statistic(pit, device="cpu"), **tol)
    np.testing.assert_allclose(
        td.tarp_coverage(samples, truths, uniforms=u, device=cuda)[1],
        td.tarp_coverage(samples, truths, uniforms=u, device="cpu")[1], **tol)
    own = td.tarp_deviation(samples, truths, device=cuda)  # card generator
    assert 0.0 <= own <= 0.5
    np.testing.assert_allclose(
        td.expected_coverage(samples, truths, device=cuda),
        td.expected_coverage(samples, truths, device="cpu"), **tol)
    on_card = td.point_metrics(samples, truths, device=cuda)
    for name, ref in td.point_metrics(samples, truths, device="cpu").items():
        np.testing.assert_allclose(on_card[name], ref, err_msg=name,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_training_step_matches_cpu_and_reads_nothing_back(cuda):
    from synference_tpu_torch.train import (TrainConfig, _EnsembleState,
                                            _no_host_sync, train_ensemble)

    cpu_flow, card_flow, params, on_card, theta, x = _flow_on_both(cuda)
    cfg = TrainConfig(clip_max_norm=0.5, weight_decay=0.01)
    lrs = [1e-3, 3e-3, 7e-4]
    rows = np.random.default_rng(3).integers(0, 512, (3, 128))
    states = []
    for flow, p, dev in ((cpu_flow, params, "cpu"),
                         (card_flow, on_card, cuda)):
        state = _EnsembleState(p, torch.as_tensor(lrs, device=dev), cfg)
        before = state.flat.clone()
        tb = torch.as_tensor(theta[rows], device=dev)
        xb = torch.as_tensor(x[rows], device=dev)
        with _no_host_sync(torch.device(dev)):
            state.train_step(
                lambda q, t, c, f=flow: -f.log_prob(q, t, c).mean(dim=-1),
                tb, xb)
        assert float((state.flat - before).abs().max()) > 1e-4  # it moved
        states.append(state)
    np.testing.assert_allclose(states[1].flat.cpu().numpy(),
                               states[0].flat.numpy(), atol=1e-5)

    # a loss that reads a value back inside an epoch raises on the card
    def reads_back(q, t, c):
        loss = -card_flow.log_prob(q, t, c).mean(dim=-1)
        float(loss.detach().sum())
        return loss

    with pytest.raises(RuntimeError, match="synchroniz"):
        train_ensemble(card_flow, theta, x,
                       config=TrainConfig(max_epochs=1, batch_size=128),
                       n_nets=2, loss_fn=reads_back)
    # an informative toy: θ follows the context with noise 0.1
    rng = np.random.default_rng(4)
    ctx = rng.uniform(-1, 1, (2000, 4)).astype(np.float32)
    toy = (ctx[:, :2] + 0.1 * rng.standard_normal((2000, 2))
           ).astype(np.float32)
    res = train_ensemble(card_flow, toy, ctx,
                         config=TrainConfig(max_epochs=6, batch_size=128,
                                            learning_rate=5e-3), n_nets=2)
    assert (res.val_losses[-1] < res.val_losses[0] - 0.5).all()
    assert (res.train_losses[-1] < res.train_losses[0] - 0.5).all()
    assert res.params["theta_mean"].device.type == "cuda"


# -- the quickstart slice on the card ----------------------------------------
def _ood_arrays():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 6))
    train = rng.standard_normal((3000, 6)) @ a
    test = rng.standard_normal((200, 6)) @ a
    test[:10] += 8.0
    return train, test


@pytest.mark.cuda
def test_ood_scores_card_vs_cpu(cuda):
    """The native OOD scores in float64 on the card against the CPU: 1e-9
    relative (ECOD, HBOS, kNN, PCA); Mahalanobis in float32, 1e-4; the vote
    equal."""
    from synference_tpu_torch import catalogue as cat

    train, test = _ood_arrays()
    for name, fn in cat._SCORE_METHODS.items():
        on_card = fn(torch.as_tensor(train, device=cuda),
                     torch.as_tensor(test, device=cuda))
        on_cpu = fn(torch.as_tensor(train), torch.as_tensor(test))
        for g, r in zip(on_card, on_cpu):
            assert g.device.type == "cuda" and g.dtype == torch.float64
            rel = (g.cpu() - r).abs() / r.abs().clamp(min=1e-300)
            assert float(rel.max()) < 1e-9, (name, float(rel.max()))
    _, d_card = cat.mahalanobis_ood(train, test, device=cuda)
    _, d_cpu = cat.mahalanobis_ood(train, test, device="cpu")
    assert np.abs(d_card - d_cpu).max() < 1e-4 * np.abs(d_cpu).max()
    methods = ("mahalanobis", "ecod", "hbos", "knn", "pca")
    flags, votes = cat.ood_vote(train, test, methods=methods, device=cuda)
    np.testing.assert_array_equal(
        votes, cat.ood_vote(train, test, methods=methods, device="cpu")[1])
    assert flags[:10].all()


@pytest.mark.cuda
def test_missing_photometry_card_vs_cpu(cuda):
    """χ² neighbours and the KDE draw with the draws passed in: 1e-5."""
    from synference_tpu_torch.catalogue import MissingPhotometryHandler

    rng = np.random.default_rng(1)
    lib = rng.lognormal(2.0, 1.0, (4000, 7)).astype(np.float32)
    obs = lib[:64] * rng.uniform(0.9, 1.1, (64, 7)).astype(np.float32)
    err = 0.05 * obs + 0.1
    miss = (rng.uniform(size=obs.shape) < 0.2).astype(np.float32)
    comp = rng.integers(0, 32, (64, 16))
    jitter = rng.standard_normal((64, 16, 7)).astype(np.float32)
    out = [MissingPhotometryHandler(lib, k_neighbors=32, nmc=16,
                                    device=dev).impute(
        None, obs, err, miss, return_errors=True, comp=comp, jitter=jitter)
        for dev in (cuda, "cpu")]
    for g, r in zip(*out):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_compute_supplementary_card_vs_cpu(cuda):
    """The 22 quantities on the card against the CPU from the same
    simulate() outputs: 1e-5 relative (magnitudes 1e-4 mag) where finite,
    and inf in the same places."""
    from synference_tpu_torch import supplementary as supp

    theta = torch.as_tensor(_unsorted_theta(512, seed=2))
    names = sorted(supp.SUPP_FUNCTIONS)
    cpu_sim, card_sim = _sim("cpu", 3), _sim(cuda, 3)
    out = cpu_sim.simulate(theta, want_spectra=True)
    ref = supp.compute_supplementary(names, cpu_sim, theta, out)
    got = supp.compute_supplementary(
        names, card_sim, theta.to(cuda), {k: v.to(cuda) for k, v in
                                          out.items()}).cpu()
    for j, name in enumerate(names):
        g, r = got[:, j], ref[:, j]
        # float32 overflows (n_ion; an EW over an empty continuum window of
        # this 1024-column grid) are inf on both, as in the JAX package
        assert torch.equal(torch.isinf(g), torch.isinf(r)), name
        fin = torch.isfinite(r)
        g, r = g[fin], r[fin]
        if name in ("m_uv", "app_m_uv", "u_minus_v", "v_minus_j"):
            assert float((g - r).abs().max()) < 1e-4, name
        elif r.numel():
            rel = (g - r).abs() / r.abs().clamp(min=1e-30)
            assert float(rel.max()) < 1e-5, (name, float(rel.max()))
    whole = card_sim.simulate(theta.to(cuda), want_spectra=True)
    assert torch.isfinite(supp.compute_supplementary(
        ["m_uv", "t50", "beta_uv"], card_sim, theta.to(cuda), whole)).all()


@pytest.mark.cuda
def test_resume_on_the_card_is_bitwise(cuda, tmp_path, monkeypatch):
    """A device-sampler run interrupted after two batches resumes to the
    bits of an uninterrupted run."""
    sim = _sim(cuda, 3)
    prior = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
             "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
             "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
    gen = tt.LibraryGenerator(sim, prior, unlog_keys=["log10_peak_age"],
                              device=cuda)
    args = dict(n=4 * 4096, batch_size=4096, seed=3, zsorted_fused=True)
    whole = gen.generate(**args)
    real, calls = np.savez, []

    class Stop(Exception):
        pass

    def savez(*a, **k):
        if len(calls) == 2:
            raise Stop
        calls.append(a[0])
        return real(*a, **k)

    prefix = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        m.setattr(np, "savez", savez)
        with pytest.raises(Stop):
            gen.generate(resume_path=prefix, **args)
    resumed = gen.generate(resume_path=prefix, **args)
    for key in ("parameters", "photometry"):
        np.testing.assert_array_equal(resumed[key], whole[key])


@pytest.mark.cuda
def test_copy_out_through_pinned_slots_is_bitwise(cuda, tmp_path):
    """Nine K1 batches of 1024 rows, n ragged, leave the card through the
    ring of pinned slots (each slot reused): the bits of a run that reads
    each part back with `.cpu()` (`resume_path`); a later call leaves the
    first call's arrays as they were; the pinned bytes the generator holds
    do not grow with n."""
    prior = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
             "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
             "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
    gen = tt.LibraryGenerator(_sim(cuda, 3), prior,
                              unlog_keys=["log10_peak_age"], device=cuda)
    args = dict(batch_size=1024, seed=5, zsorted_fused=True)
    n = 9 * 1024 - 300
    before = k1.fused_window_photometry.launches
    lib = gen.generate(n=n, **args)
    assert k1.fused_window_photometry.launches == before + 9
    ref = gen.generate(n=n, resume_path=str(tmp_path / "ck"), **args)
    kept = {}
    for key in ("parameters", "photometry"):
        assert lib[key].shape[1] == n
        np.testing.assert_array_equal(lib[key], ref[key])
        kept[key] = lib[key].copy()
    held = gen._pinned.nbytes
    assert held == 3 * 1024 * (8 + 6) * 4  # three slots of (F8 + P) columns
    for m in (2 * 1024 + 1, 20 * 1024 - 7):
        gen.generate(n=m, **args)
        assert gen._pinned.nbytes == held
    for key, val in kept.items():
        np.testing.assert_array_equal(lib[key], val)


@pytest.mark.cuda
def test_copy_out_spectra_through_pinned_slots_is_bitwise(cuda, tmp_path):
    """Four spectra batches of 128 rows, n ragged, through a pipeline:
    features and photometry leave the card through the pinned slots, with
    the bits of a run that reads each batch back (`resume_path`); the
    pinned bytes do not grow with n."""
    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=2048,
                                  lam_min=500.0, lam_max=1.0e5)
    filters = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                            zip(_CODES, _CENTERS, _WIDTHS)])
    sim = tt.BatchSEDSimulator(grid, filters, PNAMES,
                               emission=tt.EmissionConfig(), device=cuda)
    pipe = tt.SpectralFeaturePipeline(
        grid.lam, tt.generate_constant_r_grid(100, 6000, 40000),
        instrument_r=100, norm_window=(15000, 25000), device=cuda)
    prior = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 6.0),
             "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
             "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
    gen = tt.LibraryGenerator(sim, prior, unlog_keys=["log10_peak_age"],
                              spectral_pipeline=pipe, device=cuda)
    args = dict(batch_size=128, seed=7, want_spectra=True)
    n = 4 * 128 - 50
    lib = gen.generate(n=n, **args)
    ref = gen.generate(n=n, resume_path=str(tmp_path / "ck"), **args)
    for key in ("parameters", "photometry", "spectra"):
        assert lib[key].shape[1] == n
        np.testing.assert_array_equal(lib[key], ref[key])
    assert np.isfinite(lib["spectra"]).all()
    slots = gen._pinned.slots
    assert set(slots) == {"phot", "spec"}
    assert slots["spec"].shape == (3, 128, lib["spectra"].shape[0])
    assert slots["phot"].shape[:2] == (3, 128)
    held = gen._pinned.nbytes
    for m in (2 * 128 + 1, 9 * 128 - 7):
        gen.generate(n=m, **args)
        assert gen._pinned.nbytes == held


@pytest.mark.cuda
def test_default_generate_launches_k1_per_batch(cuda, monkeypatch):
    """At the defaults ("auto") a 2-batch and a 4-batch `generate` each
    launch K1 once per batch, whatever the run's length, and equal
    zsorted_fused=True bit for bit; a K1 that fails to launch fails the
    run."""
    from synference_tpu_torch import sed

    prior = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
             "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
             "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
    gen = tt.LibraryGenerator(_sim(cuda, 3), prior,
                              unlog_keys=["log10_peak_age"], device=cuda)
    # 16 sub-chunks over each run: narrower runs plan windows as wide as
    # the table and take the dense path
    runs = [(2, dict(n=2 * 8192, batch_size=8192, seed=1)),
            (4, dict(n=4 * 4096, batch_size=4096, seed=1))]
    for n_batches, args in runs:
        before = k1.fused_window_photometry.launches
        lib = gen.generate(**args)
        assert k1.fused_window_photometry.launches == before + n_batches
        forced = gen.generate(zsorted_fused=True, **args)
        for key in ("parameters", "photometry"):
            np.testing.assert_array_equal(lib[key], forced[key])

    def broken(**kw):
        raise RuntimeError("K1 failed to launch")

    monkeypatch.setattr(sed, "fused_window_photometry_grouped", broken)
    with pytest.raises(RuntimeError, match="K1 failed"):
        gen.generate(**runs[1][1])


@pytest.mark.cuda
def test_ragged_run_through_k1_equals_whole_batch_pad(cuda):
    """19,576 rows in batches of 8192 run 20 sub-chunks of 1024 (8192,
    8192 and a short 4096), not 3 whole batches: K1 launches once a batch,
    and θ and photometry equal those of the same rows padded to whole
    batches and sent through the same chunk function, bit for bit."""
    prior = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
             "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
             "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
    sim = _sim(cuda, 3)
    gen = tt.LibraryGenerator(sim, prior, unlog_keys=["log10_peak_age"],
                              device=cuda)
    args = dict(n=3 * 8192 - 5000, batch_size=8192, seed=9)
    before, pad = k1.fused_window_photometry.launches, gen.pad_rows
    lib = gen.generate(**args)
    assert k1.fused_window_photometry.launches == before + 3
    assert gen.pad_rows - pad == 20 * 1024 - args["n"]
    theta, sub, bs, kc, w_cols, _ = gen._draw_sorted(**args)
    assert kc < sim._n_knots and w_cols < sim._l_sup  # K1's window path
    theta = torch.cat([theta, theta[-1:].expand(3 * bs - len(theta), -1)])
    phot = torch.cat([sim.photometry_zsorted_device(
        theta[i:i + bs], sub_chunk=sub, row_offset=i, kc=kc, w_cols=w_cols,
        fused=True) for i in range(0, 3 * bs, bs)])[:args["n"]]
    np.testing.assert_array_equal(lib["parameters"].T,
                                  theta[:args["n"]].cpu().numpy())
    np.testing.assert_array_equal(lib["photometry"].T, phot.cpu().numpy())


# -- Charlot & Fall (2000) dust: the birth-cloud kernels ----------------------
_BC_NAMES = PNAMES + ("tau_v_bc",)
_BC_PRIOR = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
             "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
             "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0),
             "tau_v_bc": (0.0, 2.0)}


def _north_star_sim(device, n_bands, birth_cloud=True):
    """The north-star width (64 ages × 12 metallicities × 10⁴ λ, C 768;
    the first 25 ages, 300 cells, below 10⁷ yr) at `n_bands` tophat bands
    over 0.8-5 µm, with CF00 dust (τ_V and τ_BC, (λ/5500 Å)^−0.7) or the
    north-star's one Calzetti screen."""
    grid = tt.make_synthetic_grid(n_ages=64, n_mets=12, n_wav=10000,
                                  lam_min=150.0)
    centers = np.geomspace(8000.0, 48000.0, n_bands)
    filters = tt.FilterSet([tt.tophat_filter(f"B{i}", c, 0.15 * c)
                            for i, c in enumerate(centers)])
    if not birth_cloud:
        return tt.BatchSEDSimulator(grid, filters, PNAMES, device=device)
    return tt.BatchSEDSimulator(
        grid, filters, _BC_NAMES, device=device,
        emission=tt.EmissionConfig(
            reprocessed_types=("total",), dust_law="power_law",
            dust_params=(("slope", -0.7),), tau_v_bc_param="tau_v_bc"))


def _bc_theta(n, sort, seed=0):
    rng = np.random.default_rng(seed)
    theta = np.column_stack([rng.uniform(*_BC_PRIOR[k], n) for k in (
        "log10_mass", "redshift", "log10_peak_age", "tau",
        "log10_metallicity", "tau_v", "tau_v_bc")]).astype(np.float32)
    theta[:, 2] = 10.0 ** theta[:, 2]
    return theta[np.argsort(theta[:, 1])] if sort else theta


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [7, 63])
def test_birth_cloud_k1_passes_the_exact_gate(cuda, n_bands):
    """The birth-cloud K1 at the north-star width, lone (F8 8) and in
    clusters (F8 64), over 32768 z-sorted rows in sub-chunks of 1024:
    `exact_gate` whole (its share part too, at this size) against the two
    populations' exact first products; at F8 64 bit for bit the 8-band
    slices; with τ_BC = 0 bit for bit the one-screen kernel (exp(0) = 1
    leaves the FMA chain as it was)."""
    sim = _north_star_sim(cuda, n_bands)
    assert sim._n_young == 300 and sim._window_mega_supported()
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(
        _bc_theta(32768, sort=True, seed=n_bands), 1024)
    a = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
    before = k1.fused_window_photometry.launches
    out = k1.fused_window_photometry_grouped(**a)
    torch.cuda.synchronize()
    assert k1.fused_window_photometry.launches == before + 1
    exact = k1.fused_window_photometry_grouped_reference(
        **a, first_product=k1.exact_first_product)
    plain = k1.fused_window_photometry_grouped_reference(**a)
    gate = k1.exact_gate(out, exact, plain)
    assert gate["ok"], gate
    if a["f8"] > 8:
        n_knots = a["tables"]["den"].shape[0]
        slices = torch.cat([k1.fused_window_photometry_grouped(
            **dict(a, tables=k1.band_group_tables(a["tables"], g, n_knots),
                   f8=8)) for g in range(a["f8"] // 8)], dim=1)
        assert torch.equal(out, slices)
    zero = dict(a, tau_bc=torch.zeros_like(a["tau_bc"]))
    one = {k: v for k, v in a.items() if k not in ("tau_bc", "n_young")}
    assert torch.equal(k1.fused_window_photometry_grouped(**zero),
                       k1.fused_window_photometry_grouped(**one))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [7, 63])
def test_birth_cloud_k2_passes_the_exact_gate(cuda, n_bands):
    """`photometry()` of the CF00 model launches the birth-cloud K2 once,
    rows in any order: `exact_gate` whole against the exact first
    products, and with τ_BC = 0 the one-screen K2's bits."""
    sim = _north_star_sim(cuda, n_bands)
    assert sim._mega_supported()
    theta = torch.as_tensor(_bc_theta(16384, sort=False, seed=n_bands + 1),
                            device=cuda)
    before = k1.fused_sed_photometry.launches
    out = sim.photometry(theta)
    torch.cuda.synchronize()
    assert k1.fused_sed_photometry.launches == before + 1
    params = sim.theta_dict(theta)
    sfzh, _ = sim._sfzh(params)
    z = params["redshift"]
    args = (sfzh, sim._shift_of_z(z))
    kw = dict(scale=sim._scale_of_z(z), tables=sim._mega_tables,
              n_knots=sim._n_knots, delta=sim._knot_delta, f8=sim._f8,
              order=sim._interp_order,
              **sim._screens(params, params["tau_v"]))
    exact = k1.fused_sed_photometry_reference(
        *args, first_product=k1.exact_first_product, **kw)
    plain = k1.fused_sed_photometry_reference(*args, **kw)
    n_f = len(sim.filters)
    gate = k1.exact_gate(out, exact[:, :n_f], plain[:, :n_f])
    assert gate["ok"], gate
    zero = dict(kw, tau_bc=torch.zeros_like(kw["tau_bc"]))
    one = {k: v for k, v in kw.items() if k not in ("tau_bc", "n_young")}
    assert torch.equal(k1.fused_sed_photometry(*args, **zero),
                       k1.fused_sed_photometry(*args, **one))


@pytest.mark.cuda
def test_birth_cloud_generate_launches_k1_per_batch(cuda, monkeypatch):
    """`generate(2²⁰)` of the CF00 model at the defaults takes the device
    sampler and K1: 16 launches, no K2 and no dense `simulate`."""
    sim = _north_star_sim(cuda, 7)
    gen = tt.LibraryGenerator(sim, _BC_PRIOR, unlog_keys=["log10_peak_age"],
                              device=cuda)

    def dense(*args, **kw):
        raise AssertionError("the dense simulate ran")

    monkeypatch.setattr(sim, "simulate", dense)
    before = (k1.fused_window_photometry.launches,
              k1.fused_sed_photometry.launches)
    lib = gen.generate(n=2 ** 20, seed=3)
    assert (k1.fused_window_photometry.launches,
            k1.fused_sed_photometry.launches) == (before[0] + 16, before[1])
    assert lib["photometry"].shape == (7, 2 ** 20)
    assert np.isfinite(lib["photometry"]).all()


def _main_path_digests(device) -> dict:
    """sha256 of θ and photometry of the one-screen main paths at the
    north-star width: `generate(2²⁰)` at 7 bands (K1 lone) and
    `generate(10⁵)` at 63 bands (K1's clusters), and of the birth-cloud
    path (`generate(2²⁰)` at 7 bands), seed 0, at the defaults."""
    import hashlib

    out = {}
    for name, n_bands, n, bc in (("north-star", 7, 2 ** 20, False),
                                 ("paper63", 63, 100_000, False),
                                 ("cf00", 7, 2 ** 20, True)):
        prior = {k: v for k, v in _BC_PRIOR.items()
                 if bc or k != "tau_v_bc"}
        lib = tt.LibraryGenerator(
            _north_star_sim(device, n_bands, birth_cloud=bc), prior,
            unlog_keys=["log10_peak_age"], device=device).generate(
                n=n, seed=0)
        for key in ("parameters", "photometry"):
            out[f"{name}.{key}"] = hashlib.sha256(
                np.ascontiguousarray(lib[key]).tobytes()).hexdigest()
    return out


# `_main_path_digests` on an NVIDIA H100 80GB HBM3: the one-screen paths'
# before the birth-cloud kernels were added beside the one-screen kernels,
# the birth-cloud path's before the escape kernels were
_MAIN_PATH_DIGESTS = {
    "cf00.parameters":
        "7a0255ebd6c066ca34ec5fa45b2c4535be70ee2e5cdae21eaecb298c5023bf53",
    "cf00.photometry":
        "87d0a84f4396f20826608743937d35dd1aa270589cbfbfc768f9e428210d2aa3",
    "north-star.parameters":
        "6b6248a4b8878d34c2715befc323ea1a9e6f617a28c98c3b2c08897af5edcb5a",
    "north-star.photometry":
        "689b90b07c1276b352b0bad451ec3b3a9ff2664e47b3bd2fe16a2e5d8c8aeb90",
    "paper63.parameters":
        "1f0edec3d232ff2f51ec0917aa8a097e50d27bc29e0abea28a746f3bde259f07",
    "paper63.photometry":
        "2aa60b065247a21251121950f0750f0fe0a7953411c5f7621c38730135d029ed"}


@pytest.mark.cuda
def test_one_screen_main_paths_keep_their_bits(cuda):
    """The birth cloud and the escape fraction are kernels of their own:
    the one-screen main paths give the bits they gave before the birth
    cloud, and the birth-cloud path the bits it gave before the escape
    kernels (on the same card model)."""
    if torch.cuda.get_device_name(0) != "NVIDIA H100 80GB HBM3":
        pytest.skip("the recorded bits are an H100 80GB HBM3's")
    assert _main_path_digests(cuda) == _MAIN_PATH_DIGESTS


# -- the SFZH kernel ------------------------------------------------------------
def _sfzh_theta(n, seed=0):
    """North-star θ (`_BC_PRIOR`'s one-screen columns), then rows at the
    edges: τ at and below its clamp, the SFR peak past the oldest age and
    near it, z at both prior ends, log10 Z below and above the grid, and a
    history whose age weights sum to ≤ 1e-30 (the uniform row)."""
    theta = _bc_theta(n, sort=False, seed=seed)[:, :6].copy()
    edges = [(3, 0.0), (3, 5e-4), (2, 1.4e10), (2, 6.4e8), (1, 0.1),
             (1, 8.0), (4, -6.0), (4, 0.0), (2, -1e12)]
    for i, (col, v) in enumerate(edges[:n]):
        theta[i, col] = v
    if n > 8:
        theta[8, 3] = 1e-3  # the peak far past: no mass on the grid
    if n > 3:
        theta[3, 1] = 8.0  # max age 6.5e8 yr: the peak 1e7 yr after onset
    return theta


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 32, 33, 1024, 32768, 32769, 34816,
                                  65536])
def test_sfzh_kernel_keeps_the_plain_bits(cuda, rows):
    """`_sfzh` through the kernel equals the plain route bit for bit, with
    and without the age marginal, at row counts on each side of torch's
    scan-width rule (`scan_chunk`); one row takes the plain route."""
    sim = _north_star_sim(cuda, 7, birth_cloud=False)
    params = sim.theta_dict(torch.as_tensor(_sfzh_theta(rows), device=cuda))
    before = sfzh_op.lognormal_delta_sfzh.launches
    got, got_m = sim._sfzh(params)
    alone, none = sim._sfzh(params, marginal=False)
    assert sfzh_op.lognormal_delta_sfzh.launches == before + (
        0 if rows == 1 else 2)
    sim._mega_off = True
    want, want_m = sim._sfzh(params)
    assert sfzh_op.lognormal_delta_sfzh.launches == before + (
        0 if rows == 1 else 2)
    assert none is None and got.shape == (rows, 768)
    assert torch.equal(got, want) and torch.equal(alone, want)
    assert torch.equal(got_m, want_m)
    if rows > 8:  # the uniform row: its 64 ages alike
        ages = got[8].reshape(64, 12)
        assert torch.equal(ages, ages[:1].expand(64, 12))
        assert torch.equal(got_m[8], got_m[8, :1].expand(64))


@pytest.mark.cuda
def test_sfzh_kernel_launches_once_a_batch(cuda):
    """`generate(2²⁰)` at the north-star width launches the SFZH kernel
    once a batch (16) beside K1; with `_mega_off` no kernel runs."""
    sim = _north_star_sim(cuda, 7, birth_cloud=False)
    prior = {k: v for k, v in _BC_PRIOR.items() if k != "tau_v_bc"}
    gen = tt.LibraryGenerator(sim, prior, unlog_keys=["log10_peak_age"],
                              device=cuda)
    before = (sfzh_op.lognormal_delta_sfzh.launches,
              k1.fused_window_photometry.launches)
    gen.generate(n=2 ** 20, seed=0)
    assert (sfzh_op.lognormal_delta_sfzh.launches,
            k1.fused_window_photometry.launches) == (before[0] + 16,
                                                     before[1] + 16)
    sim._mega_off = True
    lib = gen.generate(n=2 ** 17, seed=0)
    assert (sfzh_op.lognormal_delta_sfzh.launches,
            k1.fused_window_photometry.launches) == (before[0] + 16,
                                                     before[1] + 16)
    assert np.isfinite(lib["photometry"]).all()


# -- Pacman emission: the escape kernels --------------------------------------
_ESC_NAMES = PNAMES + ("fesc",)
_ESC_PRIOR = dict({k: v for k, v in _BC_PRIOR.items() if k != "tau_v_bc"},
                  fesc=(0.0, 1.0))


def _pacman_sim(device, n_bands):
    """`_north_star_sim`'s grid and bands under Pacman emission: fesc a
    θ column, the incident light escaping, the total light behind the
    Calzetti screen."""
    grid = tt.make_synthetic_grid(n_ages=64, n_mets=12, n_wav=10000,
                                  lam_min=150.0)
    centers = np.geomspace(8000.0, 48000.0, n_bands)
    filters = tt.FilterSet([tt.tophat_filter(f"B{i}", c, 0.15 * c)
                            for i, c in enumerate(centers)])
    return tt.BatchSEDSimulator(
        grid, filters, _ESC_NAMES, device=device,
        emission=tt.EmissionConfig(incident_type="incident",
                                   reprocessed_types=("total",),
                                   fesc="fesc"))


def _esc_theta(n, sort, seed=0):
    """θ from the prior box, a tenth of the rows at fesc = 0 and a tenth
    at fesc = 1."""
    rng = np.random.default_rng(seed)
    theta = np.column_stack([rng.uniform(*_ESC_PRIOR[k], n) for k in (
        "log10_mass", "redshift", "log10_peak_age", "tau",
        "log10_metallicity", "tau_v", "fesc")]).astype(np.float32)
    theta[:, 2] = 10.0 ** theta[:, 2]
    ends = rng.permutation(n)[:n // 5]
    theta[ends[:n // 10], 6] = 0.0
    theta[ends[n // 10:], 6] = 1.0
    return theta[np.argsort(theta[:, 1])] if sort else theta


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [7, 63])
def test_pacman_k1_passes_the_exact_gate(cuda, n_bands):
    """The escape K1 at the north-star width, lone (F8 8) and in clusters
    (F8 64), over 32768 z-sorted rows in sub-chunks of 1024: `exact_gate`
    whole against both tables' exact first products; two runs bit for bit;
    at F8 64 bit for bit the 8-band slices; with fesc = 0 bit for bit the
    one-screen kernel on the reprocessed table."""
    sim = _pacman_sim(cuda, n_bands)
    assert sim._window_mega_supported()
    chunk, sub, kc, w_cols, k0, l0 = sim._plan_windows(
        _esc_theta(32768, sort=True, seed=n_bands), 1024)
    a = sim._window_grouped_args(chunk, sub, w_cols, kc, k0, l0)
    before = k1.fused_window_photometry.launches
    out = k1.fused_window_photometry_grouped(**a)
    torch.cuda.synchronize()
    assert k1.fused_window_photometry.launches == before + 1
    exact = k1.fused_window_photometry_grouped_reference(
        **a, first_product=k1.exact_first_product)
    plain = k1.fused_window_photometry_grouped_reference(**a)
    gate = k1.exact_gate(out, exact, plain)
    assert gate["ok"], gate
    assert torch.equal(out, k1.fused_window_photometry_grouped(**a))
    if a["f8"] > 8:
        n_knots = a["tables"]["den"].shape[0]
        slices = torch.cat([k1.fused_window_photometry_grouped(
            **dict(a, tables=k1.band_group_tables(a["tables"], g, n_knots),
                   f8=8)) for g in range(a["f8"] // 8)], dim=1)
        assert torch.equal(out, slices)
    zero = dict(a, fesc_row=torch.zeros_like(a["fesc_row"]))
    one = {k: v for k, v in a.items() if k != "fesc_row"}
    assert torch.equal(k1.fused_window_photometry_grouped(**zero),
                       k1.fused_window_photometry_grouped(**one))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [7, 63])
def test_pacman_k2_passes_the_exact_gate(cuda, n_bands):
    """`photometry()` of the Pacman model launches the escape K2 once,
    rows in any order: `exact_gate` whole against both tables' exact first
    products, two runs bit for bit, and with fesc = 0 the one-screen K2's
    bits."""
    sim = _pacman_sim(cuda, n_bands)
    assert sim._mega_supported()
    theta = torch.as_tensor(_esc_theta(16384, sort=False, seed=n_bands + 1),
                            device=cuda)
    before = k1.fused_sed_photometry.launches
    out = sim.photometry(theta)
    torch.cuda.synchronize()
    assert k1.fused_sed_photometry.launches == before + 1
    params = sim.theta_dict(theta)
    sfzh, _ = sim._sfzh(params)
    z = params["redshift"]
    args = (sfzh, sim._shift_of_z(z))
    kw = dict(scale=sim._scale_of_z(z), tables=sim._mega_tables,
              n_knots=sim._n_knots, delta=sim._knot_delta, f8=sim._f8,
              order=sim._interp_order,
              **sim._screens(params, params["tau_v"]))
    exact = k1.fused_sed_photometry_reference(
        *args, first_product=k1.exact_first_product, **kw)
    plain = k1.fused_sed_photometry_reference(*args, **kw)
    n_f = len(sim.filters)
    gate = k1.exact_gate(out, exact[:, :n_f], plain[:, :n_f])
    assert gate["ok"], gate
    assert torch.equal(out, sim.photometry(theta))
    zero = dict(kw, fesc_row=torch.zeros_like(kw["fesc_row"]))
    one = {k: v for k, v in kw.items() if k != "fesc_row"}
    assert torch.equal(k1.fused_sed_photometry(*args, **zero),
                       k1.fused_sed_photometry(*args, **one))


@pytest.mark.cuda
def test_pacman_generate_launches_the_escape_k1_per_batch(cuda, monkeypatch):
    """`generate(2²⁰)` of the Pacman model at the defaults takes the
    device sampler and the escape K1: 16 launches, every K1 kernel the
    profiler sees an escape kernel, no K2 and no dense `simulate`."""
    sim = _pacman_sim(cuda, 7)
    gen = tt.LibraryGenerator(sim, _ESC_PRIOR, unlog_keys=["log10_peak_age"],
                              device=cuda)

    def dense(*args, **kw):
        raise AssertionError("the dense simulate ran")

    monkeypatch.setattr(sim, "simulate", dense)
    before = (k1.fused_window_photometry.launches,
              k1.fused_sed_photometry.launches)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        lib = gen.generate(n=2 ** 20, seed=5)
        torch.cuda.synchronize()
    assert (k1.fused_window_photometry.launches,
            k1.fused_sed_photometry.launches) == (before[0] + 16, before[1])
    names = [e.name for e in prof.events()
             if "k1_fused_window" in e.name
             and e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 16 and all("_esc_" in n for n in names), names
    assert lib["photometry"].shape == (7, 2 ** 20)
    assert np.isfinite(lib["photometry"]).all()


# -- the flow zoo and the batched MCMC on the card ---------------------------
ZOO = ["maf", "made", "nsf", "realnvp", "affine_coupling", "nice", "mdn",
       "gaussian", "ncsf", "naf", "unaf", "sospf", "gf", "cnf"]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ZOO)
def test_zoo_card_vs_cpu(cuda, model):
    """Every registry name, two members, from the same (perturbed)
    parameters and base draws: log_prob card vs CPU to 1e-4, samples to
    1e-4 (the bisection families too: both devices run the same 50
    halvings); one training step on the card gives finite losses."""
    from synference_tpu_torch.flows.base import (params_from_numpy,
                                                 params_to_numpy, tree_map)
    from synference_tpu_torch.train import TrainConfig, _new_state, _npe_loss

    cfg = dict(hidden_features=16)
    if model == "cnf":
        cfg["num_steps"] = 4
    elif model not in ("mdn", "gaussian", "made"):
        cfg["num_transforms"] = 2
    rng = np.random.default_rng(3)
    theta = rng.normal(0, 1, (512, 6)).astype(np.float32)
    x = rng.normal(0, 1, (512, 14)).astype(np.float32)
    flows = {d: tt.build_flow(model, 6, 14, device=d, **cfg)
             for d in ("cpu", "cuda")}
    params = params_to_numpy(flows["cpu"].init(
        torch.Generator().manual_seed(0), theta, x, n_members=2))
    params["flow"] = tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params["flow"])
    p = {d: params_from_numpy(params, d) for d in ("cpu", "cuda")}
    with torch.no_grad():
        lp = {d: flows[d].log_prob(p[d], theta, x).cpu() for d in p}
        base = flows["cpu"]._net.draw_base(torch.Generator().manual_seed(1),
                                           (2, 8 * 32))
        s = {d: flows[d].sample_batch(p[d], x[:8], 32,
                                      base=base.to(d)).cpu() for d in p}
    assert torch.isfinite(lp["cuda"]).all()
    assert float((lp["cuda"] - lp["cpu"]).abs().max()) < 1e-4
    assert float((s["cuda"] - s["cpu"]).abs().max()) < 1e-4
    state = _new_state(flows["cuda"], theta, x, TrainConfig(), 2,
                       torch.Generator(device="cuda").manual_seed(0))
    t, xx = (torch.as_tensor(a, device="cuda") for a in (theta, x))
    loss = state.train_step(_npe_loss(flows["cuda"]),
                            t[:256].expand(2, -1, -1),
                            xx[:256].expand(2, -1, -1))
    assert torch.isfinite(loss).all()


@pytest.mark.cuda
def test_batched_mcmc_card_vs_cpu_and_no_sync(cuda):
    """`run_batched_mcmc` on a Gaussian target from the same draws: the
    card's chain equals the CPU's to 1e-5 and so does the acceptance; the
    loop runs under the sync guard, so a log-density that reads back
    raises on the card."""
    from synference_tpu_torch.mcmc import run_batched_mcmc

    rng = np.random.default_rng(0)
    m, w, n_steps, dim = 4, 16, 24, 2
    xs = rng.normal(0, 1, (m, dim)).astype(np.float32)
    draws = {
        "walkers": rng.uniform(-3, 3, (m, w, dim)).astype(np.float32),
        "stretch": rng.uniform(size=(n_steps, 2, m, w // 2)).astype(
            np.float32),
        "partner": rng.integers(0, w // 2, (n_steps, 2, m, w // 2)),
        "accept": rng.uniform(size=(n_steps, 2, m, w // 2)).astype(
            np.float32)}

    def target(theta, x):
        return -0.5 * (((theta - x) / 0.5) ** 2).sum(dim=-1)

    out = {}
    for d in ("cpu", "cuda"):
        prior = tt.BoxUniform([-3.0] * dim, [3.0] * dim, device=d)
        s, acc, diag = run_batched_mcmc(target, prior, xs, n_walkers=w,
                                        n_steps=n_steps, burn_in=8, thin=2,
                                        return_diagnostics=True, draws=draws)
        out[d] = (s.cpu(), float(acc), diag["rhat"].cpu())
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) < 1e-5
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], abs=1e-6)
    assert torch.allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4)

    def reads_back(theta, x):
        ll = target(theta, x)
        float(ll.sum())
        return ll

    with pytest.raises(RuntimeError, match="synchroniz"):
        run_batched_mcmc(reads_back, tt.BoxUniform([-3.0] * dim, [3.0] * dim,
                                                   device="cuda"),
                         xs, torch.Generator(device="cuda").manual_seed(0),
                         n_walkers=w, n_steps=2, burn_in=0)


# -- the gradient fitters on the card ----------------------------------------
def _wrapper_calls(device):
    """(name, call(sfzh, fw or τ)) of the five CUDA wrappers on small
    inputs."""
    g = _grouped_args(device, 13, 5, seed=3)
    sim = _sim(device, 3)
    k2 = _k2_args(sim, _unsorted_theta(7, seed=4))
    fw, table, s4 = _k3_case(device, "ragged-l")
    single = {k: g[k] for k in ("kc", "delta", "f8")}
    tables = g["tables"]
    ones = torch.ones(9, device=device)
    return {
        "K1 single": (g["sfzh"][:5], lambda x: k1.fused_window_photometry(
            x, g["s"][:5], g["tau_v"][:5], g["scale"][:5],
            tables["sed"][:, :g["w_cols"]], tables["curve"][:g["w_cols"]],
            tables["knot"][:g["w_cols"], :g["kc"] * g["f8"]],
            tables["den"][:g["kc"]], **single)),
        "K1 grouped": (g["sfzh"], lambda x: k1.fused_window_photometry_grouped(
            **dict(g, sfzh=x))),
        "K2": (k2[0], lambda x: k1.fused_sed_photometry(x, *k2[1:])),
        "K3": (fw, lambda x: pk.shift_photometry_num(x, table, s4)),
        "SFZH": (ones * 0.5, lambda x: sfzh_op.lognormal_delta_sfzh(
            ones * 1e9, ones * 18.0, x, ones * 1e9,
            torch.zeros(9, dtype=torch.int64, device=device), x,
            torch.linspace(0.0, 1.4e10, 17, device=device), 4)[0]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1 single", "K1 grouped", "K2", "K3",
                                    "SFZH"])
def test_wrappers_refuse_gradients(cuda, kernel):
    """A CUDA input that needs a gradient raises, in reverse mode and in
    forward mode; without one the kernel launches."""
    from torch.autograd import forward_ad

    x, call = _wrapper_calls(cuda)[kernel]
    assert torch.isfinite(call(x)).all()
    with pytest.raises(RuntimeError, match="_mega_off"):
        call(x.detach().clone().requires_grad_(True))
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(x.detach().clone(), torch.ones_like(x))
        with pytest.raises(RuntimeError, match="_mega_off"):
            call(dual)
    # K3's flux rows are wide: a few keep jacfwd's tangent basis small (the
    # refusal comes before the shape checks)
    jac_in = (x[:4] if kernel == "K3" else x).detach().clone()
    with pytest.raises(RuntimeError, match="_mega_off"):
        torch.func.jacfwd(lambda v: call(v).sum())(jac_in)


def _fitter_sim(device):
    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    filters = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                            zip(_CODES[1:4], _CENTERS[1:4], _WIDTHS[1:4])])
    return tt.BatchSEDSimulator(
        grid, filters, ("log10_mass", "tau_v"),
        fixed_params={"redshift": 1.0, "peak_age": 3e8, "tau": 0.5,
                      "log10_metallicity": -2.5},
        emission=tt.EmissionConfig(igm="inoue14"), device=device)


@pytest.mark.cuda
def test_mega_off_fitters_launch_no_kernel(cuda):
    """Fisher, MAP, VI and HMC take the plain route (0 launches of K1/K2/K3)
    and restore `_mega_off`; `photometry()` launches K2 again after."""
    sim = _fitter_sim(cuda)
    prior = tt.BoxUniform([8.0, 0.0], [11.0, 2.0], device=cuda)
    x = sim.photometry(torch.tensor([[9.5, 0.4], [10.2, 1.2]], device=cuda))
    counts = (k1.fused_window_photometry, k1.fused_sed_photometry,
              pk.shift_photometry_num)
    before = [c.launches for c in counts]
    g = torch.Generator(device=cuda).manual_seed(0)
    tt.fisher_forecast(sim, torch.tensor([[9.5, 0.4]], device=cuda),
                       0.05 * x[0])
    tt.fit_catalogue_map(sim, x, 0.05 * x, prior, g, n_steps=5)
    tt.fit_catalogue_vi(sim, x, 0.05 * x, prior, g, n_steps=5)
    tt.fit_catalogue_hmc(sim, x, 0.05 * x, prior, g, n_chains=2,
                         n_warmup=2, n_samples=2, n_leapfrog=2)
    torch.cuda.synchronize()
    assert [c.launches for c in counts] == before
    assert sim._mega_off is False
    sim.photometry(x[:, :2])
    assert k1.fused_sed_photometry.launches == before[1] + 1


@pytest.mark.cuda
def test_graphed_value_and_grad_matches_eager(cuda):
    """HMC's value-and-gradient pass as a CUDA graph replay equals the eager
    pass bit for bit (the same kernels), and the CPU's within 2e-3 of each
    row's largest entry: at these narrow 1024-λ bands one flipped bf16
    rounding of a knot-product input moves a flux by up to ~1e-3, and χ²
    at 5% errors magnifies it (measured on an H100: log-posterior 4.7e-4
    relative)."""
    from synference_tpu_torch import mcmc

    theta = tt.BoxUniform([8.0, 0.0], [11.0, 2.0], device="cpu").sample(
        torch.Generator().manual_seed(0), 8)
    out = {}
    for d in ("cpu", "cuda"):
        sim = _fitter_sim(d)
        box = mcmc._LogitBox(tt.BoxUniform([8.0, 0.0], [11.0, 2.0], device=d))
        x = sim.photometry(torch.tensor([[9.5, 0.4]] * 8, device=d))
        u = box.u(theta.to(d))

        def logpost(u, sim=sim, box=box, x=x):
            return (mcmc.censored_gaussian_loglike_rows(
                sim.photometry(box.theta(u)), x, 0.05 * x) + box.log_jac(u))

        with mcmc._plain_route(sim):
            out[d] = mcmc._value_and_grad(logpost, u)
            if d == "cuda":
                run = mcmc._graphed_value_and_grad(logpost, u.shape, cuda)
                for _ in range(2):  # a replay after another input too
                    graphed = run(u)
                    run(u + 1.0)
    assert torch.equal(graphed[0], out["cuda"][0])
    assert torch.equal(graphed[1], out["cuda"][1])
    for a, b in zip(out["cuda"], out["cpu"]):
        a, b = a.cpu().reshape(8, -1), b.reshape(8, -1)
        rel = ((a - b).abs() / b.abs().amax(dim=1, keepdim=True)).max()
        assert rel <= 2e-3, float(rel)


@pytest.mark.cuda
def test_hmc_card_vs_cpu_and_no_sync(cuda):
    """`fit_catalogue_hmc` from the same draws (2 objects × 2 chains, 4 + 4
    warmup and 4 sampling steps of 3 leapfrog) on the card and the CPU;
    the card's call runs whole under `set_sync_debug_mode("error")` (inputs
    already on the card). The chains are chaotic: the step-size adaptation
    and the accept tests amplify the card's and the CPU's float32 rounding
    differences, so the samples are held within 5e-2 of the prior width
    (measured on an H100: 6.8e-3) and the mean acceptance within 1e-2."""
    import warnings

    rng = np.random.default_rng(0)
    draws = {"candidates": rng.uniform([8.0, 0.0], [11.0, 2.0],
                                       (256, 2)).astype(np.float32),
             "momenta": rng.standard_normal((12, 4, 2)).astype(np.float32),
             "accept": rng.uniform(size=(12, 4)).astype(np.float32)}
    out = {}
    for d in ("cpu", "cuda"):
        sim = _fitter_sim(d)
        prior = tt.BoxUniform([8.0, 0.0], [11.0, 2.0], device=d)
        x = sim.photometry(torch.tensor([[9.5, 0.4], [10.2, 1.2]],
                                        device=d))
        dr = {k: torch.as_tensor(v, device=d) for k, v in draws.items()}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            if d == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                s, lp, acc = tt.fit_catalogue_hmc(
                    sim, x, 0.05 * x, prior, n_chains=2, n_warmup=8,
                    n_samples=4, n_leapfrog=3, draws=dr)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        out[d] = (s.cpu().numpy(), float(acc))
    width = np.array([3.0, 2.0])
    assert (np.abs(out["cuda"][0] - out["cpu"][0]) <= 5e-2 * width).all()
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], abs=1e-2)


def _agn_sims(device):
    """The analytic and the grid AGN simulator on the card's filters."""
    filters = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                            zip(_CODES, _CENTERS, _WIDTHS)])
    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    agn_grid = tt.make_synthetic_agn_grid(n_u=3, n_nh=2, n_wav=1024)
    return (tt.AGNSimulator(grid, filters, device=device),
            tt.AGNGridSimulator(agn_grid, filters, device=device))


_AGN_RANGES = {"log10_l_agn": (43.5, 47.0), "redshift": (0.1, 6.0),
               "agn_slope": (-1.0, 0.0), "tau_v": (0.0, 1.5),
               "ionisation_parameter": (-3.0, 0.0),
               "hydrogen_density": (2.0, 6.0),
               "covering_fraction_blr": (0.0, 0.3),
               "covering_fraction_nlr": (0.0, 0.5)}


def _agn_theta(names, n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(*_AGN_RANGES[p], n) for p in names],
                    axis=1).astype(np.float32)


@pytest.mark.cuda
def test_agn_simulators_launch_no_kernel(cuda):
    """The forward-model gate on the card: `photometry()` and `generate()`
    of both AGN simulators launch no K1, K2 or K3 (their own forward model
    takes the plain knot route), and agree with the same route on the CPU
    (the kernels' card-test bound: one bf16 rounding flip of a knot-product
    input shows at these 1024-λ bands)."""
    counts = (k1.fused_window_photometry, k1.fused_sed_photometry,
              pk.shift_photometry_num)
    for card, cpu in zip(_agn_sims(cuda), _agn_sims("cpu")):
        assert card.photometry_backend == "pallas"
        assert not card._mega_supported() and not card._window_supported()
        before = [c.launches for c in counts]
        theta = _agn_theta(card.param_names, 2048)
        out = card.photometry(theta)
        lib = tt.LibraryGenerator(
            card, {p: _AGN_RANGES[p] for p in card.param_names},
            device=cuda).generate(n=4096, batch_size=2048)
        torch.cuda.synchronize()
        assert [c.launches for c in counts] == before
        assert np.isfinite(lib["photometry"]).all()
        cpu = type(cpu)(cpu.grid, cpu.filters, photometry_backend="pallas",
                        device="cpu")
        _assert_close(out, cpu.photometry(theta))


@pytest.mark.cuda
def test_composite_launches_k2_once_per_call(cuda):
    """A stellar model plus a grid AGN: one K2 launch per `photometry()`
    (the stellar component), none of K1 or K3, and the sum of the
    components' own plain routes within the kernels' card-test bound."""
    stars, agn = _sim(cuda, 3), _agn_sims(cuda)[1]
    comp = tt.CompositeSEDSimulator({"stars": stars, "agn": agn})
    theta = torch.as_tensor(np.concatenate([
        _unsorted_theta(2000, seed=13)[:, 1:2],
        _unsorted_theta(2000, seed=13)[:, [0, 2, 3, 4, 5]],
        _agn_theta(agn.param_names[:1] + agn.param_names[2:], 2000, 4)],
        axis=1), device=cuda)
    assert theta.shape[1] == comp.n_params
    counts = (k1.fused_window_photometry, k1.fused_sed_photometry,
              pk.shift_photometry_num)
    before = [c.launches for c in counts]
    out = comp.photometry(theta)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [0, 1, 0]
    parts = {}
    for name, sim in comp.components.items():
        res = sim._core(comp._component_theta(theta, name), False,
                        fused=True)
        parts[name] = sim._photometry_fused(res["_lnu"], res["_z"])
    plain = parts["stars"] + parts["agn"]
    _assert_close(out, plain)
    # again on the bands where the stars give at least 10% of the flux, so
    # that a dropped or mis-scaled stellar part cannot hide under the AGN
    ref = plain.cpu().numpy()
    keep = ((parts["stars"].cpu().numpy() >= 0.1 * ref)
            & (ref > 1e-3 * ref.max(axis=1, keepdims=True)))
    assert keep.any(axis=1).sum() >= len(theta) // 4
    rel = (np.abs(out.cpu().numpy() - ref) / np.maximum(np.abs(ref), 1e-30)
           )[keep]
    assert np.quantile(rel, 0.99) < 1e-5 and rel.max() < 2e-3, rel.max()
    frac = comp.agn_fraction(theta[:256], agn_components=("agn",))
    assert frac.device.type == "cuda" and bool(((frac >= 0)
                                                & (frac <= 1)).all())


@pytest.mark.cuda
def test_simformer_graphed_steps_match_eager(cuda):
    """One captured graph per reverse-SDE step and per PF-ODE step: the
    same bits as the eager kernels from the same generator; the score on
    the card within 1e-4 of the CPU's from the same weights."""
    from synference_tpu_torch import simformer as ts

    cfg = ts.SimformerConfig(n_tokens=9, d_model=32, n_heads=4, n_layers=2)
    model = ts.Simformer(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    with torch.no_grad():
        model.out.w.normal_(0.0, 0.3)
    rng = np.random.default_rng(0)
    std = {"mu": rng.standard_normal(9).astype(np.float32),
           "sd": rng.uniform(0.5, 2, 9).astype(np.float32),
           "n_theta": 3, "n_x": 6}
    post = ts.SimformerPosterior(model, None, std, n_steps=40)
    xs = torch.as_tensor(rng.standard_normal((5, 6)).astype(np.float32),
                         device=cuda)
    draws = [post.sample_batch(xs, 64, torch.Generator(
        device=cuda).manual_seed(3), graphed=g) for g in (True, False)]
    assert draws[0].shape == (5, 64, 3) and torch.isfinite(draws[0]).all()
    assert torch.equal(draws[0], draws[1])
    theta = torch.as_tensor(rng.standard_normal((32, 3)).astype(np.float32),
                            device=cuda)
    lp = [post.log_prob(theta, xs[:1].expand(32, -1), n_steps=20,
                        graphed=g) for g in (True, False)]
    assert torch.equal(lp[0], lp[1]) and torch.isfinite(lp[0]).all()
    cpu = ts.SimformerPosterior.from_state_dict(post.state_dict(),
                                                device="cpu")
    v = torch.randn(256, 9, generator=torch.Generator().manual_seed(1))
    t = torch.rand(256, generator=torch.Generator().manual_seed(2))
    cond = (torch.rand(256, 9, generator=torch.Generator().manual_seed(4))
            < 0.5).float()
    with torch.no_grad():
        card = model.score(v.to(cuda), t.to(cuda), cond.to(cuda)).cpu()
        ref = cpu.model.score(v, t, cond)
    assert float((card - ref).abs().max() / ref.abs().max()) < 1e-4


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL process group on the card, taken down after."""
    import socket

    import torch.distributed as dist

    from synference_tpu_torch import parallel as par

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (NCCL)")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert par.initialize_multihost(f"localhost:{port}", 1, 0,
                                    device="cuda") == (0, 1)
    yield par.make_mesh(device="cuda")
    dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_photometry_launches_k2_on_one_nccl_rank(cuda, nccl_mesh):
    from synference_tpu_torch import parallel as par

    sim = _sim(cuda, 3)
    theta = torch.as_tensor(_unsorted_theta(2048, seed=21), device=cuda)
    fn = par.make_sharded_photometry_fn(sim, nccl_mesh)
    counts = (k1.fused_window_photometry, k1.fused_sed_photometry,
              pk.shift_photometry_num)
    before = [c.launches for c in counts]
    out = fn(theta)["photometry_njy"]
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [0, 1, 0]
    assert torch.equal(out, sim.photometry(theta))


@pytest.mark.cuda
def test_sharded_train_step_on_one_nccl_rank(cuda, nccl_mesh):
    """The step with its NCCL all_reduce over "data" is the trainer's
    step on the same batch, bit for bit."""
    from synference_tpu_torch import parallel as par
    from synference_tpu_torch.flows.base import tree_leaves
    from synference_tpu_torch.train import (TrainConfig, _EnsembleState,
                                            _npe_loss)

    rng = np.random.default_rng(0)
    tb = torch.as_tensor(rng.standard_normal((512, 3)).astype(np.float32),
                         device=cuda)
    xb = torch.as_tensor(rng.standard_normal((512, 5)).astype(np.float32),
                         device=cuda)
    flow = tt.build_flow("nsf", 3, 5, hidden_features=16, num_transforms=2,
                         device=cuda)
    params = par.init_sharded_ensemble(
        flow, torch.Generator(device=cuda).manual_seed(0), tb, xb, 2,
        nccl_mesh)
    cfg = TrainConfig(learning_rate=1e-3)
    state = _EnsembleState(flow.init(torch.Generator(
        device=cuda).manual_seed(0), tb, xb, n_members=2),
        torch.full((2,), 1e-3, device=cuda), cfg)
    step, place = par.make_sharded_train_step(flow, nccl_mesh, cfg)
    opt = par.init_opt_state(params)
    for _ in range(2):
        params, opt, losses = step(params, opt, place(tb), place(xb))
        ref = state.train_step(_npe_loss(flow), tb.expand(2, -1, -1),
                               xb.expand(2, -1, -1))
        assert torch.equal(losses, ref)
    flat = torch.cat([a.reshape(2, -1) for a in tree_leaves(params)], 1)
    assert torch.equal(flat, state.flat)
