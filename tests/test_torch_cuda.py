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
device-sampler resume bit for bit, the "auto" window-body probe (CUDA
events, cached on the simulator and in its file, a failing K1 raising), and
"auto" on a run too short to probe taking K1 once per batch.

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
        _assert_close(out, k1.fused_window_photometry_reference(**a))
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
def test_ragged_shapes(cuda):
    """Batch, cell and window sizes that are not multiples of the tiles."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, c, w, kc, f8 = 77, 45, 131, 6, 8
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
    _assert_close(out, k1.fused_window_photometry_reference(**a))


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
    _assert_close(out, k1.fused_sed_photometry_reference(*args, **kw))


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
    _assert_close(out, k1.fused_window_photometry_grouped_reference(
        **a, order=order))


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
    _assert_close(out, k1.fused_window_photometry_grouped_reference(**a))
    n_knots, delta = 12, 3
    tables = _tables(cuda, 45, 300, n_knots, 128, seed=5)
    rng = np.random.default_rng(5)
    r = _rows(cuda, 300, 45, rng.uniform(0, (n_knots - 1) * delta, 300), 5)
    args = (r["sfzh"], r["s"], r["tau_v"], r["scale"], tables, n_knots,
            delta, 128)
    out = k1.fused_sed_photometry(*args)
    torch.cuda.synchronize()
    _assert_close(out, k1.fused_sed_photometry_reference(*args))


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
    _assert_close(out, k1.fused_sed_photometry_reference(*args))


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
    _assert_close(out, k1.fused_sed_photometry_reference(*args))


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
def test_auto_short_run_launches_k1_per_batch(cuda, monkeypatch):
    """A 2-batch `generate` at the default settings ("auto") takes K1, one
    launch per batch, without timing the staged body."""
    from synference_tpu_torch import library as tl

    def no_probe(*a, **k):
        raise AssertionError("probed a short run")

    monkeypatch.setattr(tl, "_probe_bodies", no_probe)
    prior = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
             "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
             "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
    gen = tt.LibraryGenerator(_sim(cuda, 3), prior,
                              unlog_keys=["log10_peak_age"], device=cuda)
    # 16 sub-chunks over the run, as in the probe test below: narrower
    # runs plan windows as wide as the table and take the dense path
    args = dict(n=2 * 8192, batch_size=8192, seed=1)
    before = k1.fused_window_photometry.launches
    lib = gen.generate(**args)
    assert k1.fused_window_photometry.launches == before + 2
    assert gen.last_probe == {"source": "short run", "fused": True}
    forced = gen.generate(zsorted_fused=True, **args)
    np.testing.assert_array_equal(lib["photometry"], forced["photometry"])


@pytest.mark.cuda
def test_auto_probe_on_the_card(cuda, tmp_path, monkeypatch):
    """"auto" times both window bodies once (CUDA events), keeps the
    choice on the simulator and in the probe file under its digest; a
    fresh simulator reads the file; a failing K1 propagates out of the
    probe."""
    from synference_tpu_torch import library as tl
    from synference_tpu_torch import sed

    monkeypatch.setattr(tl, "ZSORTED_PROBE_FILE", tmp_path / "probe.json")
    prior = {"log10_mass": (7.5, 11.0), "redshift": (0.1, 8.0),
             "log10_peak_age": (7.6, 9.2), "tau": (0.1, 1.2),
             "log10_metallicity": (-3.9, -1.6), "tau_v": (0.0, 2.0)}
    args = dict(n=4 * 4096, batch_size=4096, seed=1)
    gen = tt.LibraryGenerator(_sim(cuda, 3), prior,
                              unlog_keys=["log10_peak_age"], device=cuda)
    lib = gen.generate(**args)
    rec = gen.last_probe
    assert rec["source"] == "probe" and rec["staged_ms"] > 0
    assert rec["fused_ms"] > 0 and len(rec["digest"]) == 64
    forced = gen.generate(zsorted_fused=rec["fused"], **args)
    np.testing.assert_array_equal(lib["photometry"], forced["photometry"])
    again = tt.LibraryGenerator(gen.simulator, prior,
                                unlog_keys=["log10_peak_age"], device=cuda)
    again.generate(**args)
    assert again.last_probe["source"] == "simulator"
    fresh = tt.LibraryGenerator(_sim(cuda, 3), prior,
                                unlog_keys=["log10_peak_age"], device=cuda)
    fresh.generate(**args)
    assert fresh.last_probe["source"] == "file"
    assert fresh.last_probe["fused"] == rec["fused"]

    def broken(**kw):
        raise RuntimeError("K1 failed to launch")

    monkeypatch.setattr(sed, "fused_window_photometry_grouped", broken)
    monkeypatch.setattr(tl, "ZSORTED_PROBE_FILE", tmp_path / "other.json")
    with pytest.raises(RuntimeError, match="K1 failed"):
        tt.LibraryGenerator(_sim(cuda, 3), prior,
                            unlog_keys=["log10_peak_age"],
                            device=cuda).generate(**args)
