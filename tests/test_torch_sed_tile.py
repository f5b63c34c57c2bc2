"""The one-launch K1 and K2's row order, on the CPU.

K1 covers a whole batch of z-sorted sub-chunks in one launch
(`fused_window_photometry_grouped`), K2 visits the rows of a batch in the
order of `k2_row_order`; both read K-major operands by TMA: sfzh's rows
(`k_major`) and the (L, C) transpose of the spectra (`_b_operand`,
`k_major`). The kernels run only on a card (`tests/test_torch_cuda.py`);
here their plain versions, the helpers the CPU reaches and the wrappers'
input checks are held to the per-sub-chunk plain K1 and the plain K2, on
inputs made with numpy from a seed. Tolerances: exact where both sides run
the same float32 operations on the same rows; the plain K2 on gathered rows
against the plain K2 within 1e-6 relative (each output row depends on its
own input row only; only the matrix library's blocking of the rows can
differ).

The kernels are held to the exact first product (float64, rounded once to
fp32: `fused_window_photometry_exact`) by `exact_gate`: p99 < 1e-5, max <
1e-3 and at most twice the fp32 plain version's share of fluxes off by more
than 1e-5, plus 1e-4. Here the gate is held to its power on the headline
model's tables: a first product split into TF32 halves (`tf32_split`) and
summed as three exact-product float32 matrix products passes it, one TF32
product fails it.

At more than 8 bands the kernels share each galaxy tile's first product
across a cluster of `cluster_size(F8)` band groups, and the card tests hold
them bit for bit to the same kernel launched on each 8-band slice of the
tables. Here the plain versions are held to the same property exactly, and
the cluster size to its rule for every F8 the wrappers take.
"""

import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
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


def _tables(rng, c, n_l, n_knots, f8):
    return dict(
        sed=torch.as_tensor(rng.uniform(0, 1e20, (c, n_l)), dtype=torch.float32),
        curve=torch.as_tensor(rng.uniform(0, 1, n_l), dtype=torch.float32),
        knot=torch.as_tensor(rng.uniform(0, 1, (n_l, n_knots * f8)),
                             dtype=torch.float32).to(torch.bfloat16),
        den=torch.as_tensor(rng.uniform(1, 2, (n_knots, f8)),
                            dtype=torch.float32))


def _rows(rng, b, c, s):
    f32 = torch.float32
    return dict(sfzh=torch.as_tensor(rng.uniform(0, 1e9, (b, c)), dtype=f32),
                s=torch.as_tensor(s, dtype=f32),
                tau_v=torch.as_tensor(rng.uniform(0, 2, b), dtype=f32),
                scale=torch.as_tensor(rng.uniform(.5, 1.5, b), dtype=f32))


def _grouped(seed=0, b=290, sub=100, f8=8):
    """Grouped K1 inputs: ceil(b/sub) sub-chunks (the last one short), each
    with its own window at an unaligned column."""
    c, n_l, n_knots, kc, w, delta = 45, 300, 12, 6, 131, 3
    rng = np.random.default_rng(seed)
    n_sub = -(-b // sub)
    k0 = np.array([0, 6, 3])[:n_sub]
    l0 = np.array([1, 169, 83])[:n_sub]
    s = np.repeat(k0, sub)[:b] * delta + rng.uniform(0, (kc - 1) * delta, b)
    return dict(**_rows(rng, b, c, s), tables=_tables(rng, c, n_l, n_knots,
                                                       f8),
                k0=k0, l0=l0, sub=sub, w_cols=w, kc=kc, delta=delta, f8=f8)


@pytest.mark.parametrize("order", [1, 3])
def test_grouped_plain_equals_per_sub_chunk_loop(order):
    """The grouped K1's plain path over sub-chunks with distinct, unaligned
    windows, a sub-chunk of 100 rows (not a multiple of the 128-row tile)
    and a short last one, equals `fused_window_photometry_reference` run
    on each sub-chunk's own window."""
    a = _grouped(seed=order)
    assert len(set(a["l0"] % 4)) > 1 and a["sub"] % k1.TILE_ROWS
    out = k1.fused_window_photometry_grouped(**a, order=order)
    t, sub, kc, delta, f8 = a["tables"], a["sub"], a["kc"], a["delta"], 8
    for i, (k, l) in enumerate(zip(a["k0"], a["l0"])):
        r = slice(i * sub, (i + 1) * sub)
        cols = slice(l, l + a["w_cols"])
        ref = k1.fused_window_photometry_reference(
            a["sfzh"][r], a["s"][r] - float(k * delta), a["tau_v"][r],
            a["scale"][r], t["sed"][:, cols], t["curve"][cols],
            t["knot"][cols, k * f8:(k + kc) * f8], t["den"][k:k + kc], kc,
            delta, f8, order=order)
        assert torch.equal(out[r], ref), i


def _sim(order=3):
    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    filters = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                            zip(_CODES, _CENTERS, _WIDTHS)])
    return tt.BatchSEDSimulator(grid, filters, PNAMES,
                                photometry_interp_order=order, device="cpu")


def _sorted_theta(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(7.5, 11, n), np.sort(rng.uniform(0.05, 8, n)),
        rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
        rng.uniform(-3.9, -1.6, n), rng.uniform(0, 2, n),
    ]).astype(np.float32)


def test_window_engine_fused_body_is_one_grouped_call():
    """`_zsorted_run_raw(fused=True)` is the grouped K1 over the batch: it
    equals the one-sub-chunk K1 (plain) on each sub-chunk's window."""
    sim = _sim()
    theta, sub, kc, w_cols, k0, l0 = sim._plan_windows(
        _sorted_theta(1000, seed=1), 96)
    assert len(set(np.asarray(l0) % 4)) > 1
    out = sim._zsorted_run_raw(theta, sub, w_cols, kc, k0, l0, fused=True)
    for r, _, _, a in sim._window_calls(theta, sub, w_cols, kc, k0, l0):
        ref = k1.fused_window_photometry_reference(**a)
        assert torch.equal(out[r], ref[:, :len(_CODES)])


def test_tile_major_layout():
    """The kernels' A operand is K-major (`k_major`): sfzh itself when its
    rows of cells are 16-byte aligned (C a multiple of 4), else a copy with
    the cells zero-padded to a multiple of 4. The B operand (`_b_operand`)
    is the spectra's (L, C) transpose, padded alike, made once per table
    and made anew when the table is written in place."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((290, 8)), dtype=torch.float32)
    assert k1.k_major(x) is x
    x = torch.as_tensor(rng.standard_normal((290, 5)), dtype=torch.float32)
    a = k1.k_major(x)
    assert a.shape == (290, 8) and a.is_contiguous()
    assert torch.equal(a[:, :5], x) and not a[:, 5:].any()
    view = torch.zeros(290, 12)[:, 1:9]  # rows start 4 bytes off 16
    assert k1.k_major(view) is not view
    assert torch.equal(k1.k_major(view), view)
    sed = torch.as_tensor(rng.uniform(0, 1, (45, 301)), dtype=torch.float32)
    t = k1.prepare_megakernel_tables(sed, torch.ones(301), torch.rand(301),
                                     torch.rand(301, 16), torch.rand(2, 7),
                                     8)
    assert "sed_k" not in t  # the spectra are kept once, as "sed"
    b = k1._b_operand(t["sed"])
    assert b.shape == (301, 48)
    assert torch.equal(b[:, :45], t["sed"].T) and not b[:, 45:].any()
    assert k1._b_operand(t["sed"]) is b
    t["sed"].mul_(2.0)  # written in place: the operand is made anew
    b2 = k1._b_operand(t["sed"])
    assert b2 is not b and torch.equal(b2[:, :45], t["sed"].T)
    new = t["sed"] + 1.0  # another table, e.g. dict(t, sed=new)
    assert torch.equal(k1._b_operand(new)[:, :45], new.T)
    assert k1._b_operand(t["sed"]) is b2


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """hi + lo == a bit for bit, hi has its 13 low mantissa bits clear and
    is a rounded to nearest with ties away from zero (PTX `cvt.rna`); the
    truncation the tensor cores apply to a float32 clears the same bits."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal(20000) * 10.0 ** rng.uniform(-30, 30, 20000)
    a = np.concatenate([a, [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    bits = a.view(np.uint32)
    ties = (bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)  # exact ties
    a = np.concatenate([a, ties.view(np.float32)])
    hi, lo = k1.tf32_split(torch.as_tensor(a))
    assert torch.equal(hi + lo, torch.as_tensor(a))
    hb = hi.numpy().view(np.uint32)
    assert not (hb & 0x1FFF).any()
    # round to nearest, ties away from zero, on the magnitude
    mag = a.view(np.uint32) & np.uint32(0x7FFFFFFF)
    want = ((mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) | (
        a.view(np.uint32) & np.uint32(0x80000000))
    np.testing.assert_array_equal(hb, want)
    t = k1.tf32_truncate(torch.as_tensor(a)).numpy().view(np.uint32)
    np.testing.assert_array_equal(t, a.view(np.uint32) & np.uint32(0xFFFFE000))


@pytest.fixture(scope="module")
def headline_cut():
    """K1 plain-version arguments on 2048 rows of the headline model (C 384,
    L 1006, 162 knots; bench.py's θ ranges), built once for the module."""
    grid = tt.make_synthetic_grid(n_ages=48, n_mets=8, n_wav=2048,
                                  lam_min=300.0)
    filters = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                            zip(_CODES, _CENTERS, _WIDTHS)])
    sim = tt.BatchSEDSimulator(grid, filters, PNAMES, sfh="lognormal",
                               zdist="delta",
                               emission=tt.EmissionConfig(igm="inoue14"),
                               device="cpu")
    rng = np.random.default_rng(0)
    n = 2048
    theta = np.stack([rng.uniform(7.5, 11, n), rng.uniform(0.05, 10, n),
                      rng.uniform(5e7, 1e9, n), rng.uniform(0.1, 1.2, n),
                      rng.uniform(-3.9, -1.5, n), rng.uniform(0, 3, n)],
                     axis=1).astype(np.float32)
    params = sim.theta_dict(torch.as_tensor(theta))
    sfzh, _ = sim._sfzh(params)
    z = params["redshift"]
    t = sim._mega_tables
    return dict(sfzh=sfzh, s_rel=sim._shift_of_z(z), tau_v=params["tau_v"],
                scale=sim._scale_of_z(z), sed_w=t["sed"], curve_w=t["curve"],
                knot_w=t["knot"], den_w=t["den"], kc=sim._n_knots,
                delta=sim._knot_delta, f8=sim._f8, order=3)


def _one_pass_tf32(a, b):
    return k1.tf32_split(a)[0] @ k1.tf32_split(b)[0]


@pytest.mark.parametrize("case", ["grid", "headline"])
def test_exact_gate_passes_3xtf32_split_and_fails_one_tf32_product(
        case, request):
    """Against the exact first product: the fp32 plain version and the
    3xTF32 split with float32 sums (exact TF32 products, as on the CPU) pass
    the gate, one TF32 product fails it, at the test grid (the window
    engine's grouped batch over 4096 z-sorted rows; the gate's slack of
    1e-4 in the share of flipped fluxes is ~2.5 fluxes there, and at 2048
    rows a single bf16 flip decides) and on 2048 headline rows. On the card
    the three TF32 products run on the tensor cores and fail the gate
    (PERF.md), which is why the kernels keep their fp32 FMA chain."""
    if case == "grid":
        sim = _sim()
        theta, sub, kc, w_cols, k0, l0 = sim._plan_windows(
            _sorted_theta(4096), 128)
        a = sim._window_grouped_args(theta, sub, w_cols, kc, k0, l0)
        run = k1.fused_window_photometry_grouped_reference
    else:
        a = request.getfixturevalue("headline_cut")
        run = k1.fused_window_photometry_reference
    plain = run(**a)
    exact = run(**a, first_product=k1.exact_first_product)
    assert k1.exact_gate(plain, exact, plain)["ok"]
    split = run(**a, first_product=k1.tf32x3_first_product)
    g = k1.exact_gate(split, exact, plain)
    assert g["ok"], g
    one = k1.exact_gate(run(**a, first_product=_one_pass_tf32), exact, plain)
    assert not one["ok"] and one["p99"] > 1e-4, one


def test_exact_gate_counts_only_significant_fluxes():
    """The gate reads fluxes above 1e-3 of their row's maximum in the exact
    answer: a wrong flux below that line passes, one above it fails, and a
    non-finite output fails."""
    exact = torch.tensor([[1.0, 2.0, 1e-4], [3.0, 1.0, 2.0]])
    out = exact.clone()
    out[0, 2] *= 2.0
    assert k1.exact_gate(out, exact, exact)["ok"]
    out[1, 1] *= 1.0 + 2e-3
    g = k1.exact_gate(out, exact, exact)
    assert not g["ok"] and g["max"] == pytest.approx(2e-3, rel=1e-3)
    out = exact.clone()
    out[0, 2] = float("nan")
    assert not k1.exact_gate(out, exact, exact)["ok"]


def _first_knot(s, n_knots, delta):
    c = np.clip(s, 0, (n_knots - 1) * delta - 1e-3) / delta
    return np.maximum(np.floor(c).astype(int) - 1, 0)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "single-z"])
def test_k2_row_order(kind):
    """A stable int32 permutation sorting rows by their first knot: at the
    headline's 65536 rows over 162 knots each 128-row block spans at most
    one first knot whatever the input order, so K2's blocks contract one
    pass of knots each (a pass holds first knots 5 apart)."""
    n_knots, delta, b = 162, 4, 65536
    rng = np.random.default_rng(3)
    s = rng.uniform(0, 641, b)
    if kind == "sorted":
        s = np.sort(s)
    elif kind == "single-z":
        s = np.full(b, 321.7)
    order = k1.k2_row_order(torch.as_tensor(s, dtype=torch.float32),
                            n_knots, delta)
    assert order.dtype == torch.int32 and order.shape == (b,)
    idx = order.numpy()
    np.testing.assert_array_equal(np.sort(idx), np.arange(b))
    first = _first_knot(s.astype(np.float32), n_knots, delta)[idx]
    assert np.all(np.diff(first) >= 0)
    span = np.ptp(first.reshape(-1, k1.TILE_ROWS), axis=1)
    assert span.max() <= 1
    if kind != "unsorted":  # stable: already-ordered rows keep their order
        np.testing.assert_array_equal(idx, np.arange(b))


def test_k2_gather_then_scatter_reproduces_reference():
    """Running the plain K2 on the rows in K2's row order and scattering
    the results back gives the plain K2 on the batch as it came."""
    n_knots, delta, f8, c, b = 40, 3, 8, 45, 333
    rng = np.random.default_rng(4)
    tables = _tables(rng, c, 300, n_knots, f8)
    r = _rows(rng, b, c, rng.uniform(0, (n_knots - 1) * delta, b))
    order = k1.k2_row_order(r["s"], n_knots, delta).long()
    ref = k1.fused_sed_photometry_reference(
        r["sfzh"], r["s"], r["tau_v"], r["scale"], tables, n_knots, delta, f8)
    got = torch.empty_like(ref)
    got[order] = k1.fused_sed_photometry_reference(
        r["sfzh"][order], r["s"][order], r["tau_v"][order],
        r["scale"][order], tables, n_knots, delta, f8)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)


@pytest.mark.parametrize("bad,match", [
    (dict(k0=np.array([0, 6])), "window starts need shape"),
    (dict(l0=np.array([1.0, 169.0, 83.0])), "must be integers"),
    (dict(k0=np.array([0, 7, 3])), "knot starts must lie"),
    (dict(l0=np.array([-1, 169, 83])), "column starts must lie"),
    (dict(l0=np.array([1, 170, 83])), "column starts must lie"),
    (dict(w_cols=301), "does not fit"),
    (dict(sub=0), "sub >= 1"),
])
def test_grouped_wrapper_rejects_bad_window_starts(bad, match):
    a = dict(_grouped(), **bad)
    with pytest.raises(ValueError, match=match):
        k1.fused_window_photometry_grouped(**a)


@pytest.mark.parametrize("bad,match", [
    (lambda b: torch.arange(b), "int32"),
    (lambda b: torch.arange(b + 1, dtype=torch.int32), r"\(333,\)"),
    (lambda b: torch.zeros(b, dtype=torch.int32), "permutation"),
    (lambda b: torch.arange(2 * b, dtype=torch.int32)[::2], "contiguous"),
])
def test_k2_wrapper_rejects_bad_row_order(bad, match):
    n_knots, delta, f8, c, b = 40, 3, 8, 45, 333
    rng = np.random.default_rng(5)
    tables = _tables(rng, c, 300, n_knots, f8)
    r = _rows(rng, b, c, rng.uniform(0, 100, b))
    with pytest.raises(ValueError, match=match):
        k1.fused_sed_photometry(r["sfzh"], r["s"], r["tau_v"], r["scale"],
                                tables, n_knots, delta, f8, rows=bad(b))
    good = k1.k2_row_order(r["s"], n_knots, delta)
    torch.testing.assert_close(
        k1.fused_sed_photometry(r["sfzh"], r["s"], r["tau_v"], r["scale"],
                                tables, n_knots, delta, f8, rows=good),
        k1.fused_sed_photometry_reference(r["sfzh"], r["s"], r["tau_v"],
                                          r["scale"], tables, n_knots, delta,
                                          f8), rtol=0, atol=0)


def test_cuda_input_checks_want_16_byte_knot_rows():
    """The kernels copy the knot matrix in 16-byte groups of 8 bands: a
    row stride that is not a multiple of 8 is refused before a launch."""
    b, c, w, kc, f8 = 64, 48, 256, 8, 8
    m = dict(device="meta")
    knot = torch.empty(w, kc * f8 + 4, dtype=torch.bfloat16, **m)[:, :kc * f8]
    with pytest.raises(ValueError, match="16-byte aligned"):
        k1._check_cuda_inputs(
            torch.empty(b, c, **m), torch.empty(b, **m), torch.empty(b, **m),
            torch.empty(b, **m), torch.empty(c, w, **m), torch.empty(w, **m),
            knot, torch.empty(kc, f8, **m), kc, 2, f8, 3)


@pytest.mark.parametrize("order", [1, 3])
def test_plain_kernels_at_64_bands_are_their_8_band_slices(order):
    """The plain grouped K1 and the plain K2 at F8 64 equal, exactly, the
    concatenation of their results on the 8 band slices of the tables: the
    first product and screen do not see the bands, each band's knot column
    is its own dot product over λ (summed in the same order whatever
    columns sit beside it, at these widths), and the interpolation is per
    band. The card tests hold the clustered kernels to the same property
    bit for bit."""
    f8 = 64
    a = _grouped(seed=7 + order, f8=f8)
    out = k1.fused_window_photometry_grouped(**a, order=order)
    parts = [k1.fused_window_photometry_grouped(
        **dict(a, tables=k1.band_group_tables(a["tables"], g, 12), f8=8),
        order=order) for g in range(f8 // 8)]
    assert torch.equal(out, torch.cat(parts, dim=1))
    n_knots, delta, c, b = 40, 3, 45, 290
    rng = np.random.default_rng(order)
    tables = _tables(rng, c, 300, n_knots, f8)
    r = _rows(rng, b, c, rng.uniform(0, (n_knots - 1) * delta, b))
    args = (r["sfzh"], r["s"], r["tau_v"], r["scale"])
    out = k1.fused_sed_photometry(*args, tables, n_knots, delta, f8,
                                  order=order)
    parts = [k1.fused_sed_photometry(
        *args, k1.band_group_tables(tables, g, n_knots), n_knots, delta, 8,
        order=order) for g in range(f8 // 8)]
    assert torch.equal(out, torch.cat(parts, dim=1))


@pytest.mark.parametrize("f8", range(8, 129, 8))
def test_cluster_size(f8):
    """The f8/8 band groups go into the fewest clusters of at most 8 blocks
    (the portable size), as evenly as they go: a lone block at 8 bands, one
    cluster up to 64, two at 72-128, and fewer padding slots than
    clusters."""
    groups = f8 // 8
    n = k1.cluster_size(f8)
    clusters = -(-groups // n)
    assert 1 <= n <= 8 and clusters == -(-groups // 8)
    assert clusters * n - groups < clusters
    assert (n == 1) == (f8 == 8)
    expected = {8: 1, 16: 2, 24: 3, 56: 7, 64: 8, 72: 5, 88: 6, 120: 8,
                128: 8}
    if f8 in expected:
        assert n == expected[f8]


@pytest.mark.parametrize("f8,ok", [(8, True), (24, True), (128, True),
                                   (136, False), (20, False)])
def test_cuda_input_checks_take_f8_multiples_of_8_up_to_128(f8, ok):
    """The wrappers' checks before a launch: F8 a multiple of 8, at most
    128 (two clusters of 8 band groups)."""
    b, c, w, kc = 64, 48, 256, 8
    m = dict(device="meta")
    args = (torch.empty(b, c, **m), torch.empty(b, **m), torch.empty(b, **m),
            torch.empty(b, **m), torch.empty(c, w, **m), torch.empty(w, **m),
            torch.empty(w, kc * f8, dtype=torch.bfloat16, **m),
            torch.empty(kc, f8, **m), kc, 2, f8, 3)
    if ok:
        k1._check_cuda_inputs(*args)
    else:
        with pytest.raises(ValueError, match="multiple of 8"):
            k1._check_cuda_inputs(*args)
