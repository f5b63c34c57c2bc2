"""The SFZH kernel's host side on the CPU (`ops/sfzh.py`): the mirror of
torch's in-row scan rule that its row total follows, the gate in
`BatchSEDSimulator._sfzh` that picks it, the plain version it is held to,
and `_sfzh`'s optional age marginal. The kernel itself runs on the card
(`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu_torch import sfh
from synference_tpu_torch.ops import sfzh as sfzh_op

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
_FILTERS = [("B0", 9000.0, 2000.0), ("B1", 20000.0, 4600.0),
            ("B2", 44400.0, 10200.0)]


def _sim(names=PNAMES, grid=None, **kw):
    grid = grid or tt.make_synthetic_grid(n_ages=64, n_mets=12, n_wav=600,
                                          lam_min=150.0)
    filters = tt.FilterSet([tt.tophat_filter(*f) for f in _FILTERS])
    return tt.BatchSEDSimulator(grid, filters, names, device="cpu", **kw)


def _theta(n, seed=0):
    """Draws over the north-star prior, then rows at its edges: τ at and
    below its clamp, the SFR peak at and past the oldest age, z at both
    prior ends, log10 Z outside the grid on both sides, and a history
    with no mass on the grid (the uniform row)."""
    rng = np.random.default_rng(seed)
    theta = np.column_stack([
        rng.uniform(7.5, 11.0, n), rng.uniform(0.1, 8.0, n),
        10.0 ** rng.uniform(7.6, 9.2, n), rng.uniform(0.1, 1.2, n),
        rng.uniform(-3.9, -1.6, n), rng.uniform(0.0, 2.0, n)])
    edges = [(3, 0.0), (3, 5e-4), (2, 1.4e10), (2, 1.2e9), (1, 0.1),
             (1, 8.0), (4, -6.0), (4, 0.0), (2, -1e12)]
    for i, (col, v) in enumerate(edges[:n]):
        theta[i, col] = v
    theta[min(8, n - 1), 3] = 1e-3  # with the peak far past: no mass
    return torch.as_tensor(theta, dtype=torch.float32)


def _get_log_num_threads_x_inner_scan(num_rows, row_size):
    """ATen's loop (ScanUtils.cuh) in uint32 arithmetic."""
    u = np.uint32
    lx, ly = u(0), u(0)
    while (u(1) << lx) < u(row_size):
        lx += u(1)
    while (u(1) << ly) < u(num_rows):
        ly += u(1)
    with np.errstate(over="ignore"):
        diff = u(lx - ly)
        lx = u(u(9) + diff) // u(2)
    return int(min(max(u(4), lx), u(9)))


@pytest.mark.parametrize("rows, chunk", [
    (1, None), (8, 128), (32, 64), (33, 32), (1024, 32), (32768, 32),
    (32769, 1024), (34816, 1024), (65536, 1024)])
def test_scan_chunk_at_the_main_row_counts(rows, chunk):
    """At 64 ages: chunks of at least 64 up to 32 rows, of 32 from 33 to
    32768 rows, and of 1024 from 32769 on, where 6 − 16 wraps in uint32;
    one row is cub's scan."""
    assert sfzh_op.scan_chunk(rows, 64) == chunk


def test_scan_chunk_mirrors_atens_loop():
    rows = list(range(2, 300)) + [2 ** k + d for k in range(9, 22)
                                  for d in (-1, 0, 1)]
    for row_size in (1, 2, 7, 16, 31, 32, 33, 48, 63, 64):
        for n in rows:
            assert sfzh_op.scan_chunk(n, row_size) == 2 << (
                _get_log_num_threads_x_inner_scan(n, row_size)), (n, row_size)


def _gate_cases():
    multi = tt.make_synthetic_multiaxis_grid(n_u=3, n_ages=8, n_mets=3,
                                             n_wav=400, lam_min=150.0)
    return {
        "lognormal delta": (lambda: _sim(), "cuda", 65536, True),
        "one row": (lambda: _sim(), "cuda", 1, False),
        "cpu": (lambda: _sim(), "cpu", 65536, False),
        "mega_off": (lambda: _mega_off(_sim()), "cuda", 65536, False),
        "delayed_tau": (lambda: _sim(sfh="delayed_tau"), "cuda", 65536,
                        False),
        "constant": (lambda: _sim(sfh="constant"), "cuda", 65536, False),
        "normal Z": (lambda: _sim(zdist="normal"), "cuda", 65536, False),
        "extra axis": (lambda: _sim(PNAMES + ("ionisation_parameter",),
                                    grid=multi), "cuda", 65536, False),
        "particles": (lambda: _sim(n_particles=64), "cuda", 65536, False),
        "65 ages": (lambda: _sim(grid=tt.make_synthetic_grid(
            n_ages=65, n_mets=4, n_wav=400, lam_min=150.0)), "cuda", 65536,
            False),
    }


def _mega_off(sim):
    sim._mega_off = True
    return sim


@pytest.mark.parametrize("case", list(_gate_cases()))
def test_sfzh_kernel_gate(case):
    """The kernel runs for the lognormal × delta-Z SFZH of more than one
    row on a card and nowhere else."""
    make, device, rows, want = _gate_cases()[case]
    assert make()._sfzh_kernel_runs(rows, torch.device(device)) is want


def test_sfzh_on_the_cpu_takes_the_plain_path():
    sim = _sim()
    before = sfzh_op.lognormal_delta_sfzh.launches
    sfzh, marginal = sim._sfzh(sim.theta_dict(_theta(40)))
    assert sfzh.shape == (40, 768) and marginal.shape == (40, 64)
    assert sfzh_op.lognormal_delta_sfzh.launches == before


@pytest.mark.parametrize("rows", [1, 9, 40])
def test_sfzh_without_the_marginal_keeps_its_bits(rows):
    sim = _sim()
    params = sim.theta_dict(_theta(rows))
    sfzh, marginal = sim._sfzh(params)
    alone, none = sim._sfzh(params, marginal=False)
    assert none is None and torch.equal(sfzh, alone)
    assert torch.equal(marginal, sfzh.reshape(rows, 64, 12).sum(2))


def _op_args(sim, params):
    p = dict(params, max_age=sim._max_age(params))
    mu, tau = sfh.lognormal_shape(p)
    return (p["max_age"], mu[:, 0], tau[:, 0], 10.0 ** params["log10_mass"],
            *sfh.delta_cells(params, sim._log10_mets), sim._sampling.edges,
            sim._log10_mets.shape[0])


@pytest.mark.parametrize("marginal", [True, False])
def test_reference_is_the_plain_sfzh(marginal):
    """The wrapper's plain version (its CPU route) gives `_sfzh`'s generic
    ops' bits, the uniform row and the out-of-grid metallicities
    included."""
    sim = _sim()
    params = sim.theta_dict(_theta(40))
    want, want_m = sim._sfzh(params, marginal=marginal)
    got, got_m = sfzh_op.lognormal_delta_sfzh(*_op_args(sim, params),
                                              marginal=marginal)
    assert torch.equal(got, want)
    assert (got_m is None and want_m is None) or torch.equal(got_m, want_m)
    # the uniform row: its 64 ages alike
    ages = got[8].reshape(64, 12)
    assert torch.equal(ages, ages[:1].expand(64, 12))
    assert ages[0].sum() > 0


def test_spectra_read_the_marginal_and_photometry_asks_for_none(monkeypatch):
    sim = _sim()
    asked = []
    plain = type(sim)._sfzh

    def spy(self, params, marginal=True):
        asked.append(marginal)
        return plain(self, params, marginal=marginal)

    monkeypatch.setattr(type(sim), "_sfzh", spy)
    theta = _theta(6)
    out = sim.simulate(theta, want_spectra=True)
    assert out["sfh_mass"].shape == (6, 64)
    sim.simulate(theta)
    sim.photometry_zsorted_device(theta[torch.argsort(theta[:, 1])],
                                  sub_chunk=8)
    assert asked == [True, False, False]
