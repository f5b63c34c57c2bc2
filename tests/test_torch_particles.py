"""Port parity, particle SFZHs (`n_particles`): the tests of
`tests/test_particles.py` on the port, the counts → SFZH bookkeeping held
exactly against the JAX package's on shared categorical cells, and the
port's own contract for its counter-based draws.

Deliberate difference: the JAX package keys `jax.random.categorical` on
(seed, row index, θ-sum), a stream the port cannot reproduce; the port
hashes (particle_seed, the row's global index, θ's bits, particle number)
(`sed.particle_uniforms`), so a row's realization depends on those alone:
any batch size, any row offset of a resumed run and either device give the
same bits.

Tolerances: bookkeeping exact; convergence to the parametric photometry at
1e5 particles rtol 0.05 and mass conservation rtol 1e-4 (the JAX tests'
bounds); realizations compared bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synference_tpu_torch as tt
from synference_tpu_torch import sed as tsed

NAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
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
def _sim(n_particles=None, seed=0, backend="xla"):
    grid = tt.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    filt = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in
                         zip(_CODES, _CENTERS, _WIDTHS)])
    return tt.BatchSEDSimulator(grid, filt, NAMES, n_particles=n_particles,
                                particle_seed=seed,
                                photometry_backend=backend, device="cpu")


def _theta(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.uniform(8, 10, n), rng.uniform(0.5, 3, n),
        rng.uniform(1e8, 5e8, n), rng.uniform(0.3, 0.8, n),
        rng.uniform(-3, -2, n), rng.uniform(0, 1, n)], axis=1).astype(
            np.float32)


def _sfzh(sim, theta, row_offset=0):
    return sim.simulate(theta, want_spectra=True,
                        row_offset=row_offset)["sfzh"].numpy()


def test_converges_to_parametric():
    theta = _theta(4, 1)
    smooth = _sim().photometry(theta).numpy()
    part = _sim(100_000).photometry(theta).numpy()
    np.testing.assert_allclose(part, smooth, rtol=0.05)


def test_few_particles_add_scatter():
    theta = _theta(8, 2)
    smooth = _sim().photometry(theta).numpy()
    part = _sim(32).photometry(theta).numpy()
    assert np.isfinite(part).all()
    assert (np.abs(part - smooth) / smooth).mean() > 0.01


def test_mass_conserved():
    theta = _theta(3, 3)
    total = _sfzh(_sim(500), theta).sum(axis=1)
    np.testing.assert_allclose(total, 10.0 ** theta[:, 0], rtol=1e-4)


def test_distinct_rows_and_colliding_sums():
    sim = _sim(64)
    row = _theta(1, 4)[0]
    # equal θ in two rows: the row index tells them apart
    same = _sfzh(sim, np.stack([row, row]))
    assert not np.allclose(same[0], same[1])
    # a tiny θ change at the same row index: θ's bits enter the hash
    tiny = row.copy()
    tiny[1] += 1e-3
    assert not np.allclose(_sfzh(sim, row[None]), _sfzh(sim, tiny[None]))
    # two rows whose quantised θ sums collide (the JAX package's regression)
    row2 = row.copy()
    row2[1] += 1e-4
    row2[5] -= 1e-4
    pair = np.stack([row, row2])
    q = (pair * 1e4).astype(np.int64).sum(axis=1)
    assert q[0] == q[1]
    both = _sfzh(sim, pair)
    assert not np.allclose(both[0], both[1])
    # another seed, another realization
    assert not np.array_equal(_sfzh(_sim(64, seed=1), row[None]),
                              _sfzh(sim, row[None]))


def test_realization_independent_of_batching():
    """Rows keep their bits whatever the batch: a split at any offset (a
    resumed run, another batch_size) gives the same SFZH."""
    sim = _sim(100)
    theta = _theta(40, 5)
    whole = _sfzh(sim, theta)
    parts = np.concatenate([_sfzh(sim, theta[i:i + 16], row_offset=i)
                            for i in range(0, 40, 16)])
    np.testing.assert_array_equal(parts, whole)
    shifted = _sfzh(sim, theta[8:], row_offset=8)
    np.testing.assert_array_equal(shifted, whole[8:])
    assert not np.array_equal(_sfzh(sim, theta[8:]), whole[8:])


def test_uniforms_are_counter_based():
    rows = torch.arange(5, 9, dtype=torch.int64)
    theta = torch.as_tensor(_theta(4, 8))
    u = tsed.particle_uniforms(3, rows, theta, 64)
    assert u.dtype == torch.float64 and u.shape == (4, 64)
    assert (u >= 0).all() and (u < 1).all()
    np.testing.assert_array_equal(
        tsed.particle_uniforms(3, rows[2:], theta[2:], 64).numpy(),
        u[2:].numpy())
    big = tsed.particle_uniforms(0, torch.arange(4096),
                                 torch.zeros(4096, 2), 256).numpy().ravel()
    assert abs(big.mean() - 0.5) < 0.005 and abs(big.var() - 1 / 12) < 0.002
    # inverse CDF: zero-weight cells are never drawn, weights are followed
    w = torch.tensor([[0.0, 1.0, 0.0, 3.0]]).expand(2048, -1)
    cells = tsed.particle_cells(w, 0, torch.arange(2048),
                                torch.zeros(2048, 1), 8).numpy()
    frac = np.bincount(cells.ravel(), minlength=4) / cells.size
    assert frac[0] == frac[2] == 0.0 and abs(frac[3] - 0.75) < 0.01


def test_bookkeeping_matches_jax_on_shared_cells():
    """The same categorical cells through both packages' counts → SFZH step
    (the JAX package's `zeros_like(flat).at[cells].add(1) / n`)."""
    rng = np.random.default_rng(6)
    n, c = 37, 160
    cells = rng.integers(0, c, (12, n))
    port = tsed.particle_counts_sfzh(torch.as_tensor(cells), c, n).numpy()
    ref = np.asarray(jax.vmap(
        lambda ce: jnp.zeros(c, jnp.float32).at[ce].add(1.0) / n)(
            jnp.asarray(cells, jnp.int32)))
    np.testing.assert_array_equal(port, ref)


def test_window_engine_and_library_follow_row_indices():
    """The z-sorted window engine numbers rows like `simulate`, and a
    library at two batch sizes gives the same photometry."""
    sim = _sim(50, backend="pallas")
    theta = _theta(512, 7)
    theta = theta[np.argsort(theta[:, 1])]
    dense = sim.photometry(theta, row_offset=3).numpy()
    window = sim.photometry_zsorted_device(theta, sub_chunk=64,
                                           row_offset=3).numpy()
    scale = np.abs(dense).max(axis=1, keepdims=True)
    assert np.median(np.abs(window - dense) / scale) < 2e-3
    prior = {"log10_mass": (8, 10), "redshift": (0.5, 3),
             "peak_age": (1e8, 5e8), "tau": (0.3, 0.8),
             "log10_metallicity": (-3, -2), "tau_v": (0, 1)}
    gen = tt.LibraryGenerator(sim, prior, device="cpu")
    a = gen.generate(300, batch_size=128, seed=2, device_sampling=False)
    b = gen.generate(300, batch_size=64, seed=2, device_sampling=False)
    np.testing.assert_array_equal(a["parameters"], b["parameters"])
    np.testing.assert_allclose(a["photometry"], b["photometry"], rtol=1e-5)
