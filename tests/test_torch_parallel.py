"""The port's `parallel/` on `torch.distributed` with the gloo backend on
the CPU: a world of one rank in this process, and a world of two ranks in
two subprocesses (ranks given by argument, `tcp://localhost`).

Bounds: `sharded_generate` on the z-sorted window engine is bitwise the
single-process `generate(..., device_sampling=False)` at one and at two
ranks (every sub-chunk keeps its rows, its global window plan and its row
offset); the dense route is bitwise at one rank and within float32
rounding at two (the CPU's matmul blocks by batch size). The sharded
training step is bitwise `train_ensemble`'s step at one rank and within
1e-6 of the full-batch step at two, where each rank's gradient is half the
batch's mean: the averaged gradient in norm and the losses, relative; the
weights where the gradient is above 1e-3 of its largest entry (elsewhere
Adam's first step, ±lr·g/(|g| + 1e-8), turns on rounding). Sampling pads ragged objects;
the directory checkpoint ("orbax" backend) round-trips and resumes a
training run to the bits of an uninterrupted one."""

import json
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import synference_tpu_torch as tt
from synference_tpu_torch import parallel as par
from synference_tpu_torch.flows.base import tree_leaves
from synference_tpu_torch.train import (TrainConfig, _EnsembleState,
                                        _npe_loss, load_checkpoint,
                                        save_checkpoint, train_ensemble)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the model and data every rank builds (the workers run this source too)
SETUP = r"""
import numpy as np
import torch
import synference_tpu_torch as tt

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")


def model():
    grid = tt.make_synthetic_grid(n_ages=16, n_mets=4, n_wav=1024)
    codes = ["F115W", "F200W", "F356W", "F444W"]
    fs = tt.FilterSet([tt.tophat_filter(c, ct, w) for c, ct, w in zip(
        codes, [11500., 20000., 35600., 44400.],
        [2600., 4600., 7800., 10200.])])
    sim = tt.BatchSEDSimulator(grid, fs, PNAMES, sfh="lognormal",
                               zdist="delta", emission=tt.EmissionConfig(),
                               device="cpu")
    gen = tt.LibraryGenerator(sim, {
        "log10_mass": (8.0, 10.0), "redshift": (0.5, 1.5),
        "peak_age": (1e8, 5e8), "tau": (0.3, 0.8),
        "log10_metallicity": (-3.0, -2.0), "tau_v": (0.0, 1.0)},
        device="cpu")
    return sim, gen


def batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 2)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))


def flow():
    return tt.build_flow("nsf", 2, 3, hidden_features=8, num_transforms=2,
                         device="cpu")
"""
_ns = {}
exec(SETUP, _ns)
_model, _batch, _flow = _ns["model"], _ns["batch"], _ns["flow"]

N_LIB, BATCH, SEED = 2000, 1024, 3

WORKER = SETUP + r"""
import json
import sys
from synference_tpu_torch import parallel as par
from synference_tpu_torch.flows.base import tree_leaves, tree_map
from synference_tpu_torch.train import (TrainConfig, load_checkpoint,
                                        save_checkpoint)


def flat(params):
    return torch.cat([a.reshape(a.shape[0], -1)
                      for a in tree_leaves(params)], 1).numpy()


rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
assert par.initialize_multihost(f"localhost:{port}", world, rank,
                                device="cpu") == (rank, world)
mesh = par.make_mesh(device="cpu")
sim, gen = model()

lib = par.sharded_generate(gen, n=%d, mesh=mesh, batch_size=%d, seed=%d,
                           out_path=out + ".lib.h5" if rank == 0 else None)
dense = par.sharded_generate(gen, n=%d, mesh=mesh, batch_size=%d, seed=%d,
                             zsorted=False)
tb, xb = batch()
f = flow()
params = par.init_sharded_ensemble(f, torch.Generator().manual_seed(0), tb,
                                   xb, 2, mesh)
step, place = par.make_sharded_train_step(f, mesh,
                                          TrainConfig(learning_rate=1e-3))
p2, s2, losses = step(params, par.init_opt_state(params), place(tb),
                      place(xb))
mesh2 = par.make_mesh((world, 1), ("ensemble", "data"), device="cpu")
mine = par.init_sharded_ensemble(f, torch.Generator().manual_seed(0), tb,
                                 xb, 2, mesh2)
step2, place2 = par.make_sharded_train_step(f, mesh2,
                                            TrainConfig(learning_rate=1e-3))
q2, _, qloss = step2(mine, par.init_opt_state(mine), place2(tb),
                     place2(xb))
post = tt.DirectPosterior(f, tree_map(lambda a: a[0], params),
                          tt.BoxUniform([-3.0, -3.0], [3.0, 3.0], ("a", "b"),
                                        device="cpu"))
samples = par.sharded_sample_batch(post, xb[:13], mesh, n_samples=20)
quant = par.sharded_fit_catalogue(post, xb[:11], mesh, n_samples=40)
save_checkpoint(out + ".ck", {"rank": rank, "a": np.arange(3) + rank},
                backend="orbax")
back = load_checkpoint(out + ".ck", backend="orbax")
np.savez(out + f".{rank}.npz", phot=lib["photometry"],
         theta=lib["parameters"], dense=dense["photometry"],
         dense_theta=dense["parameters"],
         flat=flat(p2), losses=losses.numpy(), m=s2["m"].numpy(),
         member=flat(q2),
         member_loss=qloss.numpy(), samples=samples, quant=quant)
print(json.dumps({"rank": back["rank"], "a": back["a"].tolist()}))
""" % (N_LIB, BATCH, SEED, N_LIB, BATCH, SEED)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one rank in this process, taken down afterwards."""
    assert par.initialize_multihost(f"localhost:{_free_port()}", 1, 0,
                                    device="cpu") == (0, 1)
    yield par.make_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def reference(model):
    """The single-process library of the same n, batch and seed."""
    _, gen = model
    return gen.generate(N_LIB, batch_size=BATCH, seed=SEED,
                        device_sampling=False)


def _flat(params):
    return torch.cat([a.reshape(a.shape[0], -1)
                      for a in tree_leaves(params)], dim=1)


def test_mesh_shapes_and_start_up(mesh):
    assert mesh.mesh_dim_names == ("data",) and mesh.size(0) == 1
    two = par.make_mesh((1, 1), ("ensemble", "data"), device="cpu")
    assert par.mesh.axis_info(two, "ensemble")[:2] == (1, 0)
    assert par.mesh.axis_info(mesh, "ensemble") == (1, 0, None)
    with pytest.raises(ValueError, match="mesh shape"):
        par.make_mesh((3, 2), ("a", "b"), device="cpu")
    # a running group makes start-up a no-op; a missing card is an error
    assert par.initialize_multihost(device="cpu") == (0, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            par.initialize_multihost(device="cuda")
    np.testing.assert_array_equal(
        par.shard_along(np.arange(12).reshape(6, 2), mesh).numpy(),
        np.arange(12).reshape(6, 2))


def test_sharded_generate_equals_generate(mesh, model, reference):
    """zsorted (the default here) bitwise, rows z-ascending, the global
    window plan; the dense route bitwise per batch."""
    sim, gen = model
    lib = par.sharded_generate(gen, n=N_LIB, mesh=mesh, batch_size=BATCH,
                               seed=SEED)
    np.testing.assert_array_equal(lib["parameters"], reference["parameters"])
    np.testing.assert_array_equal(lib["photometry"], reference["photometry"])
    assert np.all(np.diff(lib["parameters"][1]) >= 0)
    dense = par.sharded_generate(gen, n=N_LIB, mesh=mesh, batch_size=BATCH,
                                 seed=SEED, zsorted=False)
    th = dense["parameters"].T
    pad = np.concatenate([th, np.repeat(th[-1:], 2 * BATCH - N_LIB, 0)])
    ref = torch.cat([sim.photometry(torch.as_tensor(pad[i:i + BATCH]), i)
                     for i in (0, BATCH)])[:N_LIB].numpy().T
    np.testing.assert_array_equal(dense["photometry"], ref)


def test_sharded_functions_on_unsorted_rows(mesh, model):
    """The sharded z-sorted function takes rows in any order and answers
    in that order; the sharded dense function is `simulate`'s bits."""
    sim, _ = model
    rng = np.random.default_rng(5)
    theta = torch.as_tensor(np.column_stack([
        rng.uniform(8, 10, 300), rng.uniform(0.5, 1.5, 300),
        rng.uniform(1e8, 5e8, 300), rng.uniform(0.3, 0.8, 300),
        rng.uniform(-3, -2, 300), rng.uniform(0, 1, 300)]).astype(
            np.float32))
    fn = par.make_sharded_zsorted_fn(sim, mesh, sub_chunk=64)
    order = torch.sort(theta[:, 1], stable=True).indices
    ref = sim.photometry_zsorted_device(theta[order], sub_chunk=64)
    out = fn(theta)["photometry_njy"]
    assert torch.equal(out[order], ref)
    dense = par.make_sharded_photometry_fn(sim, mesh)(theta)
    assert torch.equal(dense["photometry_njy"], sim.photometry(theta))


def test_sharded_train_step_is_the_trainers_step(mesh):
    """At one rank the step (all_reduce over "data" included) is
    `_EnsembleState.train_step` on the same batch, bit for bit."""
    tb, xb = _batch()
    flow = _flow()
    params = par.init_sharded_ensemble(flow, torch.Generator().manual_seed(0),
                                       tb, xb, 2, mesh)
    cfg = TrainConfig(learning_rate=1e-3)
    state = _EnsembleState(
        flow.init(torch.Generator().manual_seed(0), tb, xb, n_members=2),
        torch.full((2,), 1e-3), cfg)
    assert torch.equal(state.flat, _flat(params))
    step, place = par.make_sharded_train_step(flow, mesh, cfg)
    opt = par.init_opt_state(params)
    for _ in range(2):
        params, opt, losses = step(params, opt, place(tb), place(xb))
        ref = state.train_step(_npe_loss(flow),
                               torch.as_tensor(tb).expand(2, -1, -1),
                               torch.as_tensor(xb).expand(2, -1, -1))
        assert torch.equal(losses, ref)
    assert torch.equal(_flat(params), state.flat)
    assert opt["step"] == 2 and torch.equal(opt["m"], state.m)


def _posterior(params, flow):
    from synference_tpu_torch.flows.base import tree_map

    return tt.DirectPosterior(flow, tree_map(lambda a: a[0], params),
                              tt.BoxUniform([-3.0, -3.0], [3.0, 3.0],
                                            ("a", "b"), device="cpu"))


def test_sharded_sampling_pads_ragged_objects(mesh):
    tb, xb = _batch()
    flow = _flow()
    post = _posterior(flow.init(torch.Generator().manual_seed(0), tb, xb,
                                n_members=1), flow)
    s = par.sharded_sample_batch(post, xb[:13], mesh, n_samples=100, seed=5)
    assert s.shape == (13, 100, 2)
    ref, _ = post.sample_batch_with_acceptance(
        torch.as_tensor(xb[:13]), 100, torch.Generator().manual_seed(5), 4)
    np.testing.assert_array_equal(s, ref.numpy())
    assert (np.abs(s) <= 3.0 + 1e-6).all()
    q = par.sharded_fit_catalogue(post, xb[:11], mesh, n_samples=400, seed=9)
    assert q.shape == (11, 3, 2)
    assert (q[:, 0] <= q[:, 1]).all() and (q[:, 1] <= q[:, 2]).all()
    ref, _ = post.sample_batch_with_acceptance(
        torch.as_tensor(xb[:11]), 400, torch.Generator().manual_seed(9))
    q_ref = torch.quantile(ref, torch.tensor([0.16, 0.5, 0.84]), dim=1)
    np.testing.assert_array_equal(q, q_ref.movedim(0, 1).numpy())
    assert par.pad_objects(xb[:13], 4)[0].shape == (16, 3)


def test_directory_checkpoint_roundtrip_and_resume(mesh, tmp_path):
    """The "orbax" backend (a directory of per-rank `torch.save` files)
    round-trips a state, and a run interrupted after its epoch-2
    checkpoint resumes to the bits of an uninterrupted run."""
    path = str(tmp_path / "state")
    save_checkpoint(path, {"a": np.arange(4), "t": torch.ones(2)},
                    backend="orbax")
    save_checkpoint(path, {"a": np.arange(5), "t": torch.ones(3)},
                    backend="orbax")  # replaces the first
    back = load_checkpoint(path, backend="orbax")
    np.testing.assert_array_equal(back["a"], np.arange(5))
    assert not pathlib.Path(path + ".tmp-new").exists()
    with pytest.raises(ValueError, match="backend"):
        save_checkpoint(path, {}, backend="tensorstore")

    tb, xb = _batch(400, 1)
    kw = dict(max_epochs=5, stop_after_epochs=50, batch_size=128,
              learning_rate=5e-3)
    plain = train_ensemble(_flow(), tb, xb, torch.Generator().manual_seed(7),
                           TrainConfig(**kw), n_nets=2)
    ck = str(tmp_path / "ck")
    cfg = TrainConfig(checkpoint_path=ck, checkpoint_every=2,
                      checkpoint_backend="orbax", **kw)

    def crash(epoch, tr, va):
        if epoch >= 3:
            raise RuntimeError("simulated worker death")
        return False

    with pytest.raises(RuntimeError, match="worker death"):
        train_ensemble(_flow(), tb, xb, torch.Generator().manual_seed(7),
                       cfg, n_nets=2, epoch_callback=crash)
    assert (pathlib.Path(ck) / "rank00000-of-00001.pt").exists()
    resumed = train_ensemble(_flow(), tb, xb,
                             torch.Generator().manual_seed(7), cfg, n_nets=2)
    np.testing.assert_array_equal(resumed.val_losses, plain.val_losses)
    assert torch.equal(_flat(resumed.params), _flat(plain.params))
    assert not pathlib.Path(ck).exists()


def test_two_process_gloo_group(model, reference, tmp_path):
    """Two ranks: the library bitwise the single-process one (rank 0
    alone writes the file), the dense route within float32 rounding, the
    data-parallel step within 1e-6 of the full-batch step, the
    ensemble-parallel step each rank's member of it, padded sampling and
    per-rank checkpoints."""
    port = _free_port()
    out = str(tmp_path / "w")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(port), out],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT)}) for r in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
    for r, (o, _) in enumerate(outs):
        assert json.loads(o.strip().splitlines()[-1]) == {
            "rank": r, "a": [r, r + 1, r + 2]}
    res = [np.load(f"{out}.{r}.npz") for r in (0, 1)]
    for r in res:
        np.testing.assert_array_equal(r["theta"], reference["parameters"])
        np.testing.assert_array_equal(r["phot"], reference["photometry"])
        np.testing.assert_array_equal(r["dense"], res[0]["dense"])
        np.testing.assert_array_equal(r["flat"], res[0]["flat"])
    try:
        import h5py  # noqa: F401
    except ImportError:
        pass
    else:  # rank 0 alone wrote the library file
        assert pathlib.Path(out + ".lib.h5").exists()
    sim, _ = model
    th = res[0]["dense_theta"].T
    ref = sim.photometry(torch.as_tensor(th)).numpy().T
    np.testing.assert_allclose(res[0]["dense"], ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    # the data-parallel step against the full-batch step in one process
    tb, xb = _batch()
    flow = _flow()
    state = _EnsembleState(
        flow.init(torch.Generator().manual_seed(0), tb, xb, n_members=2),
        torch.full((2,), 1e-3), TrainConfig(learning_rate=1e-3))
    loss = state.train_step(_npe_loss(flow),
                            torch.as_tensor(tb).expand(2, -1, -1),
                            torch.as_tensor(xb).expand(2, -1, -1))
    full = state.flat.numpy()
    # Adam's first moment after one step is 0.1 × the (averaged) gradient
    m, m_full = res[0]["m"], state.m.numpy()
    assert np.linalg.norm(m - m_full) / np.linalg.norm(m_full) < 1e-6
    # the first step moves each weight by ±lr·g/(|g| + 1e-8): where g is
    # near zero that ratio turns on rounding, so hold the weights where
    # the gradient is not
    big = np.abs(m_full) > 1e-3 * np.abs(m_full).max()
    np.testing.assert_allclose(res[0]["flat"][big], full[big], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(res[0]["losses"], loss.numpy(), rtol=1e-6)
    # ensemble-parallel: rank r trained member r on the whole batch
    for r in (0, 1):
        np.testing.assert_allclose(res[r]["member"][0], full[r], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(res[r]["member_loss"],
                                   loss.numpy()[r:r + 1], rtol=1e-6)
    assert res[0]["samples"].shape == (13, 20, 2)
    np.testing.assert_array_equal(res[0]["samples"], res[1]["samples"])
    assert res[0]["quant"].shape == (11, 3, 2)
