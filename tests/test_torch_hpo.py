"""The port's HPO (`synference_tpu_torch/hpo.py`): the JAX package's
`tests/test_hpo.py` cases on the port, the trial sequence against the JAX
`Study` (the same seed and tells give the same parameters, exactly: both
are the same host numpy), `optimize_sbi` through the port's fitter with a
pruner that cuts trials mid-run, `sweep_learning_rates` as one
`train_ensemble` call, and the config's `optuna:` block.

One deliberate difference: the JAX `optimize_sbi` scores any
`(ValueError, RuntimeError)` as a FAIL trial; the port re-raises a CUDA
error (torch raises those as `RuntimeError`, `torch.OutOfMemoryError` or
`torch.AcceleratorError`), since the card's state is not to be trusted
after one."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from synference_tpu import hpo as jhpo
from synference_tpu_torch import hpo
from synference_tpu_torch.hpo import MedianPruner, SearchSpace, Study


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestSearchSpace:
    def test_random_sampling_respects_bounds(self):
        sp = SearchSpace({
            "h": ("int", 10, 100),
            "lr": ("float", 1e-5, 1e-2, "log"),
            "bs": ("categorical", [64, 128]),
        })
        rng = np.random.default_rng(0)
        for _ in range(50):
            s = sp.sample_random(rng)
            assert 10 <= s["h"] <= 100
            assert 1e-5 <= s["lr"] <= 1e-2
            assert s["bs"] in (64, 128)

    def test_unit_roundtrip(self):
        sp = SearchSpace({"lr": ("float", 1e-5, 1e-2, "log")})
        u = sp._to_unit("lr", 1e-3)
        assert np.isclose(sp._from_unit("lr", u), 1e-3, rtol=1e-6)


def _objective(p):
    return ((p["x"] - 2.0) ** 2 + np.log10(p["lr"] / 1e-3) ** 2
            + 0.1 * p["h"] / 100 + (0.0 if p["bs"] == 128 else 0.5))


@pytest.mark.parametrize("seed", [0, 3])
def test_trial_sequence_equals_the_jax_study(seed):
    """40 trials (8 random, then TPE) over float, log-float, int and
    categorical dims: the port's parameters equal the JAX Study's."""
    spec = {"x": ("float", -5.0, 5.0), "lr": ("float", 1e-5, 1e-1, "log"),
            "h": ("int", 10, 100), "bs": ("categorical", [64, 128, 256])}
    studies = [mod.Study(space=mod.SearchSpace(spec), seed=seed,
                         n_startup_trials=8) for mod in (hpo, jhpo)]
    for _ in range(40):
        trials = [s.ask() for s in studies]
        assert trials[0]["params"] == trials[1]["params"]
        for s, t in zip(studies, trials):
            s.tell(t, _objective(t["params"]))
    assert studies[0].best_trial["params"] == studies[1].best_trial["params"]


class TestStudy:
    def _run_study(self, storage=None, n=30, seed=0):
        sp = SearchSpace({"x": ("float", -5.0, 5.0),
                          "y": ("float", -5.0, 5.0)})
        study = Study(space=sp, storage=storage, seed=seed,
                      n_startup_trials=8)
        for _ in range(n):
            t = study.ask()
            value = (t["params"]["x"] - 2.0) ** 2 + (t["params"]["y"] + 1.0) ** 2
            study.tell(t, value)
        return study

    def test_tpe_converges_toward_optimum(self):
        study = self._run_study(n=60)
        assert study.best_trial["value"] < 1.0
        late = [t["params"]["x"] for t in study.trials[40:]]
        assert abs(np.median(late) - 2.0) < 2.0

    def test_json_persistence(self, tmp_path):
        path = str(tmp_path / "study.json")
        s1 = self._run_study(storage=path, n=12)
        s2 = Study(space=s1.space, storage=path)
        assert len(s2.trials) == 12
        assert s2.best_trial["value"] == s1.best_trial["value"]

    def test_sqlite_multiworker(self, tmp_path):
        path = str(tmp_path / "study.db")
        s1 = self._run_study(storage=path, n=10, seed=0)
        s2 = Study(space=s1.space, storage=path, seed=1)
        t = s2.ask()
        assert t["number"] == 10
        s2.tell(t, 123.0)
        assert len(Study(space=s1.space, storage=path).trials) == 11

    def test_study_files_are_shared_with_the_jax_package(self, tmp_path):
        """A sqlite study written by the port resumes in the JAX package
        and the other way round (one schema, JSON payloads)."""
        path = str(tmp_path / "shared.db")
        s1 = self._run_study(storage=path, n=6)
        js = jhpo.Study(space=jhpo.SearchSpace(s1.space.spec), storage=path,
                        seed=2)
        t = js.ask()
        assert t["number"] == 6
        js.tell(t, 5.0)
        back = Study(space=s1.space, storage=path)
        assert [u["number"] for u in back.trials] == list(range(7))

    def test_retry_stale_reclaims_dead_worker_trial(self, tmp_path):
        path = str(tmp_path / "study.db")
        sp = SearchSpace({"x": ("float", -5.0, 5.0)})
        w1 = Study(space=sp, storage=path, seed=0)
        t_dead = w1.ask()  # the worker "crashes": its trial stays RUNNING
        w1.report_intermediate(t_dead, 0, 9.9)
        t_dead["heartbeat"] = 0.0
        w1._persist(t_dead)
        w2 = Study(space=sp, storage=path, seed=1)
        assert w2.retry_stale(grace_period=60.0) == 1
        dead = [t for t in w2.trials if t["number"] == t_dead["number"]][0]
        assert dead["state"] == "FAILED" and dead["retried"]
        t_retry = w2.ask()
        assert t_retry["params"] == t_dead["params"]
        t_live = w2.ask()
        w2.report_intermediate(t_live, 0, 1.0)
        assert w2.retry_stale(grace_period=60.0) == 0

    def test_swap_if_unchanged_loses_to_a_newer_payload(self, tmp_path):
        """The compare-and-swap lands only on the payload it read."""
        import json

        path = str(tmp_path / "cas.db")
        st = Study(space=SearchSpace({"x": ("float", 0.0, 1.0)}),
                   storage=path)
        t = st.ask()
        old = json.dumps(t)
        st.report_intermediate(t, 0, 1.0)  # someone else moved it on
        assert not st._swap_if_unchanged(t["number"], old, dict(t, x=1))
        assert st._swap_if_unchanged(t["number"], json.dumps(t),
                                     dict(t, state="FAILED"))


class TestPruner:
    def test_median_pruner(self):
        study = Study(space=SearchSpace({"x": ("float", 0.0, 1.0)}),
                      n_startup_trials=1)
        pruner = MedianPruner(n_startup_trials=3, n_warmup_steps=1)
        for _ in range(5):
            t = study.ask()
            for step in range(5):
                study.report_intermediate(t, step, 1.0)
            study.tell(t, 1.0)
        study.ask()
        assert not pruner.should_prune(0, 5.0, study)
        assert pruner.should_prune(3, 5.0, study)
        assert not pruner.should_prune(3, 0.5, study)

    def test_percentile_pruner_stricter_than_median(self):
        study = Study(space=SearchSpace({"x": ("float", 0.0, 1.0)}),
                      n_startup_trials=1)
        for v in (1.0, 2.0, 3.0, 4.0, 5.0):
            t = study.ask()
            for step in range(4):
                study.report_intermediate(t, step, v)
            study.tell(t, v)
        strict = hpo.PercentilePruner(25.0, n_startup_trials=3,
                                      n_warmup_steps=1)
        median = MedianPruner(n_startup_trials=3, n_warmup_steps=1)
        assert strict.should_prune(2, 2.5, study)
        assert not median.should_prune(2, 2.5, study)

    def test_threshold_pruner(self):
        study = Study(space=SearchSpace({"x": ("float", 0.0, 1.0)}))
        p = hpo.ThresholdPruner(upper=10.0, n_warmup_steps=2)
        assert not p.should_prune(0, 99.0, study)
        assert p.should_prune(3, 11.0, study)
        assert not p.should_prune(3, 9.0, study)
        assert p.should_prune(3, float("nan"), study)
        with pytest.raises(ValueError):
            hpo.ThresholdPruner()

    def test_successive_halving_rungs(self):
        study = Study(space=SearchSpace({"x": ("float", 0.0, 1.0)}),
                      n_startup_trials=1)
        for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
            t = study.ask()
            for step in (0, 1, 3):
                study.report_intermediate(t, step, v)
            study.tell(t, v)
        p = hpo.SuccessiveHalvingPruner(min_resource=1, reduction_factor=2)
        assert not p.should_prune(2, 9.0, study)
        assert p.should_prune(1, 5.5, study)
        assert not p.should_prune(1, 1.5, study)
        with pytest.raises(ValueError):
            hpo.SuccessiveHalvingPruner(reduction_factor=1)

    def test_hyperband_brackets_differ(self):
        study = Study(space=SearchSpace({"x": ("float", 0.0, 1.0)}),
                      n_startup_trials=1)
        for v in (1.0, 2.0, 3.0, 4.0):
            t = study.ask()
            for step in range(9):
                study.report_intermediate(t, step, v)
            study.tell(t, v)
        p = hpo.HyperbandPruner(min_resource=1, max_resource=9,
                                reduction_factor=3)
        assert len(p._shas) == 3
        assert p.should_prune(0, 9.0, study, {"number": 0})
        assert not p.should_prune(0, 9.0, study, {"number": 2})
        assert p.should_prune(8, 9.0, study, {"number": 2})

    def test_patient_pruner_holds_while_improving(self):
        study = Study(space=SearchSpace({"x": ("float", 0.0, 1.0)}))
        p = hpo.PatientPruner(hpo.ThresholdPruner(upper=0.0), patience=2)
        improving = {"number": 0,
                     "intermediate": {"0": 5.0, "1": 4.0, "2": 3.0}}
        stagnant = {"number": 1,
                    "intermediate": {"0": 3.0, "1": 3.0, "2": 3.0}}
        assert not p.should_prune(2, 3.0, study, improving)
        assert p.should_prune(2, 3.0, study, stagnant)


def _fitter(n=1500, seed=0):
    from synference_tpu_torch.fitter import SBIFitter

    rng = np.random.default_rng(seed)
    theta = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    x = theta @ rng.standard_normal((2, 3)).astype(np.float32)
    x = x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    fitter = SBIFitter(photometry=np.abs(x) + 1.0, parameters=theta,
                       parameter_names=("a", "b"),
                       filter_codes=("F1", "F2", "F3"), device="cpu")
    fitter.features = x
    fitter.feature_params = theta
    fitter.feature_source = np.arange(len(x))
    fitter.create_priors()
    return fitter


def test_pruning_aborts_training_midrun():
    """A pruned trial trains FEWER epochs than max_epochs: its
    intermediate reports stop at the abort, at least one before early
    stopping (patience 10) could have fired."""
    max_epochs = 12
    study, best = hpo.optimize_sbi(
        _fitter(), model_type="mdn",
        search_space={
            "hidden_features": ("categorical", [16]),
            "num_components": ("categorical", [3]),
            "learning_rate": ("float", 1e-6, 1e-1, "log"),
        },
        n_trials=10, max_epochs=max_epochs, verbose=False,
        pruner=MedianPruner(n_startup_trials=2, n_warmup_steps=1))
    pruned = [t for t in study.trials if t["state"] == "PRUNED"]
    assert pruned, "no trial was pruned"
    for t in pruned:
        assert len(t["intermediate"]) < max_epochs
    assert min(len(t["intermediate"]) for t in pruned) <= 10
    assert best is not None


def test_zoo_search_space():
    """The "zoo" space searches the model family itself; trials with
    transform-free models (mdn) must not leak num_transforms."""
    assert "model_type" in hpo.DEFAULT_SEARCH_SPACES["zoo"]
    assert hpo.DEFAULT_SEARCH_SPACES == jhpo.DEFAULT_SEARCH_SPACES
    space = dict(hpo.DEFAULT_SEARCH_SPACES["zoo"])
    space["model_type"] = ("categorical", ["mdn", "maf", "realnvp"])
    space["hidden_features"] = ("categorical", [16])
    space["num_transforms"] = ("categorical", [2])
    study, _ = hpo.optimize_sbi(_fitter(1200, 1), model_type="zoo",
                                search_space=space, n_trials=4, max_epochs=3,
                                verbose=False)
    assert len(study.trials) == 4
    assert all(t["state"] in ("COMPLETE", "PRUNED") for t in study.trials)


class _FailingFitter:
    """Raises `errors` in turn from `run_single_sbi`, then trains nothing
    and reports a fixed validation loss."""

    def __init__(self, errors):
        self.errors = list(errors)

    def run_single_sbi(self, **kw):
        if self.errors:
            raise self.errors.pop(0)

        class Result:
            val_losses = np.array([[1.0], [0.5]])
            history = {"pruned": False}

        return Result()


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
])
def test_cuda_errors_propagate_other_errors_fail_the_trial(error):
    """A RuntimeError or ValueError of the trial is a FAIL, as in the JAX
    package; a CUDA error (the port's difference) propagates."""
    space = {"learning_rate": ("float", 1e-4, 1e-2, "log")}
    study, best = hpo.optimize_sbi(
        _FailingFitter([RuntimeError("diverged"), ValueError("bad")]),
        search_space=space, n_trials=3, verbose=False)
    assert [t["state"] for t in study.trials] == ["FAIL", "FAIL", "COMPLETE"]
    assert best == study.trials[2]["params"]
    with pytest.raises(type(error), match="CUDA"):
        hpo.optimize_sbi(_FailingFitter([error]), search_space=space,
                         n_trials=2, verbose=False)
    assert hpo._is_cuda_error(error)
    assert not hpo._is_cuda_error(RuntimeError("diverged"))


def test_sweep_learning_rates_one_training_run():
    """K learning rates train as the members of one `train_ensemble`
    call: a sane rate beats an absurdly small one, the members differ, and
    the winner's parameters are its row of the stacked leaves."""
    from synference_tpu_torch.flows.base import build_flow, tree_leaves
    from synference_tpu_torch.train import TrainConfig

    rng = np.random.default_rng(3)
    theta = rng.uniform(-1, 1, (800, 2)).astype(np.float32)
    x = (theta @ rng.standard_normal((2, 3)).astype(np.float32)
         + 0.05 * rng.standard_normal((800, 3)).astype(np.float32))
    flow = build_flow("mdn", 2, 3, hidden_features=16, num_components=2,
                      device="cpu")
    lrs = [1e-9, 3e-3]
    out = hpo.sweep_learning_rates(
        flow, theta, x, lrs,
        config=TrainConfig(max_epochs=8, stop_after_epochs=8,
                           batch_size=128),
        generator=torch.Generator().manual_seed(0))
    assert out["best_val"].shape == (2,)
    assert out["best_index"] == 1 and out["best_lr"] == lrs[1]
    res = out["result"]
    assert res.history["member_learning_rates"] == lrs
    leaf = tree_leaves(res.params)[0]
    assert not torch.allclose(leaf[0], leaf[1])
    assert torch.equal(tree_leaves(out["params"])[0], leaf[1])


def test_run_from_config_with_an_optuna_block(tmp_path):
    """`train_args.optuna` runs the study (YAML-style lists for the search
    space), keeps it on the fitter and retrains the best trial."""
    import synference_tpu_torch as tt

    fitter = _fitter(600, 2)
    cfg = {"max_epochs": 3, "train_args": {
        "skip_optimization": False,
        "fixed_params": {"model_choice": "mdn"},
        "optuna": {"n_trials": 3,
                   "pruner": {"type": "Median", "n_startup_trials": 1,
                              "n_warmup_steps": 1},
                   "search_space": {
                       "hidden_features": ["categorical", [8]],
                       "num_components": ["categorical", [2]],
                       "learning_rate": ["float", 1e-3, 1e-2, "log"]},
                   "study": {"storage": str(tmp_path / "study.db")}}},
        "output": str(tmp_path / "m.pkl")}
    out = tt.run_from_config(cfg, fitter=fitter, device="cpu")
    assert len(out.hpo_study.trials) == 3
    best = out.hpo_study.best_trial["params"]
    assert out.flow.model == "mdn"
    assert out.train_result.n_members == 1
    assert (tmp_path / "m.pkl").exists()
    assert best["hidden_features"] == 8


class TestSqliteRace:
    def test_two_process_concurrent_workers(self, tmp_path):
        """Two OS processes ask/tell against one sqlite study at once:
        trial numbers unique, every tell recorded."""
        import pathlib

        repo = str(pathlib.Path(__file__).resolve().parents[1])
        path = str(tmp_path / "race.db")
        worker_src = (
            "import sys\n"
            "sys.path.insert(0, {repo!r})\n"
            "from synference_tpu_torch.hpo import SearchSpace, Study\n"
            "sp = SearchSpace({{'x': ('float', 0.0, 4.0)}})\n"
            "st = Study(space=sp, storage={path!r}, seed={seed})\n"
            "for _ in range(12):\n"
            "    t = st.ask()\n"
            "    st.tell(t, (t['params']['x'] - 2.0) ** 2)\n"
            "print('worker-done', flush=True)\n"
        )
        procs = [
            subprocess.Popen(
                [sys.executable, "-c",
                 worker_src.format(repo=repo, path=path, seed=s)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for s in (0, 1)
        ]
        outs = [p.communicate(timeout=300) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err.decode()[-800:]
            assert b"worker-done" in out
        final = Study(space=SearchSpace({"x": ("float", 0.0, 4.0)}),
                      storage=path)
        done = [t for t in final.trials if t.get("value") is not None]
        numbers = [t["number"] for t in final.trials]
        assert len(done) == 24
        assert len(set(numbers)) == len(numbers), "duplicate trial numbers"
