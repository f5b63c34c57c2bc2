"""Hyperparameter optimisation: a native TPE-style study with pruning.

Counterpart of `synference_tpu/hpo.py` (the reference's Optuna machinery:
`optimize_sbi`, per-model search spaces, median/hyperband pruners, RDB
storage). The study, its sampler and its pruners are host numpy and the
same code as the JAX package's, so one seed and one sequence of `tell`
values give the same trial parameters in both packages:

- a `Study` with ask/tell, JSON-file or sqlite3 persistence (several
  workers share one sqlite database, WAL mode with retries),
- random warm-up, then a TPE-style sampler (quantile split, per-dimension
  kernel density ratio),
- the pruner family over intermediate values: `MedianPruner` /
  `PercentilePruner`, `SuccessiveHalvingPruner` (ASHA rungs),
  `HyperbandPruner` (staggered brackets), `ThresholdPruner`,
  `PatientPruner` (an improvement hold around another pruner),
- `optimize_sbi(fitter, ...)` with the objectives "val_loss",
  "log_prob-pit" and "tarp", and `sweep_learning_rates`, K learning rates
  trained as the members of one `train_ensemble` call.

One difference from the JAX package: `optimize_sbi` scores a trial that
raises `ValueError` or `RuntimeError` as FAIL, but a CUDA error (also a
`RuntimeError` in torch: out of memory, an illegal access, a failed launch)
propagates, since the card's state is not to be trusted after one.
"""

from __future__ import annotations

import json
import math
import os
import sqlite3
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "SearchSpace",
    "Study",
    "MedianPruner",
    "PercentilePruner",
    "ThresholdPruner",
    "SuccessiveHalvingPruner",
    "HyperbandPruner",
    "PatientPruner",
    "optimize_sbi",
    "sweep_learning_rates",
    "DEFAULT_SEARCH_SPACES",
]


# ---------------------------------------------------------------------------
# search space
# ---------------------------------------------------------------------------


class SearchSpace:
    """Named dims: ("int", lo, hi) | ("float", lo, hi[, "log"]) |
    ("categorical", [choices])."""

    def __init__(self, spec: dict):
        self.spec = dict(spec)

    def sample_random(self, rng: np.random.Generator) -> dict:
        out = {}
        for name, d in self.spec.items():
            kind = d[0]
            if kind == "int":
                out[name] = int(rng.integers(d[1], d[2] + 1))
            elif kind == "float":
                log = len(d) > 3 and d[3] == "log"
                if log:
                    out[name] = float(
                        np.exp(rng.uniform(np.log(d[1]), np.log(d[2])))
                    )
                else:
                    out[name] = float(rng.uniform(d[1], d[2]))
            elif kind == "categorical":
                out[name] = d[1][int(rng.integers(len(d[1]))) ]
            else:
                raise ValueError(kind)
        return out

    def _to_unit(self, name, value):
        d = self.spec[name]
        if d[0] == "int":
            return (value - d[1]) / max(d[2] - d[1], 1)
        if d[0] == "float":
            if len(d) > 3 and d[3] == "log":
                return (math.log(value) - math.log(d[1])) / (
                    math.log(d[2]) - math.log(d[1])
                )
            return (value - d[1]) / (d[2] - d[1])
        return d[1].index(value) / max(len(d[1]) - 1, 1)

    def _from_unit(self, name, u):
        d = self.spec[name]
        u = min(max(u, 0.0), 1.0)
        if d[0] == "int":
            return int(round(d[1] + u * (d[2] - d[1])))
        if d[0] == "float":
            if len(d) > 3 and d[3] == "log":
                return float(
                    math.exp(math.log(d[1]) + u * (math.log(d[2]) - math.log(d[1])))
                )
            return float(d[1] + u * (d[2] - d[1]))
        idx = int(round(u * (len(d[1]) - 1)))
        return d[1][idx]


# ---------------------------------------------------------------------------
# pruners
# ---------------------------------------------------------------------------


class PercentilePruner:
    """Prune a trial whose intermediate value is worse than the given
    percentile of completed trials at the same step (reference exposes
    optuna's pruner family, custom_runner.py:216-230; minimize direction,
    so percentile 25.0 keeps only the best quartile)."""

    def __init__(self, percentile: float = 50.0, n_startup_trials: int = 5,
                 n_warmup_steps: int = 3):
        self.percentile = float(percentile)
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, step: int, value: float, study: "Study",
                     trial: dict | None = None) -> bool:
        if step < self.n_warmup_steps:
            return False
        completed = [t for t in study.trials if t["state"] == "COMPLETE"]
        if len(completed) < self.n_startup_trials:
            return False
        at_step = [
            t["intermediate"][str(step)]
            for t in completed
            if str(step) in t.get("intermediate", {})
        ]
        if len(at_step) < self.n_startup_trials:
            return False
        return value > float(np.percentile(at_step, self.percentile))


class MedianPruner(PercentilePruner):
    """Percentile 50 (reference default pruner, custom_runner.py:216-230)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 3):
        super().__init__(50.0, n_startup_trials, n_warmup_steps)


class ThresholdPruner:
    """Prune when the intermediate value crosses a fixed bound (reference:
    optuna ThresholdPruner, custom_runner.py:216-230). For minimize-style
    val losses `upper` kills diverging trials early; `lower` stops
    too-good-to-be-true NaN-adjacent objectives."""

    def __init__(self, upper: float | None = None,
                 lower: float | None = None, n_warmup_steps: int = 0):
        if upper is None and lower is None:
            raise ValueError("ThresholdPruner needs upper and/or lower")
        self.upper = upper
        self.lower = lower
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, step: int, value: float, study: "Study",
                     trial: dict | None = None) -> bool:
        if step < self.n_warmup_steps:
            return False
        if not np.isfinite(value):
            return True
        if self.upper is not None and value > self.upper:
            return True
        return self.lower is not None and value < self.lower


class SuccessiveHalvingPruner:
    """Asynchronous successive halving (ASHA semantics, like optuna's):
    rungs at min_resource·reduction_factor^k epochs; at each rung a trial
    survives only in the top 1/reduction_factor of every value ever
    reported at that rung."""

    def __init__(self, min_resource: int = 1, reduction_factor: int = 4):
        self.min_resource = max(int(min_resource), 1)
        self.rf = int(reduction_factor)
        if self.rf < 2:  # rf<=1 would spin _is_rung's while-loop forever
            raise ValueError(
                f"reduction_factor must be >= 2, got {reduction_factor}")

    def _is_rung(self, step: int) -> bool:
        r = self.min_resource
        while r < step + 1:
            r *= self.rf
        return r == step + 1  # steps are 0-based epochs

    def should_prune(self, step: int, value: float, study: "Study",
                     trial: dict | None = None) -> bool:
        if not self._is_rung(step):
            return False
        at_step = [
            t["intermediate"][str(step)]
            for t in study.trials
            if str(step) in t.get("intermediate", {})
        ]
        if len(at_step) < self.rf:
            return False
        cut = float(np.percentile(at_step, 100.0 / self.rf))
        return value > cut


class HyperbandPruner:
    """Brackets of successive halving with staggered minimum resources
    (reference: optuna HyperbandPruner, custom_runner.py:216-230). A
    trial's bracket is its study number mod the bracket count, so
    aggressive and conservative brackets interleave."""

    def __init__(self, min_resource: int = 1, max_resource: int = 60,
                 reduction_factor: int = 3):
        self.rf = int(reduction_factor)
        if self.rf < 2:  # rf<=1 would spin the bracket loop below forever
            raise ValueError(
                f"reduction_factor must be >= 2, got {reduction_factor}")
        n_brackets = 1
        r = int(min_resource)
        while r * self.rf <= int(max_resource):
            r *= self.rf
            n_brackets += 1
        self._shas = [
            SuccessiveHalvingPruner(int(min_resource) * self.rf**s, self.rf)
            for s in range(n_brackets)
        ]

    def should_prune(self, step: int, value: float, study: "Study",
                     trial: dict | None = None) -> bool:
        num = (trial["number"] if trial is not None
               else max(len(study.trials) - 1, 0))
        sha = self._shas[num % len(self._shas)]
        return sha.should_prune(step, value, study, trial)


class PatientPruner:
    """Wrap another pruner; hold its verdict while the trial is still
    improving (no prune as long as the last `patience` reports improved by
    more than `min_delta` — optuna PatientPruner semantics)."""

    def __init__(self, wrapped, patience: int = 3, min_delta: float = 0.0):
        self.wrapped = wrapped
        self.patience = int(patience)
        self.min_delta = float(min_delta)

    def should_prune(self, step: int, value: float, study: "Study",
                     trial: dict | None = None) -> bool:
        if trial is not None:
            hist = [trial["intermediate"][k]
                    for k in sorted(trial.get("intermediate", {}),
                                    key=int)]
            if len(hist) <= self.patience:
                return False
            recent = hist[-(self.patience + 1):]
            if min(recent[:-1]) - recent[-1] > self.min_delta:
                return False  # still improving: stay patient
        if self.wrapped is None:
            return trial is not None
        return self.wrapped.should_prune(step, value, study, trial)


# ---------------------------------------------------------------------------
# study + TPE-lite sampler
# ---------------------------------------------------------------------------


@dataclass
class Study:
    """Minimize-direction study with optional shared persistence."""

    space: SearchSpace
    storage: str | None = None  # .json or .db/.sqlite path
    seed: int = 0
    n_startup_trials: int = 10
    gamma: float = 0.25  # TPE good-quantile
    trials: list = field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.storage:
            self._init_storage()
            self._load()

    # -- persistence -----------------------------------------------------
    def _is_sql(self):
        return self.storage and self.storage.endswith((".db", ".sqlite"))

    def _init_storage(self):
        if self._is_sql():
            with self._conn() as con:
                con.execute(
                    "CREATE TABLE IF NOT EXISTS trials ("
                    "number INTEGER PRIMARY KEY, payload TEXT)"
                )

    def _conn(self):
        con = sqlite3.connect(self.storage, timeout=30.0)
        con.execute("PRAGMA journal_mode=WAL")
        return con

    def _load(self):
        if self._is_sql():
            with self._conn() as con:
                rows = con.execute(
                    "SELECT payload FROM trials ORDER BY number"
                ).fetchall()
            self.trials = [json.loads(r[0]) for r in rows]
        elif os.path.exists(self.storage):
            with open(self.storage) as f:
                self.trials = json.load(f)

    def _persist(self, trial):
        if not self.storage:
            return
        for attempt in range(5):
            try:
                if self._is_sql():
                    with self._conn() as con:
                        con.execute(
                            "INSERT OR REPLACE INTO trials VALUES (?, ?)",
                            (trial["number"], json.dumps(trial)),
                        )
                else:
                    with open(self.storage, "w") as f:
                        json.dump(self.trials, f)
                return
            except sqlite3.OperationalError:
                time.sleep(0.2 * (attempt + 1))

    # -- ask/tell --------------------------------------------------------
    def ask(self) -> dict:
        if self.storage:
            self._load()  # pick up other workers' results
        params = (self._retry_params.pop(0)
                  if getattr(self, "_retry_params", None) else self._suggest())
        trial = {
            "number": self._allocate_number(),
            "params": params,
            "state": "RUNNING",
            "value": None,
            "intermediate": {},
            "heartbeat": time.time(),
        }
        self.trials.append(trial)
        self._persist(trial)
        return trial

    def retry_stale(self, grace_period: float = 1800.0) -> int:
        """Mark dead workers' RUNNING trials FAILED and requeue their params.

        The reference's Optuna RDB storage uses heartbeat_interval +
        grace_period with RetryFailedTrialCallback so a crashed worker's
        trial is retried by a surviving one. Here
        `report_intermediate` refreshes a per-trial heartbeat; any RUNNING
        trial whose heartbeat is older than `grace_period` seconds is
        marked FAILED and its params go to the front of this worker's ask
        queue. Returns the number of trials requeued.

        The default grace (1800 s) leaves room for a slow first epoch: a
        live worker refreshes its heartbeat once per epoch. With sqlite storage the
        reclaim is a single-transaction compare-and-swap, so when several
        surviving workers race on the same stale trial exactly one wins
        the requeue (the others see rowcount 0 and skip it).
        """
        if self.storage:
            self._load()
        now = time.time()
        n = 0
        self._retry_params = getattr(self, "_retry_params", [])
        for t in self.trials:
            if (t.get("state") == "RUNNING"
                    and now - float(t.get("heartbeat", now)) > grace_period):
                old_payload = json.dumps(t)
                t["state"] = "FAILED"
                t["retried"] = True
                if self._is_sql():
                    if not self._swap_if_unchanged(
                            t["number"], old_payload, t):
                        t["state"] = "RUNNING"  # another worker won the race
                        t.pop("retried", None)
                        continue
                else:
                    self._persist(t)
                self._retry_params.append(dict(t["params"]))
                n += 1
        return n

    def _swap_if_unchanged(self, number, old_payload, trial) -> bool:
        """One-transaction compare-and-swap of a trial row: the UPDATE only
        lands if the stored payload is still byte-identical to what this
        worker loaded (payloads are always written by json.dumps, so a
        load->dump round-trip reproduces the stored bytes)."""
        for attempt in range(5):
            try:
                with self._conn() as con:
                    cur = con.execute(
                        "UPDATE trials SET payload=? "
                        "WHERE number=? AND payload=?",
                        (json.dumps(trial), number, old_payload),
                    )
                    return cur.rowcount == 1
            except sqlite3.OperationalError:
                time.sleep(0.2 * (attempt + 1))
        return False

    def _allocate_number(self) -> int:
        """Atomically reserve the next trial number. With shared sqlite
        storage two workers would otherwise both take len(trials) and
        INSERT OR REPLACE each other's trials."""
        if not self._is_sql():
            return len(self.trials)
        for attempt in range(10):
            try:
                with self._conn() as con:
                    cur = con.execute(
                        "INSERT INTO trials (number, payload) VALUES ("
                        "(SELECT COALESCE(MAX(number), -1) + 1 FROM trials),"
                        " ?) RETURNING number",
                        (json.dumps({"state": "ALLOCATED"}),),
                    )
                    return int(cur.fetchone()[0])
            except sqlite3.OperationalError:
                time.sleep(0.1 * (attempt + 1))
        raise RuntimeError("could not allocate trial number")

    def report_intermediate(self, trial: dict, step: int, value: float):
        trial["intermediate"][str(step)] = float(value)
        trial["heartbeat"] = time.time()  # liveness for retry_stale
        self._persist(trial)

    def tell(self, trial: dict, value: float | None, state: str = "COMPLETE"):
        trial["value"] = None if value is None else float(value)
        trial["state"] = state
        self._persist(trial)

    @property
    def best_trial(self) -> dict:
        done = [t for t in self.trials
                if t["state"] == "COMPLETE" and t["value"] is not None]
        if not done:
            raise ValueError("no completed trials")
        return min(done, key=lambda t: t["value"])

    # -- TPE-lite sampler ------------------------------------------------
    def _suggest(self) -> dict:
        done = [t for t in self.trials
                if t["state"] == "COMPLETE" and t["value"] is not None]
        if len(done) < self.n_startup_trials:
            return self.space.sample_random(self._rng)
        done = sorted(done, key=lambda t: t["value"])
        n_good = max(int(len(done) * self.gamma), 2)
        good, bad = done[:n_good], done[n_good:]
        out = {}
        for name in self.space.spec:
            g = np.array([self.space._to_unit(name, t["params"][name])
                          for t in good])
            b = np.array([self.space._to_unit(name, t["params"][name])
                          for t in bad]) if bad else np.array([0.5])
            bw = max(g.std(), 0.05)
            # draw candidates from the good KDE, score by density ratio
            cands = np.clip(
                g[self._rng.integers(len(g), size=24)]
                + bw * self._rng.standard_normal(24),
                0.0, 1.0,
            )

            def kde(pts, x):
                return np.mean(
                    np.exp(-0.5 * ((x[:, None] - pts[None]) / bw) ** 2), axis=1
                ) + 1.0e-12

            score = kde(g, cands) / kde(b, cands)
            out[name] = self.space._from_unit(name, float(cands[np.argmax(score)]))
        return out


# ---------------------------------------------------------------------------
# optimize_sbi
# ---------------------------------------------------------------------------


def _is_cuda_error(e: BaseException) -> bool:
    """A CUDA failure: out of memory, an accelerator error, or a runtime
    error whose message names CUDA."""
    kinds = tuple(k for k in (getattr(torch, "OutOfMemoryError", None),
                              getattr(torch, "AcceleratorError", None))
                  if k is not None)
    msg = str(e)
    return (isinstance(e, kinds) or "CUDA error" in msg
            or "CUDA out of memory" in msg)

DEFAULT_SEARCH_SPACES = {
    # reference NSF space: hidden 10-100, transforms 3-20, lr 5e-5..1e-2 log
    # (the reference's examples/sbi/configs/custom_loop.yaml)
    "nsf": {
        "hidden_features": ("int", 10, 100),
        "num_transforms": ("int", 3, 20),
        "learning_rate": ("float", 5.0e-5, 1.0e-2, "log"),
        "batch_size": ("categorical", [64, 128, 256, 512]),
    },
    "maf": {
        "hidden_features": ("int", 10, 128),
        "num_transforms": ("int", 3, 15),
        "learning_rate": ("float", 5.0e-5, 1.0e-2, "log"),
        "batch_size": ("categorical", [64, 128, 256, 512]),
    },
    "mdn": {
        "hidden_features": ("int", 16, 128),
        "num_components": ("int", 2, 20),
        "learning_rate": ("float", 5.0e-5, 1.0e-2, "log"),
        "batch_size": ("categorical", [64, 128, 256, 512]),
    },
}

# the rest of the zoo shares the (hidden, transforms, lr, batch) shape
for _name, _tr_hi in [("ncsf", 12), ("realnvp", 12), ("nice", 12),
                      ("naf", 6), ("unaf", 5), ("sospf", 6), ("gf", 8),
                      ("made", 1), ("cnf", 1)]:
    DEFAULT_SEARCH_SPACES[_name] = {
        "hidden_features": ("int", 16, 100),
        "learning_rate": ("float", 5.0e-5, 1.0e-2, "log"),
        "batch_size": ("categorical", [64, 128, 256, 512]),
        **({"num_transforms": ("int", 2, _tr_hi)} if _tr_hi > 1 else {}),
    }
del _name, _tr_hi

# "zoo" searches the model family itself alongside shared hyperparameters
# (the reference sweeps model_type lists through ili/Optuna configs)
DEFAULT_SEARCH_SPACES["zoo"] = {
    "model_type": ("categorical",
                   ["nsf", "maf", "mdn", "realnvp", "naf", "gf"]),
    "hidden_features": ("int", 16, 100),
    "num_transforms": ("int", 2, 12),
    "learning_rate": ("float", 5.0e-5, 1.0e-2, "log"),
    "batch_size": ("categorical", [64, 128, 256, 512]),
}


def optimize_sbi(
    fitter,
    model_type: str = "nsf",
    search_space: dict | None = None,
    n_trials: int = 20,
    objective: str = "val_loss",
    pruner: MedianPruner | None = None,
    storage: str | None = None,
    seed: int = 0,
    max_epochs: int = 60,
    verbose: bool = True,
):
    """HPO over flow architecture and training on the fitter's device
    (reference `optimize_sbi`).

    Each trial trains through `fitter.run_single_sbi` with an epoch
    callback that reports the validation loss and stops the trial when the
    pruner fires, so a pruned trial trains fewer epochs. A trial that
    raises ValueError or RuntimeError is FAIL, but for a CUDA error, which
    propagates.

    objective: "val_loss" (default; = −log_prob), "log_prob-pit"
    (val_loss + max-PIT-KS penalty), "tarp" (TARP mid deviation).
    Returns (study, best_params).
    """
    from .train import TrainConfig

    space = SearchSpace(search_space or DEFAULT_SEARCH_SPACES[model_type])
    study = Study(space=space, storage=storage, seed=seed)
    pruner = pruner or MedianPruner()

    for _ in range(n_trials):
        if storage:  # reclaim crashed workers' trials (reference heartbeat
            study.retry_stale()  # semantics, custom_runner.py:374-419)
        trial = study.ask()
        p = dict(trial["params"])
        lr = p.pop("learning_rate", 1.0e-4)
        bs = p.pop("batch_size", 256)
        # "zoo" space searches the model family itself
        trial_model = p.pop("model_type", model_type)
        if trial_model in ("mdn", "gaussian", "cnf", "made"):
            p.pop("num_transforms", None)  # not a hyperparameter there
        try:
            # prune DURING training: the callback reports each epoch's val
            # loss and aborts the trial mid-run when the pruner fires —
            # unlike a post-hoc replay, a pruned trial really does train
            # fewer epochs (reference prunes via Optuna callbacks,
            # custom_runner.py:662-670)
            def epoch_callback(epoch, tr_loss, va_loss,
                               _trial=trial):
                v = float(np.asarray(va_loss).mean())
                study.report_intermediate(_trial, epoch, v)
                try:
                    return pruner.should_prune(epoch, v, study, _trial)
                except TypeError:
                    # user pruners written against the original 3-arg
                    # interface (step, value, study) keep working
                    return pruner.should_prune(epoch, v, study)

            res = fitter.run_single_sbi(
                model_type=trial_model,
                train_config=TrainConfig(
                    batch_size=int(bs), learning_rate=float(lr),
                    max_epochs=max_epochs, stop_after_epochs=10,
                ),
                epoch_callback=epoch_callback,
                **p,
            )
            val_losses = np.asarray(res.val_losses).reshape(len(res.val_losses), -1).mean(1)
            if res.history.get("pruned"):
                study.tell(trial, float(val_losses.min()), state="PRUNED")
                if verbose:
                    print(f"trial {trial['number']}: PRUNED at epoch "
                          f"{len(val_losses) - 1}", flush=True)
                continue
            value = float(val_losses.min())
            if objective in ("log_prob-pit", "tarp"):
                report = fitter.evaluate_model(n_samples=128, max_objects=128)
                if objective == "log_prob-pit":
                    value = value + float(np.max(report["pit_ks"]))
                else:
                    value = report["tarp_deviation"]
            study.tell(trial, value)
            if verbose:
                print(f"trial {trial['number']}: {value:.4f} {trial['params']}",
                      flush=True)
        except (ValueError, RuntimeError) as e:  # failed trial
            if _is_cuda_error(e):
                raise
            study.tell(trial, None, state="FAIL")
            if verbose:
                print(f"trial {trial['number']} failed: {e}", flush=True)

    best = study.best_trial
    return study, best["params"]


def sweep_learning_rates(
    flow,
    theta,
    x,
    learning_rates,
    config=None,
    generator=None,
    groups=None,
):
    """Train one flow at K learning rates at once and pick the best.

    The K candidates are the members of one `train_ensemble` call with one
    learning rate each (`member_learning_rates`), so the sweep costs one
    training run of K members; the winner has the lowest best validation
    loss, and its parameters are its row of the stacked (K, ...) leaves.
    `generator` drives the split, the weights and the shuffles.

    Returns dict with `best_lr`, `best_index`, `best_val` (K,),
    `params` (the winning member's parameters), and the full `TrainResult`.
    """
    from .flows.base import tree_map
    from .train import TrainConfig, train_ensemble

    lrs = np.asarray(learning_rates, np.float64)
    res = train_ensemble(
        flow, theta, x, generator=generator, config=config or TrainConfig(),
        n_nets=len(lrs), groups=groups, member_learning_rates=lrs,
    )
    best_val = np.asarray(res.history["best_val"])
    best_idx = int(np.argmin(best_val))
    return {
        "best_lr": float(lrs[best_idx]),
        "best_index": best_idx,
        "best_val": best_val,
        "params": tree_map(lambda a: a[best_idx].clone(), res.params),
        "result": res,
    }
