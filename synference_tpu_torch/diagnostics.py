"""Posterior validation: PIT, SBC ranks, TARP, coverage, point metrics.

Counterpart of `synference_tpu/diagnostics.py`. Every metric works on a
(..., M, S, P) posterior-sample tensor, on the device the samples lie on, so
the whole validation set, and all members of an ensemble at once, is one
batched computation. One implementation of the chain (sample → acceptance →
PIT → KS → TARP → coverage → point metrics → leakage-corrected log-prob)
serves both `evaluate_posterior` and `evaluate_members_fused`.

Medians and quantiles interpolate linearly between order statistics, and
standard deviations and variances are population ones, as in the JAX package.
TARP's reference points take their uniforms from a generator or from an array
passed in. `evaluate_posterior` serves flow posteriors and, without the
acceptance columns, the MCMC-sampled ones.

The two-sample tests (`c2st`, `lc2st`) train small MLP classifiers on the
device, every fold, object or permutation as one member axis; the card
machine has no sklearn, so `c2st` uses `classifier.py` with sklearn's
defaults. `fit_marginal_flow` / `misspecification_check` flag observations
outside the feature marginal; `feature_importance` and
`shapley_feature_importance` attribute posterior information to features.
`fisher_forecast`, `score_compression` and `posterior_crosscheck` go
through the simulator's gradient (forward mode, `_mega_off` set for the
call).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

__all__ = ["pit_values", "sbc_ranks", "pit_ks_statistic", "tarp_coverage",
           "tarp_deviation", "expected_coverage", "point_metrics",
           "evaluate_posterior", "evaluate_members_fused", "format_report",
           "c2st", "lc2st", "fit_marginal_flow", "misspecification_check",
           "feature_importance", "shapley_feature_importance",
           "fisher_forecast", "score_compression", "posterior_crosscheck"]

_LEVELS = (0.5, 0.68, 0.9, 0.95)


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _below(samples, truths):
    return samples < truths.unsqueeze(-2)


def _quantiles(sorted_samples, qs):
    """Linearly interpolated quantiles of (..., S, P) samples sorted along
    S; one (..., P) tensor per q."""
    s = sorted_samples.shape[-2]
    out = []
    for q in qs:
        pos = q * (s - 1)
        lo, hi = math.floor(pos), math.ceil(pos)
        hi_w = pos - lo
        out.append(sorted_samples[..., lo, :] * (1.0 - hi_w)
                   + sorted_samples[..., hi, :] * hi_w)
    return out


def _median(values, dim: int):
    """Interpolating median along `dim` (torch.median takes the lower of
    two middle values)."""
    ordered = torch.sort(values, dim=dim).values.movedim(dim, -1)
    n = ordered.shape[-1]
    return 0.5 * (ordered[..., (n - 1) // 2] + ordered[..., n // 2])


def _ks(pit):
    """KS distance of (..., M, P) PIT values from U(0, 1), per parameter."""
    m = pit.shape[-2]
    grid = (torch.arange(1, m + 1, dtype=torch.float32, device=pit.device)
            / m).unsqueeze(-1)
    return (torch.sort(pit, dim=-2).values - grid).abs().amax(dim=-2)


def _tarp_ecp(samples, truths, uniforms, n_alpha: int = 50,
              norm: bool = True):
    """TARP expected coverage: (alphas (n_alpha,), ecp (..., n_alpha)) from
    samples (..., M, S, P), truths (..., M, P) and reference-point uniforms
    of the truths' shape."""
    if norm:
        mu = samples.mean(dim=(-3, -2), keepdim=True)
        sd = torch.clamp(samples.std(dim=(-3, -2), keepdim=True,
                                     correction=0), min=1.0e-8)
        samples = (samples - mu) / sd
        truths = (truths - mu.squeeze(-2)) / sd.squeeze(-2)
    # reference points ~ uniform over the sample bounding box
    lo = samples.amin(dim=(-3, -2)).unsqueeze(-2)
    hi = samples.amax(dim=(-3, -2)).unsqueeze(-2)
    refs = lo + (hi - lo) * uniforms
    d_truth = torch.linalg.norm(truths - refs, dim=-1)  # (..., M)
    d_samp = torch.linalg.norm(samples - refs.unsqueeze(-2), dim=-1)
    cred = (d_samp < d_truth.unsqueeze(-1)).to(torch.float32).mean(dim=-1)
    alphas = torch.linspace(0.0, 1.0, n_alpha, device=samples.device)
    ecp = (cred.unsqueeze(-2) < alphas.unsqueeze(-1)).to(
        torch.float32).mean(dim=-1)
    return alphas, ecp


def _mid_deviation(alphas, ecp):
    mid = torch.argmin((alphas - 0.5).abs())
    return (ecp[..., mid] - 0.5).abs()


def _point(sorted_samples, truths):
    """Point-estimate metrics from posterior medians, per parameter."""
    (med,) = _quantiles(sorted_samples, (0.5,))
    err = med - truths
    mse = (err * err).mean(dim=-2)
    var = torch.clamp(truths.var(dim=-2, correction=0), min=1.0e-12)
    return {
        "mse": mse,
        "rmse": mse.sqrt(),
        "mae": err.abs().mean(dim=-2),
        "median_ae": _median(err.abs(), dim=-2),
        "bias": err.mean(dim=-2),
        "r2": 1.0 - mse / var,
        "nmse": mse / var,
    }


def _coverage(sorted_samples, truths, levels):
    qs = [q for lvl in levels for q in (0.5 - lvl / 2, 0.5 + lvl / 2)]
    bounds = _quantiles(sorted_samples, qs)
    return torch.stack([
        ((truths >= lo) & (truths <= hi)).to(torch.float32).mean(dim=-2)
        for lo, hi in zip(bounds[0::2], bounds[1::2])], dim=-2)


# -- the public metrics ---------------------------------------------------
# Each takes arrays or tensors and a required `device`, moves its inputs
# there and computes there ("cuda" without a card raises).
def pit_values(samples, truths, *, device):
    """Probability integral transform per object and parameter: samples
    (M, S, P), truths (M, P) -> (M, P) in [0, 1]; uniform when calibrated."""
    samples = torch.as_tensor(samples, device=device)
    truths = torch.as_tensor(truths, device=device)
    return _below(samples, truths).to(torch.float32).mean(dim=-2)


def sbc_ranks(samples, truths, *, device):
    """Simulation-based-calibration ranks: the rank of the truth among the
    S draws (integer 0..S)."""
    samples = torch.as_tensor(samples, device=device)
    truths = torch.as_tensor(truths, device=device)
    return _below(samples, truths).sum(dim=-2)


def pit_ks_statistic(pit, *, device) -> np.ndarray:
    """Kolmogorov–Smirnov distance of PIT values from U(0,1), per param."""
    return _ks(_f32(pit, device)).cpu().numpy()


def tarp_coverage(samples, truths, generator: torch.Generator | None = None,
                  n_alpha: int = 50, norm: bool = True, uniforms=None, *,
                  device):
    """TARP expected coverage probability (Lemos et al. 2023).

    For each object a random reference point is drawn; the credibility of
    the truth is the fraction of posterior draws closer to the reference
    than the truth is. ECP(α) = P(credibility < α); calibrated ⇒ ECP(α) = α.
    The reference points' uniforms (M, P) come from `uniforms` or from
    `generator`, which lies on `device` (seed 0 there when both are None).

    Returns (alphas (n_alpha,), ecp (n_alpha,)) as numpy arrays.
    """
    samples = _f32(samples, device)
    truths = _f32(truths, device)
    if uniforms is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        uniforms = torch.rand(truths.shape, generator=generator,
                              device=device)
    alphas, ecp = _tarp_ecp(samples, truths, _f32(uniforms, device),
                            n_alpha, norm)
    return alphas.cpu().numpy(), ecp.cpu().numpy()


def tarp_deviation(samples, truths, generator=None, uniforms=None, *,
                   device) -> float:
    """|ECP(0.5) − 0.5|, the mid-curve summary of `tarp_coverage`."""
    alphas, ecp = tarp_coverage(samples, truths, generator,
                                uniforms=uniforms, device=device)
    mid = np.argmin(np.abs(alphas - 0.5))
    return float(np.abs(ecp[mid] - 0.5))


def expected_coverage(samples, truths, levels=_LEVELS, *,
                      device) -> np.ndarray:
    """Central credible-interval coverage per level and parameter:
    (len(levels), P) empirical fractions."""
    ordered = torch.sort(_f32(samples, device), dim=-2).values
    return _coverage(ordered, _f32(truths, device), levels).cpu().numpy()


def point_metrics(samples, truths, *, device) -> dict:
    """Point-estimate metrics from posterior medians: per-parameter arrays
    mse, rmse, mae, median_ae, r2, nmse (normalised by variance), bias."""
    ordered = torch.sort(_f32(samples, device), dim=-2).values
    return {k: v.cpu().numpy() for k, v in
            _point(ordered, _f32(truths, device)).items()}


# -- the chain --------------------------------------------------------------
def _metric_chain(samples, acc, truths, lp, uniforms, levels) -> dict:
    """Every metric of a report from samples (..., M, S, P), acceptance
    (..., M), truths (M, P), log-probs of the truths (..., M) and TARP
    uniforms (..., M, P); leading axes (ensemble members) are kept."""
    truths = truths.expand(samples.shape[:-2] + truths.shape[-1:])
    pit = _below(samples, truths).to(torch.float32).mean(dim=-2)
    alphas, ecp = _tarp_ecp(samples, truths, uniforms)
    ordered = torch.sort(samples, dim=-2).values
    finite = torch.isfinite(lp)
    n_finite = torch.clamp(finite.sum(dim=-1), min=1)
    lp_norm = torch.where(
        finite, lp - torch.log(torch.clamp(acc, min=1.0e-6)), 0.0)
    return {
        "point": _point(ordered, truths),
        "pit_ks": _ks(pit),
        "tarp_deviation": _mid_deviation(alphas, ecp),
        "mean_log_prob": torch.where(finite, lp, 0.0).sum(-1) / n_finite,
        "mean_log_prob_normalized": lp_norm.sum(-1) / n_finite,
        "frac_outside_support": 1.0 - finite.to(torch.float32).mean(-1),
        "coverage": _coverage(ordered, truths, levels),
        "acc_mean": acc.mean(dim=-1),
        "acc_min": acc.amin(dim=-1),
    }


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def _tarp_uniforms(shape, generator, uniforms, device):
    if uniforms is not None:
        return _f32(uniforms, device).reshape(shape)
    return torch.rand(shape, generator=generator, device=device)


def evaluate_members_fused(flow, stacked_params, prior, xs, truths,
                           generator: torch.Generator | None = None,
                           n_samples: int = 256, batched_rounds: int = 4,
                           parameter_names=None, coverage_levels=_LEVELS,
                           base=None, tarp_uniforms=None) -> dict:
    """Per-member calibration with seed-to-seed error bars.

    Every member of an ensemble is an independently initialised and shuffled
    training run, so the spread of TARP, PIT and R² across members measures
    the run-to-run training noise that a single-seed report hides. All K
    members go through the metric chain in one batched pass.

    `base` (K, M, batched_rounds·n_samples, P) and `tarp_uniforms`
    (K, M, P) replace the generator's draws (seed 0 when all are None).
    Returns, for each metric, per-member values and their mean, std (ddof 1)
    and ci95 (1.96·std/√K) across members.
    """
    from .posterior import _draw_members

    dev = flow.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    xs = torch.atleast_2d(_f32(xs, dev))
    truths = torch.atleast_2d(_f32(truths, dev))
    levels = tuple(float(v) for v in coverage_levels)
    k = int(stacked_params["theta_mean"].shape[0])
    if base is not None:
        base = _f32(base, dev)
    with torch.no_grad():
        samples, acc = _draw_members(flow, stacked_params, prior, xs,
                                     n_samples, batched_rounds, generator,
                                     base)
        uniforms = _tarp_uniforms((k,) + truths.shape, generator,
                                  tarp_uniforms, dev)
        lp = flow.log_prob(stacked_params, truths, xs)  # (K, M)
        lp = torch.where(prior.support_mask(truths), lp, -torch.inf)
        out = _to_numpy(_metric_chain(samples, acc, truths, lp, uniforms,
                                      levels))

    def stat(v):  # v: (K,) or (K, P) -> summary dict
        v = np.asarray(v, np.float64)
        sd = np.std(v, axis=0, ddof=1)
        return {"per_member": v.round(5).tolist(),
                "mean": np.mean(v, axis=0).round(5).tolist(),
                "std": sd.round(5).tolist(),
                "ci95": (1.96 * sd / np.sqrt(k)).round(5).tolist()}

    report = {
        "n_members": k,
        "n_samples": int(n_samples),
        "tarp_deviation": stat(out["tarp_deviation"]),
        "pit_ks_max": stat(np.max(out["pit_ks"], axis=1)),
        "pit_ks": stat(out["pit_ks"]),
        "r2": stat(out["point"]["r2"]),
        "mean_log_prob": stat(out["mean_log_prob"]),
        "sampling_acceptance_min": stat(out["acc_min"]),
    }
    if parameter_names is not None:
        report["parameter_names"] = list(parameter_names)
    return report


def evaluate_posterior(posterior, xs, truths,
                       generator: torch.Generator | None = None,
                       n_samples: int = 256, parameter_names=None,
                       batched_rounds: int = 4,
                       coverage_levels=_LEVELS, base=None,
                       tarp_uniforms=None) -> dict:
    """Full validation report for a posterior on held-out (x, θ) pairs:
    point metrics, PIT KS per parameter, TARP deviation, mean log-prob of
    the truths, coverage table.

    A flow posterior (one with `sample_batch_with_acceptance`) also reports
    the sampling acceptance, with a warning when the flow leaks, and the
    leakage-corrected log-prob; `base` (the shape that method takes) replaces
    its base draws. Any other posterior (the MCMC-sampled NLE and NRE ones,
    the simformer's) is sampled with `sample_batch` and reports neither; its `mean_log_prob`
    is None when no truth has a finite log-prob. `tarp_uniforms` (M, P)
    replace the generator's draws (seed 0 on the posterior's device when
    all are None)."""
    flow_posterior = hasattr(posterior, "sample_batch_with_acceptance")
    # a simformer posterior has no prior; it names its device
    dev = getattr(posterior, "device", None) or posterior.prior.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    xs = torch.atleast_2d(_f32(xs, dev))
    truths = torch.atleast_2d(_f32(truths, dev))
    levels = tuple(float(v) for v in coverage_levels)
    with torch.no_grad():
        if flow_posterior:
            samples, acc = posterior.sample_batch_with_acceptance(
                xs, n_samples, generator, batched_rounds, base)
        else:
            samples = posterior.sample_batch(xs, n_samples, generator)
            acc = torch.ones(xs.shape[0], device=dev)
        uniforms = _tarp_uniforms(truths.shape, generator, tarp_uniforms,
                                  dev)
        lp = posterior.log_prob(truths, xs)
        out = _to_numpy(_metric_chain(samples, acc, truths, lp, uniforms,
                                      levels))
    report = {
        "point": {k: v.tolist() for k, v in out["point"].items()},
        "pit_ks": out["pit_ks"].tolist(),
        "tarp_deviation": float(out["tarp_deviation"]),
        "mean_log_prob": float(out["mean_log_prob"]),
        "frac_outside_support": float(out["frac_outside_support"]),
        "coverage": out["coverage"].tolist(),
        "coverage_levels": list(levels),
        "n_samples": int(n_samples),
    }
    if not flow_posterior:
        if report["frac_outside_support"] == 1.0:
            report["mean_log_prob"] = None
    else:
        report.update({
            "mean_log_prob_normalized": float(
                out["mean_log_prob_normalized"]),
            "sampling_acceptance_mean": float(out["acc_mean"]),
            "sampling_acceptance_min": float(out["acc_min"]),
            "frac_clipped": float(1.0 - out["acc_mean"]),
        })
        if report["sampling_acceptance_min"] < 0.5:
            warnings.warn(
                f"posterior leakage: min in-support acceptance "
                f"{report['sampling_acceptance_min']:.2f} (< 0.5); clipped "
                "samples pile mass on the prior faces", stacklevel=2)
    if parameter_names is not None:
        report["parameter_names"] = list(parameter_names)
    return report


def format_report(report: dict) -> str:
    """Human-readable metric table of an `evaluate_posterior` report."""
    names = report.get(
        "parameter_names", [f"θ{i}" for i in range(len(report["pit_ks"]))])
    point = report["point"]
    lines = [f"{'parameter':>20} {'rmse':>10} {'bias':>10} {'r2':>8} "
             f"{'pit_ks':>8}"]
    for i, n in enumerate(names):
        lines.append(
            f"{n:>20} {point['rmse'][i]:>10.4g} {point['bias'][i]:>10.3g} "
            f"{point['r2'][i]:>8.3f} {report['pit_ks'][i]:>8.3f}")
    mean_lp = report["mean_log_prob"]
    lines.append(f"TARP deviation: {report['tarp_deviation']:.4f}   "
                 f"mean log-prob: {mean_lp if mean_lp is not None else 'n/a'}")
    cov = np.asarray(report["coverage"])
    lines.append("coverage (mean over params): " + "  ".join(
        f"{lvl:.0%}->{cov[j].mean():.2f}"
        for j, lvl in enumerate(report["coverage_levels"])))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# classifier two-sample tests
# ---------------------------------------------------------------------------
def _stratified_test_folds(labels: np.ndarray, n_folds: int) -> np.ndarray:
    """Each row's test fold under sklearn's unshuffled `StratifiedKFold`:
    the rows of each class, in order, fill the folds one after another in
    the sizes of sorted labels dealt round-robin."""
    classes, y = np.unique(labels, return_inverse=True)
    y_order = np.sort(y)
    alloc = np.asarray([np.bincount(y_order[i::n_folds],
                                    minlength=len(classes))
                        for i in range(n_folds)])
    folds = np.empty(len(y), np.int64)
    for k in range(len(classes)):
        folds[y == k] = np.arange(n_folds).repeat(alloc[:, k])
    return folds


def _c2st_members(xs, ys, n_folds: int, generator: torch.Generator):
    """C2ST accuracy of M sample-set pairs, xs (M, n1, d) against ys
    (M, n2, d): per object the pooled sets standardised, the 3 stratified
    folds of sklearn's `cross_val_score`, all M·n_folds classifiers trained
    as one member axis (`classifier.train_members`). Returns (M,)."""
    from .classifier import member_logits, train_members

    m, n1, d = xs.shape
    data = torch.cat([xs, ys], dim=1)
    mu = data.mean(dim=1, keepdim=True)
    sd = torch.clamp(data.std(dim=1, keepdim=True, correction=0), min=1e-8)
    data = (data - mu) / sd
    labels = np.concatenate([np.zeros(n1), np.ones(ys.shape[1])])
    folds = _stratified_test_folds(labels, n_folds)
    train = [np.flatnonzero(folds != f) for f in range(n_folds)]
    test = [np.flatnonzero(folds == f) for f in range(n_folds)]

    def gather(parts):
        """(M·n_folds, N_max, d) rows of each fold and their labels."""
        n_max = max(len(p) for p in parts)
        idx = np.stack([np.pad(p, (0, n_max - len(p))) for p in parts])
        idx = torch.as_tensor(idx, device=data.device)
        rows = data[:, idx].reshape(m * n_folds, n_max, d)
        lab = torch.as_tensor(labels, dtype=torch.float32,
                              device=data.device)[idx]
        return rows, lab.repeat(m, 1), [len(p) for p in parts] * m

    x_tr, y_tr, n_tr = gather(train)
    flat, _ = train_members(x_tr, y_tr, n_tr, generator)
    x_te, y_te, n_te = gather(test)
    pred = (member_logits(flat, x_te, d, 64) > 0.0).to(torch.float32)
    hit = (pred == y_te).to(torch.float32)
    valid = (torch.arange(x_te.shape[1], device=data.device)[None, :]
             < torch.as_tensor(n_te, device=data.device)[:, None])
    acc = (hit * valid).sum(dim=1) / valid.sum(dim=1)
    return acc.reshape(m, n_folds).mean(dim=1)


def c2st(x_samples, y_samples, n_folds: int = 3,
         generator: torch.Generator | None = None, *, device) -> float:
    """Classifier two-sample test: the mean cross-validated accuracy of an
    MLP telling the two sample sets apart; ≈ 0.5 when they are
    indistinguishable. The JAX package uses sklearn's `MLPClassifier` and
    `cross_val_score`; the port trains `classifier.train_members` with
    sklearn's defaults on the same standardisation and unshuffled
    stratified folds, all folds as one member axis (seed 0 on `device` when
    no generator)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    x = _f32(x_samples, device)[None]
    y = _f32(y_samples, device)[None]
    return float(_c2st_members(x, y, n_folds, generator)[0])


def lc2st(posterior, theta_cal, x_cal, x_obs,
          generator: torch.Generator | None = None, n_null: int = 20,
          n_obs_samples: int = 2000, hidden: int = 64, n_epochs: int = 200,
          lr: float = 5.0e-3, draws: dict | None = None) -> dict:
    """Local C2ST: is the estimated posterior q(θ|x) right at x_obs?

    A classifier tells joint pairs (θᵢ, xᵢ) from estimated pairs
    (θ̂ᵢ ~ q(·|xᵢ), xᵢ); the statistic at x_obs is the mean squared
    deviation of its class probability from ½ over posterior draws at
    x_obs. `n_null` classifiers on row-wise θ ↔ θ̂ swaps (exchangeable
    under H₀) calibrate the p-value, with the +1 correction. The main and
    the null classifiers (one hidden layer, w1 ~ sqrt(2/d_in)·N, the rest
    0) train as one member axis by full-batch Adam for `n_epochs`.

    `draws` may replace the generator's draws (seed 0 on the posterior's
    device when neither is given): "theta_hat" (n, P) one posterior draw
    per calibration x, "obs_samples" (n_obs_samples, P) draws at x_obs,
    "masks" (n_null, n, 1) bool swaps and "w1" (n_null + 1, hidden, d_in)
    initial first-layer weights.

    Returns {"stat", "null_stats" (n_null,), "p_value", "probs_obs" (the
    main classifier's probabilities on the x_obs draws), "reject" at
    α = 0.05}, on the host.
    """
    from .train import _optimizer_step

    dev = posterior.prior.device
    theta_cal = _f32(theta_cal, dev)
    x_cal = torch.atleast_2d(_f32(x_cal, dev))
    x_obs = _f32(x_obs, dev).reshape(-1)
    n, p_dim = theta_cal.shape
    d_in = p_dim + x_cal.shape[1]
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            theta_hat = posterior.sample_batch(x_cal, 1, generator)[:, 0]
            obs_samples = posterior.sample(x_obs, n_obs_samples, generator)
        masks = torch.rand((n_null, n, 1), generator=generator,
                           device=dev) < 0.5
        w1 = math.sqrt(2.0 / d_in) * torch.randn(
            (n_null + 1, hidden, d_in), generator=generator, device=dev)
    else:
        theta_hat = _f32(draws["theta_hat"], dev)
        obs_samples = _f32(draws["obs_samples"], dev)
        masks = torch.as_tensor(draws["masks"], dtype=torch.bool, device=dev)
        w1 = _f32(draws["w1"], dev)

    feats = torch.cat([theta_cal, theta_hat])
    t_mu = feats.mean(dim=0)
    t_sd = torch.clamp(feats.std(dim=0, correction=0), min=1e-6)
    x_mu = x_cal.mean(dim=0)
    x_sd = torch.clamp(x_cal.std(dim=0, correction=0), min=1e-6)

    def z(theta, x):
        return torch.cat([(theta - t_mu) / t_sd, (x - x_mu) / x_sd], dim=-1)

    k = n_null + 1
    masks = torch.cat([torch.zeros((1, n, 1), dtype=torch.bool, device=dev),
                       masks])
    z0 = z(torch.where(masks, theta_hat, theta_cal), x_cal.expand(k, -1, -1))
    z1 = z(torch.where(masks, theta_cal, theta_hat), x_cal.expand(k, -1, -1))
    sizes = [hidden * d_in, hidden, hidden, 1]
    flat = torch.cat([w1.reshape(k, -1),
                      torch.zeros((k, sum(sizes[1:])), device=dev)], dim=1)

    def logit(params, zz):  # (K, n_params), (K, N, d_in) -> (K, N)
        w1_, b1, w2, b2 = params.split(sizes, dim=1)
        h = torch.relu(torch.baddbmm(b1[:, None, :], zz,
                                     w1_.reshape(k, hidden, d_in)
                                     .transpose(1, 2)))
        return (h @ w2[:, :, None])[..., 0] + b2

    m_, v_ = torch.zeros_like(flat), torch.zeros_like(flat)
    lrs = torch.full((k,), float(lr), device=dev)
    for step in range(1, n_epochs + 1):
        with torch.enable_grad():
            p = flat.detach().requires_grad_(True)
            loss = 0.5 * (torch.nn.functional.softplus(logit(p, z0)).mean(1)
                          + torch.nn.functional.softplus(-logit(p, z1))
                          .mean(1))
            (g,) = torch.autograd.grad(loss.sum(), p)
        _optimizer_step(flat, g, m_, v_, step, lrs, 0.0, 0.0)

    z_star = z(obs_samples, x_obs.expand(obs_samples.shape[0], -1))
    with torch.no_grad():
        probs = torch.sigmoid(logit(flat, z_star.expand(k, -1, -1)))
    stats = ((probs - 0.5) ** 2).mean(dim=1).cpu().numpy()
    stat, null_stats = float(stats[0]), stats[1:]
    p_value = float((1 + (null_stats >= stat).sum()) / (1 + len(null_stats)))
    return {"stat": stat, "null_stats": null_stats, "p_value": p_value,
            "probs_obs": probs[0].cpu().numpy(), "reject": p_value < 0.05}


# ---------------------------------------------------------------------------
# marginal misspecification and feature attribution
# ---------------------------------------------------------------------------
def fit_marginal_flow(x, generator: torch.Generator | None = None,
                      hidden_features: int = 32, num_transforms: int = 4,
                      max_epochs: int = 40, *, device):
    """Unconditional "maf" density model of the feature marginal p(x) for
    misspecification checks, trained by `train_ensemble` (one member) at
    the JAX package's `TrainConfig` (patience 8, batch 512, learning rate
    1e-3). Returns (flow, params without a member axis)."""
    from .flows.base import build_flow
    from .train import TrainConfig, train_npe

    x = np.asarray(x, np.float32)
    flow = build_flow("maf", theta_dim=x.shape[1], context_dim=0,
                      hidden_features=hidden_features,
                      num_transforms=num_transforms, device=device)
    res = train_npe(flow, x, np.zeros((len(x), 0), np.float32), generator,
                    TrainConfig(max_epochs=max_epochs, stop_after_epochs=8,
                                batch_size=512, learning_rate=1e-3))
    return flow, res.params


def misspecification_check(flow, params, x_train, x_obs,
                           quantile: float = 0.01):
    """Flag observations whose marginal log-density lies below the
    `quantile` of the training rows'. Returns (flags, logp_obs,
    threshold) on the host."""
    def logp(x):
        x = torch.atleast_2d(_f32(x, flow.device))
        with torch.no_grad():
            return flow.log_prob(params, x, x.new_zeros((x.shape[0], 0))
                                 ).cpu().numpy()

    thresh = float(np.quantile(logp(x_train), quantile))
    lp_obs = logp(x_obs)
    return lp_obs < thresh, lp_obs, thresh


def _mean_finite_log_prob(posterior, truths, xs) -> float:
    with torch.no_grad():
        lp = posterior.log_prob(truths, xs).cpu().numpy()
    finite = np.isfinite(lp)
    return float(lp[finite].mean()) if finite.any() else -np.inf


def feature_importance(posterior, xs, truths, n_repeats: int = 3):
    """Permutation importance: the drop in mean posterior log-density of
    the truths when one feature column is shuffled across objects, averaged
    over `n_repeats` permutations from `numpy.random.default_rng(0)` (the
    JAX package's). Returns (D,) on the host."""
    xs = np.asarray(xs, np.float32)
    truths = np.asarray(truths, np.float32)
    base = _mean_finite_log_prob(posterior, truths, xs)
    rng = np.random.default_rng(0)
    importance = np.zeros(xs.shape[1])
    for d in range(xs.shape[1]):
        drops = []
        for _ in range(n_repeats):
            x_perm = xs.copy()
            x_perm[:, d] = x_perm[rng.permutation(len(xs)), d]
            drops.append(base - _mean_finite_log_prob(posterior, truths,
                                                      x_perm))
        importance[d] = np.mean(drops)
    return importance


def shapley_feature_importance(posterior, xs, truths, seed: int = 0,
                               n_permutations: int = 8,
                               max_objects: int = 256) -> dict:
    """Sampled-permutation Shapley attribution of posterior information.

    v(S) = E[log q(θ_true | x_S)], features outside S drawn from other
    objects (a row-shuffled copy). φ_i is feature i's mean marginal
    contribution over random orderings; Σφ = v(all) − v(none) over the
    sampled orderings. The D+1 masked stages of one ordering go through one
    `log_prob` call. Orderings and backgrounds come from
    `numpy.random.default_rng(seed)`; the JAX package draws that integer
    from its key.

    Returns {"shapley" (D,), "total_gain", "base_log_prob" v(all),
    "masked_log_prob" v(none)} on the host.
    """
    xs = np.asarray(xs, np.float32)[:max_objects]
    truths = np.asarray(truths, np.float32)[:max_objects]
    m, d = xs.shape
    rng = np.random.default_rng(int(seed))
    t_all = np.tile(truths, (d + 1, 1))

    def stage_values(order):
        bg = xs[rng.permutation(m)]
        staged = np.empty((d + 1, m, d), np.float32)
        cur = bg.copy()
        staged[0] = cur
        for step, feat in enumerate(order):
            cur = cur.copy()
            cur[:, feat] = xs[:, feat]
            staged[step + 1] = cur
        with torch.no_grad():
            lp = posterior.log_prob(t_all, staged.reshape(-1, d))
        # float64 stage values: Σφ telescopes to v(all) − v(none) to 1e-12
        lp = lp.cpu().numpy().astype(np.float64).reshape(d + 1, m)
        return np.nanmean(np.where(np.isfinite(lp), lp, np.nan), axis=1)

    phi = np.zeros(d)
    v_all = v_none = 0.0
    for _ in range(n_permutations):
        order = rng.permutation(d)
        v = stage_values(order)
        phi[order] += np.diff(v)
        v_none += v[0]
        v_all += v[-1]
    phi /= n_permutations
    return {"shapley": phi, "total_gain": float(phi.sum()),
            "base_log_prob": float(v_all / n_permutations),
            "masked_log_prob": float(v_none / n_permutations)}


# ---------------------------------------------------------------------------
# through the differentiable simulator
# ---------------------------------------------------------------------------
def fisher_forecast(simulator, theta, sigma_njy, param_names=None) -> dict:
    """Fisher information F = JᵀΣ⁻¹J per θ row, J = ∂photometry/∂θ by
    forward mode (`mcmc.photometry_jacobian`, the simulator's `_mega_off`
    set for the call): the Cramér–Rao bound of any unbiased estimator.

    Args:
        theta: (B, P) fiducial rows, on the simulator's device.
        sigma_njy: (F,) or (B, F) 1σ errors [nJy].
    Returns:
        {"fisher" (B, P, P), "cramer_rao_sigma" (B, P) (sqrt diag F⁻¹,
        NaN where not positive), "param_names"}; tensors on the device.
    """
    from .mcmc import _gauss_newton_sigma, _plain_route, photometry_jacobian

    dev = simulator.device
    theta = torch.atleast_2d(_f32(theta, dev))
    sigma = _f32(sigma_njy, dev).expand(theta.shape[0], -1)
    with _plain_route(simulator):
        jac = photometry_jacobian(simulator, theta)
    fisher, cr = _gauss_newton_sigma(jac, sigma)
    names = (tuple(param_names) if param_names is not None
             else tuple(getattr(simulator, "param_names", ())))
    return {"fisher": fisher, "cramer_rao_sigma": cr, "param_names": names}


def score_compression(simulator, theta_fid, sigma_njy, x_fid=None) -> dict:
    """MOPED / score compression: t(x) = θ_fid + F⁻¹JᵀΣ⁻¹(x − x_fid), P
    summaries of F bands, sufficient to first order near θ_fid; J by
    forward mode as in `fisher_forecast`.

    Returns {"compress" (x (N, F) tensor -> t (N, P)), "weights" (P, F),
    "x_fid" (F,), "theta_fid" (P,), "fisher" (P, P)}, tensors on the
    simulator's device."""
    from .mcmc import _plain_route, photometry_jacobian

    dev = simulator.device
    theta_fid = _f32(theta_fid, dev).reshape(-1)
    sigma = torch.clamp(_f32(sigma_njy, dev), min=1.0e-12)
    with _plain_route(simulator):
        if x_fid is None:
            with torch.no_grad():
                x_fid = simulator.photometry(theta_fid[None])[0]
        jac = photometry_jacobian(simulator, theta_fid[None])[0]  # (F, P)
    x_fid = _f32(x_fid, dev)
    jw = jac / sigma[:, None]
    fisher = jw.T @ jw
    eye = torch.eye(theta_fid.shape[0], device=dev)
    f_inv = torch.linalg.solve_ex(fisher + 1.0e-12 * eye, eye)[0]
    weights = f_inv @ (jw.T / sigma[None, :])

    def compress(x):
        x = torch.atleast_2d(_f32(x, dev))
        return theta_fid[None, :] + (x - x_fid[None, :]) @ weights.T

    return {"compress": compress, "weights": weights, "x_fid": x_fid,
            "theta_fid": theta_fid, "fisher": fisher}


def posterior_crosscheck(posterior, simulator, xs_features, x_obs_njy,
                         sigma_njy, prior,
                         generator: torch.Generator | None = None,
                         n_samples: int = 512, n_chains: int = 8,
                         n_warmup: int = 120, theta_transform=None) -> dict:
    """Hold an amortised posterior against exact-likelihood HMC, object by
    object: n_samples flow draws (`sample_batch`, optionally mapped by
    `theta_transform` into the simulator's θ), `fit_catalogue_hmc` with
    n_samples // n_chains draws per chain, and a C2ST per object, all
    objects' folds trained as one member axis.

    Returns {"c2st" (M,) (0.5: indistinguishable), "hmc_acceptance",
    "flow_samples", "hmc_samples"} (the scores and acceptance on the host,
    the samples tensors). One generator (seed 0 on the prior's device when
    None) drives the flow, the HMC and the classifiers.
    """
    from .mcmc import fit_catalogue_hmc

    dev = prior.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        flow_samples = posterior.sample_batch(
            torch.atleast_2d(_f32(xs_features, dev)), n_samples, generator)
    if theta_transform is not None:
        flow_samples = theta_transform(flow_samples)
    flow_samples = _f32(flow_samples, dev)
    hmc_samples, _, acc = fit_catalogue_hmc(
        simulator, x_obs_njy, sigma_njy, prior, generator, n_chains=n_chains,
        n_warmup=n_warmup, n_samples=max(1, n_samples // n_chains))
    scores = _c2st_members(flow_samples,
                           hmc_samples[:, :flow_samples.shape[1]], 3,
                           generator)
    return {"c2st": scores.cpu().numpy(), "hmc_acceptance": float(acc),
            "flow_samples": flow_samples, "hmc_samples": hmc_samples}
