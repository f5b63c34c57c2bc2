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
acceptance columns, the MCMC-sampled ones. c2st, lc2st, the misspecification
check, feature importance, the Fisher forecast and score compression wait
for ROADMAP M13-rest/M14.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

__all__ = ["pit_values", "sbc_ranks", "pit_ks_statistic", "tarp_coverage",
           "tarp_deviation", "expected_coverage", "point_metrics",
           "evaluate_posterior", "evaluate_members_fused", "format_report"]

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
    its base draws. Any other posterior (the MCMC-sampled NLE and NRE ones)
    is sampled with `sample_batch` and reports neither; its `mean_log_prob`
    is None when no truth has a finite log-prob. `tarp_uniforms` (M, P)
    replace the generator's draws (seed 0 on the posterior's device when
    all are None)."""
    flow_posterior = hasattr(posterior, "sample_batch_with_acceptance")
    dev = posterior.prior.device
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
