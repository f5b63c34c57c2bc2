"""Matplotlib diagnostics: coverage, losses, corner, SED recovery.

Counterpart of `synference_tpu/plotting.py`, with the same figures. Inputs
may be numpy arrays or tensors on any device; they are copied to the host,
and the calibration metrics of `plot_coverage` run on the CPU. matplotlib
is imported where a figure is drawn (the card machine has none). Every
function returns the figure and saves it to `save` when given; nothing is
shown.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "plot_coverage",
    "plot_loss",
    "plot_corner",
    "plot_sed_recovery",
    "plot_posterior_predictions",
    "plot_snr_binned_deviation",
    "plot_histograms",
]


def _host(x):
    """A numpy copy of an array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_coverage(samples, truths, parameter_names=None, save: str | None = None):
    """PIT histograms, SBC rank histograms, TARP curve, coverage plot —
    the reference's PosteriorCoverage plot_list equivalents."""
    from .diagnostics import (expected_coverage, pit_values, sbc_ranks,
                              tarp_coverage)

    plt = _mpl()
    samples = _host(samples)
    truths = _host(truths)
    n_params = truths.shape[1]
    names = list(parameter_names or [f"θ{i}" for i in range(n_params)])

    fig, axes = plt.subplots(3, max(n_params, 2),
                             figsize=(3 * max(n_params, 2), 9))
    pit = pit_values(samples, truths, device="cpu").numpy()
    ranks = sbc_ranks(samples, truths, device="cpu").numpy()
    for i in range(n_params):
        ax = axes[0, i]
        ax.hist(pit[:, i], bins=20, range=(0, 1), density=True,
                color="C0", alpha=0.8)
        ax.axhline(1.0, color="k", ls="--", lw=1)
        ax.set_title(f"PIT {names[i]}")
        ax = axes[1, i]
        ax.hist(ranks[:, i], bins=20, color="C1", alpha=0.8)
        ax.set_title(f"SBC ranks {names[i]}")
    alphas, ecp = tarp_coverage(samples, truths, device="cpu")
    ax = axes[2, 0]
    ax.plot(alphas, ecp, "C2", lw=2, label="TARP ECP")
    ax.plot([0, 1], [0, 1], "k--", lw=1)
    ax.set_xlabel("credibility α")
    ax.set_ylabel("ECP")
    ax.legend()
    # central-interval coverage
    levels = np.linspace(0.05, 0.95, 19)
    cov = expected_coverage(samples, truths, levels=tuple(levels),
                            device="cpu")
    ax = axes[2, 1]
    for i in range(n_params):
        ax.plot(levels, cov[:, i], label=names[i], alpha=0.8)
    ax.plot([0, 1], [0, 1], "k--", lw=1)
    ax.set_xlabel("credible level")
    ax.set_ylabel("empirical coverage")
    ax.legend(fontsize=7)
    for j in range(2, max(n_params, 2)):
        axes[2, j].axis("off")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def plot_loss(train_losses, val_losses, save: str | None = None):
    """Training/validation loss curves (reference plot_loss + the plotext
    live terminal plot's offline counterpart)."""
    plt = _mpl()
    tr = _host(train_losses)
    va = _host(val_losses)
    fig, ax = plt.subplots(figsize=(6, 4))
    if tr.ndim == 1:
        tr, va = tr[:, None], va[:, None]
    for m in range(tr.shape[1]):
        ax.plot(tr[:, m], color="C0", alpha=0.6,
                label="train" if m == 0 else None)
        ax.plot(va[:, m], color="C1", alpha=0.6,
                label="val" if m == 0 else None)
    ax.set_xlabel("epoch")
    ax.set_ylabel("-log q(θ|x)")
    ax.legend()
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def plot_corner(samples, truths=None, parameter_names=None, bins: int = 30,
                save: str | None = None):
    """Simple corner plot of one object's posterior draws (S, P)."""
    plt = _mpl()
    samples = _host(samples)
    truths = None if truths is None else _host(truths)
    p = samples.shape[1]
    names = list(parameter_names or [f"θ{i}" for i in range(p)])
    fig, axes = plt.subplots(p, p, figsize=(2.2 * p, 2.2 * p))
    if p == 1:
        axes = np.array([[axes]])
    for i in range(p):
        for j in range(p):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(samples[:, i], bins=bins, color="C0", alpha=0.8)
                if truths is not None:
                    ax.axvline(truths[i], color="r", lw=1)
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=bins,
                          cmap="Blues")
                if truths is not None:
                    ax.plot(truths[j], truths[i], "r+", ms=10)
            if i == p - 1:
                ax.set_xlabel(names[j], fontsize=8)
            if j == 0 and i > 0:
                ax.set_ylabel(names[i], fontsize=8)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def plot_sed_recovery(recovery: dict, obs_phot_njy=None, obs_err_njy=None,
                      filter_pivots=None, save: str | None = None):
    """Recovered SED quantile bands + observed photometry overlay
    (reference recover_SED figures, sbi_runner.py:5700-6349)."""
    plt = _mpl()
    fig, axes = plt.subplots(
        1, 2 if "sfh_quantiles" in recovery else 1,
        figsize=(11, 4), squeeze=False,
    )
    ax = axes[0, 0]
    recovery = {k: _host(v) for k, v in recovery.items()}
    lam = recovery["lam"]
    q = recovery["fnu_quantiles"]
    ax.fill_between(lam, q[0], q[-1], color="C0", alpha=0.3,
                    label="posterior band")
    ax.plot(lam, q[len(q) // 2], "C0", lw=1)
    if obs_phot_njy is not None and filter_pivots is not None:
        ax.errorbar(filter_pivots, obs_phot_njy, yerr=obs_err_njy,
                    fmt="ro", ms=4, label="observed")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("λ_obs [Å]")
    ax.set_ylabel("f_ν [nJy]")
    ax.legend()
    if "sfh_quantiles" in recovery:
        ax = axes[0, 1]
        ages = recovery["ages_yr"]
        qs = recovery["sfh_quantiles"]
        ax.fill_between(ages, qs[0], qs[-1], color="C2", alpha=0.3)
        ax.plot(ages, qs[len(qs) // 2], "C2", lw=1)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("lookback age [yr]")
        ax.set_ylabel("mass formed / bin [M☉]")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def plot_snr_binned_deviation(samples, truths, snr, parameter_names=None,
                              n_bins: int = 6, save: str | None = None):
    """Median deviation (pred − true) vs feature SNR, binned (the reference's
    SNR-binned deviation plots, sbi_runner.py:2221-2472)."""
    plt = _mpl()
    samples = _host(samples)
    truths = _host(truths)
    snr = _host(snr)
    med = np.median(samples, axis=1)
    dev = med - truths
    p = truths.shape[1]
    names = list(parameter_names or [f"θ{i}" for i in range(p)])
    edges = np.quantile(snr, np.linspace(0, 1, n_bins + 1))
    centers = 0.5 * (edges[:-1] + edges[1:])
    fig, axes = plt.subplots(1, p, figsize=(3 * p, 3))
    if p == 1:
        axes = [axes]
    for i in range(p):
        med_dev, lo_dev, hi_dev = [], [], []
        for b in range(n_bins):
            m = (snr >= edges[b]) & (snr <= edges[b + 1])
            if m.sum() < 3:
                med_dev.append(np.nan)
                lo_dev.append(np.nan)
                hi_dev.append(np.nan)
                continue
            med_dev.append(np.median(dev[m, i]))
            lo_dev.append(np.quantile(dev[m, i], 0.16))
            hi_dev.append(np.quantile(dev[m, i], 0.84))
        ax = axes[i]
        ax.fill_between(centers, lo_dev, hi_dev, alpha=0.3, color="C0")
        ax.plot(centers, med_dev, "C0o-", ms=4)
        ax.axhline(0, color="k", ls="--", lw=1)
        ax.set_xscale("log")
        ax.set_xlabel("SNR")
        ax.set_ylabel(f"Δ{names[i]}", fontsize=8)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def plot_posterior_predictions(samples, truths, parameter_names=None,
                               save: str | None = None):
    """Predicted (median ± quantiles) vs true scatter per parameter
    (reference "predictions" panel of PosteriorCoverage)."""
    plt = _mpl()
    samples = _host(samples)
    truths = _host(truths)
    p = truths.shape[1]
    names = list(parameter_names or [f"θ{i}" for i in range(p)])
    med = np.median(samples, axis=1)
    lo = np.quantile(samples, 0.16, axis=1)
    hi = np.quantile(samples, 0.84, axis=1)
    fig, axes = plt.subplots(1, p, figsize=(3 * p, 3))
    if p == 1:
        axes = [axes]
    for i in range(p):
        ax = axes[i]
        ax.errorbar(truths[:, i], med[:, i],
                    yerr=[med[:, i] - lo[:, i], hi[:, i] - med[:, i]],
                    fmt=".", ms=3, alpha=0.5, elinewidth=0.5)
        lims = [truths[:, i].min(), truths[:, i].max()]
        ax.plot(lims, lims, "k--", lw=1)
        ax.set_xlabel(f"true {names[i]}", fontsize=8)
        ax.set_ylabel(f"predicted {names[i]}", fontsize=8)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def plot_histograms(array, names=None, bins: int = 40, ncols: int = 4,
                    save: str | None = None):
    """Per-column histogram grid (reference `plot_histogram_parameter_array`
    / `plot_histogram_feature_array`, sbi_runner.py:6864-6982)."""
    plt = _mpl()
    arr = _host(array)
    if arr.ndim == 1:
        arr = arr[:, None]
    n = arr.shape[1]
    names = list(names) if names is not None else [f"c{i}" for i in range(n)]
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2.4 * nrows),
                             squeeze=False)
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        if i >= n:
            ax.axis("off")
            continue
        col = arr[:, i]
        col = col[np.isfinite(col)]
        ax.hist(col, bins=bins, color="#46647d")
        ax.set_title(names[i], fontsize=9)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=130)
        plt.close(fig)
    return fig
