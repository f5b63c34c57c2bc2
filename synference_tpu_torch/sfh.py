"""Star-formation-history and metallicity-distribution weights, batched.

Counterpart of `synference_tpu/sfh.py` for the families on the mock-library
path: the lognormal SFH and the delta metallicity distribution. Each takes
a dict of (B,) parameter tensors and returns (B, A) / (B, Z) weights, so a
batch is one tensor expression (the JAX package vmaps a per-galaxy version).

Per-bin masses come exactly from the family's cumulative mass function at
the grid age-bin edges. `t` is lookback time [yr]; `x = max_age − t` is
time since onset; weights sum to 1 (the caller scales by 10**log10_mass).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SFH_FAMILIES",
    "ZDIST_FAMILIES",
    "AgeGridSampling",
    "make_age_sampling",
    "sfh_weights",
    "zdist_weights",
]

_EPS = 1.0e-30


class AgeGridSampling:
    """Per-grid quantities for SFH weight evaluation: (A+1,) age-bin edges
    [yr] (lookback time) as float32."""

    def __init__(self, edges: np.ndarray, device):
        self.edges = torch.as_tensor(np.asarray(edges, np.float32), device=device)
        self.n_bins = len(edges) - 1


def make_age_sampling(age_bin_edges_yr: np.ndarray, device,
                      n_sub: int = 4) -> AgeGridSampling:
    """Build the per-grid sampling structure (`n_sub` kept for signature
    parity; bin masses come from CDFs, not sub-sampling)."""
    del n_sub
    return AgeGridSampling(age_bin_edges_yr, device)


def _cdf_lognormal(p, x):
    """SFR(x) ∝ (1/x) exp(−(ln x − μ)²/2τ²) ⇒ M(x) ∝ Φ((ln x − μ)/τ), with
    the SFR mode at lookback `peak_age`: μ = ln(max_age − peak_age) + τ².
    `x` is (B, A+1); parameters are (B,)."""
    tau = torch.clamp(p["tau"], min=1.0e-3)[:, None]
    x_peak = torch.clamp(p["max_age"] - p["peak_age"], min=1.0e4)[:, None]
    mu = torch.log(x_peak) + tau**2
    lnx = torch.log(torch.clamp(x, min=1.0))
    return torch.special.ndtr((lnx - mu) / tau)


SFH_FAMILIES = {"lognormal": _cdf_lognormal}


def sfh_weights(name: str, params: dict, sampling: AgeGridSampling):
    """(B, A) mass-fraction weights over grid age bins, each row summing to 1
    (uniform when the history carries no mass on the grid)."""
    if name not in SFH_FAMILIES:
        raise NotImplementedError(
            f"SFH family {name!r} is not ported yet (ROADMAP M2: the "
            "lognormal family is the one on the mock-library path)")
    max_age = params["max_age"][:, None]
    # lookback bin [e_i, e_{i+1}] -> x interval [max_age-e_{i+1}, max_age-e_i]
    x_at_edges = torch.clamp(max_age - sampling.edges, min=0.0)
    m = SFH_FAMILIES[name](params, x_at_edges)
    w = torch.clamp(m[:, :-1] - m[:, 1:], min=0.0)
    total = torch.sum(w, dim=1, keepdim=True)
    uniform = torch.full_like(w, 1.0 / w.shape[1])
    return torch.where(total > _EPS, w / torch.clamp(total, min=_EPS), uniform)


def _zdist_delta(p, log10_mets):
    """Delta at one metallicity: linear-in-log10Z weight sharing between the
    two neighbouring grid cells."""
    if "log10_metallicity" in p:
        lz = p["log10_metallicity"]
    else:
        lz = torch.log10(torch.clamp(p["metallicity"], min=1.0e-12))
    lz = torch.clamp(lz, log10_mets[0], log10_mets[-1])
    n = log10_mets.shape[0]
    idx = torch.clamp(
        torch.searchsorted(log10_mets, lz.contiguous(), right=True) - 1,
        0, n - 2)
    lo, hi = log10_mets[idx], log10_mets[idx + 1]
    frac = (lz - lo) / torch.clamp(hi - lo, min=1.0e-12)
    w = torch.zeros(lz.shape[0], n, dtype=lz.dtype, device=lz.device)
    w.scatter_(1, idx[:, None], (1.0 - frac)[:, None])
    w.scatter_add_(1, (idx + 1)[:, None], frac[:, None])
    return w


ZDIST_FAMILIES = {"delta": _zdist_delta}


def zdist_weights(name: str, params: dict, log10_mets: torch.Tensor):
    """(B, Z) metallicity weights, each row summing to 1."""
    if name not in ZDIST_FAMILIES:
        raise NotImplementedError(
            f"metallicity distribution {name!r} is not ported yet (ROADMAP "
            "M2: the delta family is the one on the mock-library path)")
    return ZDIST_FAMILIES[name](params, log10_mets)
