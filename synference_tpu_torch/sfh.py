"""Star-formation-history and metallicity-distribution weights, batched.

Counterpart of `synference_tpu/sfh.py`: every SFH family (constant,
lognormal, delayed-τ, exponential, rising exponential, Gaussian burst,
double power law and dense-basis) and both metallicity distributions (delta
and normal). Each takes a dict of (B,) parameter tensors ((B, N) for the
dense-basis `fractions`) and returns (B, A) / (B, Z) weights, so a batch is
one tensor expression (the JAX package vmaps a per-galaxy version).

Per-bin masses come exactly from the family's cumulative mass function at
the grid age-bin edges; the double power law, which has no closed form,
integrates its SFR on a 512-node log grid and interpolates the cumulative
(`_numeric_cdf`, with `_interp_clamped` in place of `jnp.interp`). `t` is
lookback time [yr]; `x = max_age − t` is time since onset; weights sum to 1
(the caller scales by 10**log10_mass). The row total is taken with a
cumulative sum, whose bits do not depend on the other rows of the batch
(the particle draws of `sed.py` rely on that).
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


def _get(p, name: str, default: float, like):
    """(B, 1) parameter `name`, or `default` broadcast like `like` (B,)."""
    v = p.get(name)
    if v is None:
        return torch.full_like(like, default)[:, None]
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).expand(
        like.shape)[:, None]


def _cdf_constant(p, x):
    """Constant SFR from onset to `min_age`: M(x) ∝ clip(x, 0, span)."""
    max_age = p["max_age"]
    span = torch.clamp(max_age[:, None] - _get(p, "min_age", 0.0, max_age),
                       min=1.0)
    return torch.clamp(torch.clamp(x, min=0.0), max=span)


def lognormal_shape(p):
    """(μ, τ) of the lognormal SFH, each (B, 1): τ clamped at 1e-3 and the
    SFR mode at lookback `peak_age`, μ = ln(max_age − peak_age) + τ² (the
    onset gap clamped at 1e4 yr). Parameters are (B,)."""
    tau = torch.clamp(p["tau"], min=1.0e-3)[:, None]
    x_peak = torch.clamp(p["max_age"] - p["peak_age"], min=1.0e4)[:, None]
    return torch.log(x_peak) + tau**2, tau


def lognormal_cdf(x, mu, tau):
    """M(x) ∝ Φ((ln x − μ)/τ) at times since onset `x` (B, A+1), x
    clamped at 1 yr; μ and τ (B, 1)."""
    lnx = torch.log(torch.clamp(x, min=1.0))
    return torch.special.ndtr((lnx - mu) / tau)


def _cdf_lognormal(p, x):
    """SFR(x) ∝ (1/x) exp(−(ln x − μ)²/2τ²) ⇒ M(x) ∝ Φ((ln x − μ)/τ)
    (`lognormal_shape`, `lognormal_cdf`). `x` is (B, A+1); parameters are
    (B,)."""
    return lognormal_cdf(x, *lognormal_shape(p))


def _cdf_delayed_tau(p, x):
    """SFR(x) ∝ x e^{−x/τ} ⇒ M(x) ∝ 1 − (1 + x/τ) e^{−x/τ}."""
    tau = torch.clamp(p["tau"], min=1.0e4)[:, None]
    r = torch.clamp(x, min=0.0) / tau
    return -torch.expm1(-r) - r * torch.exp(-r)


def _cdf_exponential(p, x):
    """Declining exponential SFR(x) ∝ e^{−x/τ} ⇒ M(x) ∝ 1 − e^{−x/τ}."""
    tau = torch.clamp(p["tau"], min=1.0e4)[:, None]
    return -torch.expm1(-torch.clamp(x, min=0.0) / tau)


def _cdf_rising_exponential(p, x):
    """Rising exponential SFR(x) ∝ e^{(x−max_age)/τ} ⇒ M(x) ∝
    e^{(x−max_age)/τ} (the exponent stays ≤ 0)."""
    tau = torch.clamp(p["tau"], min=1.0e4)[:, None]
    max_age = p["max_age"][:, None]
    return torch.exp((torch.minimum(x, max_age) - max_age) / tau)


def _cdf_gaussian_burst(p, x):
    """Gaussian burst at lookback `burst_age` with width `sigma` (default
    1e7 yr): M(x) ∝ Φ((x − x_b)/σ), x_b = max_age − burst_age."""
    max_age = p["max_age"]
    sigma = torch.clamp(_get(p, "sigma", 1.0e7, max_age), min=1.0e4)
    x_b = (max_age - p["burst_age"])[:, None]
    return torch.special.ndtr((x - x_b) / sigma)


def _interp_clamped(x, xp, fp):
    """`jnp.interp(x, xp, fp)` row by row: (B, M) queries on (B, N)
    increasing knots, clamped to fp's end values outside [xp_0, xp_−1],
    with jnp.interp's bracketing and arithmetic."""
    n = xp.shape[1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, n - 1)
    x_lo, x_hi = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    f_lo, f_hi = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    dx = x_hi - x_lo
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f_lo,
                    f_lo + ((x - x_lo) / torch.where(dx0, 1.0, dx))
                    * (f_hi - f_lo))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def _numeric_cdf(pdf_fn, p, x, n_nodes: int = 512):
    """Trapezoid-integrate the SFR on a log-x grid from 1 yr to max_age and
    interpolate the cumulative at the (B, A+1) query points."""
    max_age = torch.clamp(p["max_age"], min=10.0)[:, None]
    frac = torch.arange(n_nodes, dtype=torch.float32,
                        device=x.device) / (n_nodes - 1)
    nodes = torch.exp(torch.log(max_age) * frac)  # (B, n) 1 .. max_age
    pdf = pdf_fn(p, nodes)
    seg = 0.5 * (pdf[:, 1:] + pdf[:, :-1]) * torch.diff(nodes, dim=1)
    cum = torch.cat([torch.zeros_like(seg[:, :1]),
                     torch.cumsum(seg, dim=1)], dim=1)
    q = torch.minimum(torch.clamp(x, min=1.0), max_age)
    return _interp_clamped(q, nodes, cum)


def _pdf_double_power_law(p, x):
    """SFR(x) ∝ 1/((x/x0)^α + (x/x0)^−β), x0 = `peak_age` (α, β default 5)."""
    peak = p["peak_age"]
    x0 = torch.clamp(peak, min=1.0e4)[:, None]
    alpha = _get(p, "alpha", 5.0, peak)
    beta = _get(p, "beta", 5.0, peak)
    r = torch.clamp(x, min=1.0) / x0
    return 1.0 / (r**alpha + r ** (-beta))


def _cdf_double_power_law(p, x):
    """Double power law (Diemer+17 style): no closed form; numeric CDF."""
    return _numeric_cdf(_pdf_double_power_law, p, x)


SFH_FAMILIES = {
    "constant": _cdf_constant,
    "lognormal": _cdf_lognormal,
    "delayed_tau": _cdf_delayed_tau,
    "exponential": _cdf_exponential,
    "rising_exponential": _cdf_rising_exponential,
    "double_power_law": _cdf_double_power_law,
    "gaussian_burst": _cdf_gaussian_burst,
}


def _row_total(w):
    """(B, 1) row sums whose bits depend on the row alone."""
    return torch.cumsum(w, dim=1)[:, -1:]


def edge_times(max_age, edges):
    """(B, A+1) times since onset x = max_age − e at the lookback age-bin
    edges `edges` (A+1,), clamped at 0: lookback bin [e_i, e_{i+1}] is the
    x interval [max_age − e_{i+1}, max_age − e_i]. `max_age` is (B,)."""
    return torch.clamp(max_age[:, None] - edges, min=0.0)


def bin_weights(m):
    """(B, A) age-bin weights from the cumulative mass `m` (B, A+1) at the
    edges: the clamped differences over their row total, uniform where the
    total is at most 1e-30."""
    return _normalised(torch.clamp(m[:, :-1] - m[:, 1:], min=0.0))


def _normalised(w):
    total = _row_total(w)
    uniform = torch.full_like(w, 1.0 / w.shape[1])
    return torch.where(total > _EPS, w / torch.clamp(total, min=_EPS), uniform)


def sfh_weights(name: str, params: dict, sampling: AgeGridSampling):
    """(B, A) mass-fraction weights over grid age bins, each row summing to 1
    (uniform when the history carries no mass on the grid). `name` is a key
    of `SFH_FAMILIES` or "dense_basis"."""
    if name == "dense_basis":
        return _normalised(_dense_basis_weights(params, sampling))
    if name not in SFH_FAMILIES:
        raise ValueError(f"unknown SFH family {name!r}")
    x_at_edges = edge_times(params["max_age"], sampling.edges)
    return bin_weights(SFH_FAMILIES[name](params, x_at_edges))


def _dense_basis_weights(params: dict, sampling: AgeGridSampling):
    """Dense-Basis (non-parametric) SFH: `fractions` (B, N) of mass in N
    equal-log lookback bins over [min_age, max_age] (min_age default 1e6
    yr), SFR constant within each bin and at the bin-0 level below min_age;
    per-grid-bin masses from exact interval overlaps."""
    max_age = params["max_age"]
    fr = torch.as_tensor(params["fractions"], dtype=torch.float32,
                         device=max_age.device)
    if fr.ndim == 1:
        fr = fr.expand(max_age.shape[0], -1)
    n_bins = fr.shape[1]
    min_age = _get(params, "min_age", 1.0e6, max_age)  # (B, 1)
    log_lo = torch.log10(min_age)
    log_hi = torch.log10(torch.maximum(max_age[:, None], min_age * 1.01))
    steps = torch.arange(n_bins + 1, dtype=torch.float32,
                         device=fr.device) / n_bins
    db_edges = torch.pow(10.0, log_lo + (log_hi - log_lo) * steps)  # (B, N+1)
    levels = fr / torch.clamp(db_edges[:, 1:] - db_edges[:, :-1], min=1.0)
    e = sampling.edges
    ge_lo, ge_hi = e[:-1][None, :, None], e[1:][None, :, None]  # (1, A, 1)
    db_lo, db_hi = db_edges[:, None, :-1], db_edges[:, None, 1:]  # (B, 1, N)
    overlap = torch.clamp(torch.minimum(ge_hi, db_hi)
                          - torch.maximum(ge_lo, db_lo), min=0.0)  # (B, A, N)
    w = (overlap * levels[:, None, :]).sum(-1)
    # ongoing star formation below min_age at the youngest-bin level
    below = torch.clamp(torch.minimum(e[1:][None, :], min_age) - e[:-1][None, :],
                        min=0.0)
    return w + below * levels[:, :1]


def delta_cells(p, log10_mets):
    """(idx, frac) (B,) of the delta metallicity: the lower of the two grid
    cells around log10 Z (clamped to the grid) and the upper one's share,
    linear in log10 Z."""
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
    return idx, (lz - lo) / torch.clamp(hi - lo, min=1.0e-12)


def delta_weights(idx, frac, n: int):
    """(B, n) weights 1 − frac at cell idx and frac at idx + 1 (`delta_cells`)."""
    # out of place: the weights carry θ's tangents under torch.func
    w = torch.zeros(idx.shape[0], n, dtype=frac.dtype, device=frac.device)
    return w.scatter(1, idx[:, None], (1.0 - frac)[:, None]).scatter_add(
        1, (idx + 1)[:, None], frac[:, None])


def _zdist_delta(p, log10_mets):
    """Delta at one metallicity: linear-in-log10Z weight sharing between the
    two neighbouring grid cells."""
    return delta_weights(*delta_cells(p, log10_mets), log10_mets.shape[0])


def _zdist_normal(p, log10_mets):
    """Gaussian in log10 Z (width `log10_sigma`, default 0.2 dex) over the
    grid cells, renormalised."""
    mu = p["log10_metallicity"]
    sigma = torch.clamp(_get(p, "log10_sigma", 0.2, mu), min=1.0e-3)
    w = torch.exp(-0.5 * ((log10_mets[None, :] - mu[:, None]) / sigma) ** 2)
    return w / (_row_total(w) + _EPS)


ZDIST_FAMILIES = {"delta": _zdist_delta, "normal": _zdist_normal}


def zdist_weights(name: str, params: dict, log10_mets: torch.Tensor):
    """(B, Z) metallicity weights, each row summing to 1."""
    if name not in ZDIST_FAMILIES:
        raise ValueError(f"unknown metallicity distribution {name!r}")
    return ZDIST_FAMILIES[name](params, log10_mets)
