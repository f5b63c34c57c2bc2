"""Coupling flows: rational-quadratic splines (Durkan et al. 2019), their
circular form, and affine coupling.

Counterpart of `synference_tpu/flows/nsf.py` (`make_nsf`, `make_ncsf`,
`make_affine_coupling`, `rqs_forward`, `rqs_inverse`). Every tensor carries a
leading member axis K, so an ensemble evaluates as one set of batched
products. The bin that holds a point is found with `torch.searchsorted` and
read with one `gather`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .mlp import mlp_apply, mlp_init

__all__ = ["make_nsf", "make_ncsf", "make_affine_coupling", "rqs_forward",
           "rqs_inverse"]

_MIN_W = 1.0e-3  # min bin width/height fraction
_MIN_D = 1.0e-3  # min derivative
_D_OFFSET = float(np.log(np.expm1(1.0 - _MIN_D)))  # softplus^-1(1 - min)


def _spline_params(raw, n_bins: int, tail_bound: float,
                   circular: bool = False):
    """Split conditioner output (..., 3K+1) into knots and derivatives.

    Returns cumwidths (..., K+1), cumheights (..., K+1), derivs (..., K+1)
    with the boundary derivatives pinned to 1 (linear tails), or with
    `circular` both tied to the first learned one (a periodic spline),
    widths and heights (..., K)."""
    sizes = raw[..., :2 * n_bins].unflatten(-1, (2, n_bins))  # w and h
    d_raw = raw[..., 2 * n_bins:]
    sizes = _MIN_W + (1.0 - _MIN_W * n_bins) * torch.softmax(sizes, dim=-1)
    # knots = running sums with a leading zero, as products with a 0/1
    # triangle summed over the bins: plain fp32 whatever the TF32 setting
    # (`torch.cumsum` over so short an axis is by far the slowest kernel of
    # a step on a card)
    below = torch.ones((n_bins + 1, n_bins), dtype=raw.dtype,
                       device=raw.device).tril(-1)
    knots = (sizes.unsqueeze(-2) * below).sum(dim=-1)  # (..., 2, K+1)
    cumw, cumh = (2.0 * tail_bound * knots - tail_bound).unbind(dim=-2)
    widths, heights = (2.0 * tail_bound * sizes).unbind(dim=-2)
    # the offset makes raw = 0 give derivative exactly 1 (identity at init)
    derivs = _MIN_D + F.softplus(d_raw + _D_OFFSET)
    edge = derivs[..., :1] if circular else torch.ones_like(derivs[..., :1])
    derivs = torch.cat([edge, derivs[..., 1:-1], edge], dim=-1)
    return cumw, cumh, derivs, widths, heights


def _bin_values(knots, x, cumw, cumh, derivs, widths, heights):
    """The bin of `knots` (..., K+1) that holds x (...): knot_k <= x <
    knot_{k+1}, points at or beyond the last knot in the last bin, points
    below the first in the first. Returns that bin's (x_k, w_k, h_k, y_k,
    d_k, d_{k+1})."""
    n_bins = widths.shape[-1]
    idx = torch.searchsorted(knots.detach().contiguous(),
                             x.detach().unsqueeze(-1).contiguous(),
                             right=True) - 1
    idx = idx.clamp_(0, n_bins - 1)  # (..., 1)
    per_bin = torch.stack([cumw[..., :-1], widths, heights, cumh[..., :-1],
                           derivs[..., :-1], derivs[..., 1:]], dim=-2)
    picked = torch.gather(per_bin, -1,
                          idx.unsqueeze(-2).expand(*idx.shape[:-1], 6, 1))
    return picked.squeeze(-1).unbind(-1)


def _log_det(sk, dk, dk1, xi, xi1m, denom):
    return (2.0 * torch.log(sk)
            + torch.log(dk1 * xi * xi + 2.0 * sk * xi * xi1m
                        + dk * xi1m * xi1m)
            - 2.0 * torch.log(denom))


def _wrap_or_clamp(x, tail_bound: float, circular: bool):
    """(points inside the spline's interval, the points the spline sees):
    wrapped into [-tail_bound, tail_bound) when circular, else clamped."""
    if circular:
        return (torch.ones_like(x, dtype=torch.bool),
                torch.remainder(x + tail_bound, 2.0 * tail_bound)
                - tail_bound)
    return ((x > -tail_bound) & (x < tail_bound),
            torch.clamp(x, -tail_bound, tail_bound))


def rqs_forward(x, raw, n_bins: int, tail_bound: float,
                circular: bool = False):
    """Elementwise RQ spline x -> y with log|dy/dx|; identity outside
    (-tail_bound, tail_bound), or periodic wrapping when `circular`."""
    cumw, cumh, derivs, widths, heights = _spline_params(
        raw, n_bins, tail_bound, circular)
    inside, xc = _wrap_or_clamp(x, tail_bound, circular)
    xk, wk, hk, yk, dk, dk1 = _bin_values(cumw, xc, cumw, cumh, derivs,
                                          widths, heights)
    sk = hk / wk
    # the clamp keeps log(denom) finite on clipped points, so the untaken
    # branch of the selects below puts no NaN into the gradient
    xi = torch.clamp((xc - xk) / wk, 0.0, 1.0)
    xi1m = 1.0 - xi
    denom = sk + (dk1 + dk - 2.0 * sk) * xi * xi1m
    y = yk + hk * (sk * xi * xi + dk * xi * xi1m) / denom
    logdet = _log_det(sk, dk, dk1, xi, xi1m, denom)
    return torch.where(inside, y, x), torch.where(inside, logdet, 0.0)


def rqs_inverse(y, raw, n_bins: int, tail_bound: float,
                circular: bool = False):
    """Elementwise RQ spline inverse y -> x with log|dx/dy|."""
    cumw, cumh, derivs, widths, heights = _spline_params(
        raw, n_bins, tail_bound, circular)
    inside, yc = _wrap_or_clamp(y, tail_bound, circular)
    xk, wk, hk, yk, dk, dk1 = _bin_values(cumh, yc, cumw, cumh, derivs,
                                          widths, heights)
    sk = hk / wk
    dy = yc - yk
    # solve a xi^2 + b xi + c = 0 (Durkan et al. eq. 6-8)
    a = hk * (sk - dk) + dy * (dk1 + dk - 2.0 * sk)
    b = hk * dk - dy * (dk1 + dk - 2.0 * sk)
    c = -sk * dy
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    xi = torch.clamp(2.0 * c / (-b - torch.sqrt(disc)), 0.0, 1.0)
    x = xk + xi * wk
    xi1m = 1.0 - xi
    denom = sk + (dk1 + dk - 2.0 * sk) * xi * xi1m
    logdet_fwd = _log_det(sk, dk, dk1, xi, xi1m, denom)
    return torch.where(inside, x, y), torch.where(inside, -logdet_fwd, 0.0)


def _paired_perms(dim: int, num_transforms: int, seed: int, device):
    """Each random permutation followed by its reverse, so that every
    coordinate is transformed at least once per two layers (the JAX
    package's seeds and order), and their inverses."""
    rng = np.random.default_rng(seed)
    perms = []
    for t in range(num_transforms):
        perms.append(rng.permutation(dim) if t % 2 == 0
                     else perms[-1][::-1].copy())
    return ([torch.as_tensor(p, device=device) for p in perms],
            [torch.as_tensor(np.argsort(p), device=device) for p in perms])


class _Coupling:
    """Conditional coupling flow over (K, B, ·) tensors: each block permutes
    θ, keeps its first half and transforms the second half elementwise with
    parameters from an MLP of the kept half and the context.

    Subclasses set `n_raw` (conditioner outputs per transformed coordinate)
    and implement `_transform(tb, raw) -> (y, logdet)` and
    `_untransform(yb, raw) -> x`."""

    seed = 7

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 n_layers, device):
        self.dim, self.context_dim = int(dim), int(context_dim)
        self.hidden, self.n_layers = int(hidden_features), int(n_layers)
        self.num_transforms = int(num_transforms)
        # for dim == 1 the coupling has no pass-through half: the
        # conditioner then sees the context only
        self.half_a = self.dim // 2 if self.dim > 1 else 0
        self.half_b = self.dim - self.half_a
        self.perms, self.inv_perms = _paired_perms(
            self.dim, self.num_transforms, self.seed, device)

    def init(self, generator: torch.Generator, n_members: int) -> dict:
        n_in = max(self.half_a + self.context_dim, 1)
        sizes = [n_in] + [self.hidden] * self.n_layers + [
            self.half_b * self.n_raw]
        return {"blocks": [mlp_init(generator, sizes, n_members)
                           for _ in range(self.num_transforms)]}

    def _raw(self, block, passed, x):
        """Conditioner output (K, B, half_b, n_raw) from the pass-through
        half and the context."""
        parts = ([passed] if self.half_a > 0 else []) + (
            [x] if self.context_dim > 0 else [])
        if not parts:
            parts = [torch.ones(x.shape[:-1] + (1,), device=x.device)]
        raw = mlp_apply(block, torch.cat(parts, dim=-1))
        return raw.reshape(raw.shape[:-1] + (self.half_b, self.n_raw))

    def _prepare(self, theta):
        return theta

    def forward(self, params, theta, x):
        """θ (K, B, D), x (K, B, C) -> base point (K, B, D) and
        Σ log|det| (K, B)."""
        total = torch.zeros(theta.shape[:-1], device=theta.device)
        h = self._prepare(theta)
        for t in range(self.num_transforms):
            h = torch.index_select(h, -1, self.perms[t])
            ta, tb = h[..., :self.half_a], h[..., self.half_a:]
            yb, ld = self._transform(
                tb, self._raw(params["blocks"][t], ta, x))
            h = torch.cat([ta, yb], dim=-1)
            total = total + ld.sum(dim=-1)
        return h, total

    def log_prob(self, params, theta, x):
        h, total = self.forward(params, theta, x)
        return (total - 0.5 * (h * h).sum(dim=-1)
                - 0.5 * self.dim * math.log(2.0 * math.pi))

    def draw_base(self, generator, shape):
        return torch.randn(tuple(shape) + (self.dim,), generator=generator,
                           device=generator.device)

    def inverse(self, params, z, x):
        """Base points (K, B, D) -> θ (K, B, D)."""
        h = z
        for t in reversed(range(self.num_transforms)):
            ya, yb = h[..., :self.half_a], h[..., self.half_a:]
            tb = self._untransform(yb, self._raw(params["blocks"][t], ya, x))
            h = torch.index_select(torch.cat([ya, tb], dim=-1), -1,
                                   self.inv_perms[t])
        return h


class _NSF(_Coupling):
    """Rational-quadratic spline coupling with linear tails."""

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 num_bins, tail_bound, n_layers, device):
        self.num_bins, self.tail_bound = int(num_bins), float(tail_bound)
        self.n_raw = 3 * self.num_bins + 1
        super().__init__(dim, context_dim, hidden_features, num_transforms,
                         n_layers, device)

    def _transform(self, tb, raw):
        return rqs_forward(tb, raw, self.num_bins, self.tail_bound)

    def _untransform(self, yb, raw):
        return rqs_inverse(yb, raw, self.num_bins, self.tail_bound)[0]


class _NCSF(_NSF):
    """Circular splines on the torus [-tail_bound, tail_bound)^D with a
    uniform base density: inputs wrap, and the two boundary derivatives of
    each spline are one learned value."""

    seed = 13

    def _prepare(self, theta):
        return (torch.remainder(theta + self.tail_bound, 2.0 * self.tail_bound)
                - self.tail_bound)

    def _transform(self, tb, raw):
        return rqs_forward(tb, raw, self.num_bins, self.tail_bound, True)

    def _untransform(self, yb, raw):
        return rqs_inverse(yb, raw, self.num_bins, self.tail_bound, True)[0]

    def log_prob(self, params, theta, x):
        _, total = self.forward(params, theta, x)
        return total - self.dim * math.log(2.0 * self.tail_bound)

    def draw_base(self, generator, shape):
        """Uniforms on [-tail_bound, tail_bound)."""
        u = torch.rand(tuple(shape) + (self.dim,), generator=generator,
                       device=generator.device)
        return -self.tail_bound + 2.0 * self.tail_bound * u


class _AffineCoupling(_Coupling):
    """RealNVP coupling: y = x·exp(s) + t with s clamped to ±clamp (NICE,
    additive coupling, is clamp 0)."""

    seed = 11

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 n_layers, clamp_log_scale, device):
        self.clamp = float(clamp_log_scale)
        self.n_raw = 2
        super().__init__(dim, context_dim, hidden_features, num_transforms,
                         n_layers, device)

    def _raw(self, block, passed, x):
        """(log-scale, shift), each (K, B, half_b), in the JAX package's
        order: every scale first, then every shift."""
        raw = super()._raw(block, passed, x).flatten(-2)
        s = torch.clamp(raw[..., :self.half_b], -self.clamp, self.clamp)
        return s, raw[..., self.half_b:]

    def _transform(self, tb, raw):
        s, t = raw
        return tb * torch.exp(s) + t, s

    def _untransform(self, yb, raw):
        s, t = raw
        return (yb - t) * torch.exp(-s)


def make_nsf(dim: int, context_dim: int, hidden_features: int = 50,
             num_transforms: int = 5, num_bins: int = 8,
             tail_bound: float = 3.5, n_layers: int = 2, *, device):
    """Conditional coupling-RQS flow with the JAX package's permutations and
    layer sizes; its `init`, `forward`, `log_prob` and `inverse` work on
    tensors with a leading member axis."""
    return _NSF(dim, context_dim, hidden_features, num_transforms, num_bins,
                tail_bound, n_layers, torch.device(device))


def make_ncsf(dim: int, context_dim: int, hidden_features: int = 50,
              num_transforms: int = 5, num_bins: int = 8,
              tail_bound: float = 5.0, n_layers: int = 2, *, device):
    """Neural circular spline flow: a coupling flow on the torus with a
    uniform base density (the JAX package's permutations and sizes)."""
    return _NCSF(dim, context_dim, hidden_features, num_transforms, num_bins,
                 tail_bound, n_layers, torch.device(device))


def make_affine_coupling(dim: int, context_dim: int,
                         hidden_features: int = 50, num_transforms: int = 5,
                         n_layers: int = 2, clamp_log_scale: float = 4.0, *,
                         device):
    """RealNVP affine coupling ("realnvp", "affine_coupling"; "nice" with
    `clamp_log_scale=0`), with the JAX package's permutations and sizes."""
    return _AffineCoupling(dim, context_dim, hidden_features, num_transforms,
                           n_layers, clamp_log_scale, torch.device(device))
