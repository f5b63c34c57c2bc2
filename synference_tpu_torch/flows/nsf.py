"""Neural spline flow: rational-quadratic coupling (Durkan et al. 2019).

Counterpart of `synference_tpu/flows/nsf.py` (`make_nsf`, `rqs_forward`,
`rqs_inverse`). Every tensor carries a leading member axis K, so an ensemble
evaluates as one set of batched products. The bin that holds a point is found
with `torch.searchsorted` and read with one `gather`; the circular and
affine-coupling variants of the JAX module wait for ROADMAP M11.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .mlp import mlp_apply, mlp_init

__all__ = ["make_nsf", "rqs_forward", "rqs_inverse"]

_MIN_W = 1.0e-3  # min bin width/height fraction
_MIN_D = 1.0e-3  # min derivative
_D_OFFSET = float(np.log(np.expm1(1.0 - _MIN_D)))  # softplus^-1(1 - min)


def _spline_params(raw, n_bins: int, tail_bound: float):
    """Split conditioner output (..., 3K+1) into knots and derivatives.

    Returns cumwidths (..., K+1), cumheights (..., K+1), derivs (..., K+1)
    with the boundary derivatives pinned to 1 (linear tails), widths and
    heights (..., K)."""
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
    ones = torch.ones_like(derivs[..., :1])
    derivs = torch.cat([ones, derivs[..., 1:-1], ones], dim=-1)
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


def rqs_forward(x, raw, n_bins: int, tail_bound: float):
    """Elementwise RQ spline x -> y with log|dy/dx|; identity outside
    (-tail_bound, tail_bound)."""
    cumw, cumh, derivs, widths, heights = _spline_params(
        raw, n_bins, tail_bound)
    inside = (x > -tail_bound) & (x < tail_bound)
    xc = torch.clamp(x, -tail_bound, tail_bound)
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


def rqs_inverse(y, raw, n_bins: int, tail_bound: float):
    """Elementwise RQ spline inverse y -> x with log|dx/dy|."""
    cumw, cumh, derivs, widths, heights = _spline_params(
        raw, n_bins, tail_bound)
    inside = (y > -tail_bound) & (y < tail_bound)
    yc = torch.clamp(y, -tail_bound, tail_bound)
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


class _NSF:
    """Conditional coupling-RQS flow over (K, B, ·) tensors."""

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 num_bins, tail_bound, n_layers, device):
        self.dim, self.context_dim = int(dim), int(context_dim)
        self.hidden, self.n_layers = int(hidden_features), int(n_layers)
        self.num_transforms, self.num_bins = int(num_transforms), int(num_bins)
        self.tail_bound = float(tail_bound)
        self.n_raw = 3 * self.num_bins + 1
        # for dim == 1 the coupling has no pass-through half: the
        # conditioner then sees the context only
        self.half_a = self.dim // 2 if self.dim > 1 else 0
        self.half_b = self.dim - self.half_a
        # each random permutation is followed by its reverse, so every
        # coordinate is transformed at least once per two layers
        rng = np.random.default_rng(7)
        perms = []
        for t in range(self.num_transforms):
            perms.append(rng.permutation(self.dim) if t % 2 == 0
                         else perms[-1][::-1].copy())
        self.perms = [torch.as_tensor(p, device=device) for p in perms]
        self.inv_perms = [torch.as_tensor(np.argsort(p), device=device)
                          for p in perms]

    def init(self, generator: torch.Generator, n_members: int) -> dict:
        n_in = max(self.half_a + self.context_dim, 1)
        sizes = [n_in] + [self.hidden] * self.n_layers + [
            self.half_b * self.n_raw]
        return {"blocks": [mlp_init(generator, sizes, n_members)
                           for _ in range(self.num_transforms)]}

    def _raw(self, block, passed, x):
        """Conditioner output (K, B, half_b, 3·bins+1) from the pass-through
        half and the context."""
        parts = ([passed] if self.half_a > 0 else []) + (
            [x] if self.context_dim > 0 else [])
        if not parts:
            parts = [torch.ones(x.shape[:-1] + (1,), device=x.device)]
        raw = mlp_apply(block, torch.cat(parts, dim=-1))
        return raw.reshape(raw.shape[:-1] + (self.half_b, self.n_raw))

    def forward(self, params, theta, x):
        """θ (K, B, D), x (K, B, C) -> base point (K, B, D) and
        Σ log|det| (K, B)."""
        total = torch.zeros(theta.shape[:-1], device=theta.device)
        h = theta
        for t in range(self.num_transforms):
            h = torch.index_select(h, -1, self.perms[t])
            ta, tb = h[..., :self.half_a], h[..., self.half_a:]
            yb, ld = rqs_forward(tb, self._raw(params["blocks"][t], ta, x),
                                 self.num_bins, self.tail_bound)
            h = torch.cat([ta, yb], dim=-1)
            total = total + ld.sum(dim=-1)
        return h, total

    def log_prob(self, params, theta, x):
        h, total = self.forward(params, theta, x)
        return (total - 0.5 * (h * h).sum(dim=-1)
                - 0.5 * self.dim * math.log(2.0 * math.pi))

    def inverse(self, params, z, x):
        """Base points (K, B, D) -> θ (K, B, D)."""
        h = z
        for t in reversed(range(self.num_transforms)):
            ya, yb = h[..., :self.half_a], h[..., self.half_a:]
            tb, _ = rqs_inverse(yb, self._raw(params["blocks"][t], ya, x),
                                self.num_bins, self.tail_bound)
            h = torch.index_select(torch.cat([ya, tb], dim=-1), -1,
                                   self.inv_perms[t])
        return h


def make_nsf(dim: int, context_dim: int, hidden_features: int = 50,
             num_transforms: int = 5, num_bins: int = 8,
             tail_bound: float = 3.5, n_layers: int = 2, *, device):
    """Conditional coupling-RQS flow with the JAX package's permutations and
    layer sizes; its `init`, `forward`, `log_prob` and `inverse` work on
    tensors with a leading member axis."""
    return _NSF(dim, context_dim, hidden_features, num_transforms, num_bins,
                tail_bound, n_layers, torch.device(device))
