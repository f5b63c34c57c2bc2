"""Monotone-transformer flows: NAF, UNAF, SOSPF and Gaussianization (GF).

Counterpart of `synference_tpu/flows/monotone.py` (`make_naf`, `make_unaf`,
`make_sospf`, `make_gf`). NAF, UNAF and SOSPF share one scaffold: a MADE
conditioner gives every coordinate its transformer parameters in one pass,
and the elementwise transformer is strictly increasing with a closed-form
derivative, so `log_prob` is exact. GF alternates a mixture-of-logistics CDF
followed by the probit with Householder reflections; its context enters
through an MLP hypernetwork.

Sampling inverts each transformer by a fixed bisection: 50 halvings of
[-512, 512], the reference's own semantics (1024 / 2⁵⁰ lies far below fp32
resolution). The halvings and the coordinate loop are device operations
with no host read. Every tensor carries a leading member axis K.

Where a mixture CDF u nears 1, NAF's logit and GF's probit take 1 − u from
its own sum of σ(−·) instead of subtracting u from 1: the JAX package's
form turns one float32 ulp of u into up to 1e-2 there (GF's probit slope at
1 − 1e-6 is 2e5), so two devices that round u apart by an ulp disagree.
The functions are the same; only the rounding differs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .maf import _reverse_perms, _set_column
from .made import made_apply, made_init, made_masks
from .mlp import mlp_apply, mlp_init

__all__ = ["make_naf", "make_unaf", "make_sospf", "make_gf"]

_LOG_2PI = math.log(2.0 * math.pi)
_BISECT_LO, _BISECT_HI = -512.0, 512.0
_BISECT_ITERS = 50


def _bisect_inverse(transformer, y, p):
    """Solve T(x; p) = y for a monotone-increasing T by fixed bisection;
    transformer(x (..., D), p (..., D, n_p)) -> (T(x), logdet)."""
    lo = torch.full_like(y, _BISECT_LO)
    hi = torch.full_like(y, _BISECT_HI)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        below = transformer(mid, p)[0] < y
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _normal_base(dim, generator, shape):
    return torch.randn(tuple(shape) + (dim,), generator=generator,
                       device=generator.device)


class _Autoregressive:
    """MADE conditioner -> per-coordinate monotone transformer, over
    (K, B, ·) tensors. `transformer(params, t)` gives block t's
    transformer(x (..., D), p (..., D, n_p)) -> (y, logdet per coordinate);
    `extra_init(generator, n_members)` adds parameters beside the blocks."""

    def __init__(self, dim, context_dim, n_p, hidden_features,
                 num_transforms, n_layers, device):
        self.dim, self.context_dim = int(dim), int(context_dim)
        self.n_p = int(n_p)
        self.hidden = tuple([int(hidden_features)] * int(n_layers))
        self.num_transforms = int(num_transforms)
        self.perms, self.inv_perms = _reverse_perms(
            self.dim, self.num_transforms, device)
        self.masks = [torch.as_tensor(m, device=device)
                      for m in made_masks(self.dim, self.hidden, self.n_p)]

    def extra_init(self, generator, n_members) -> dict:
        return {}

    def init(self, generator: torch.Generator, n_members: int) -> dict:
        out = {"blocks": [made_init(generator, self.dim, self.context_dim,
                                    self.hidden, self.n_p, n_members)
                          for _ in range(self.num_transforms)]}
        out.update(self.extra_init(generator, n_members))
        return out

    def _params_for(self, block, theta, x):
        out = made_apply(block, self.masks, theta, x)
        return out.unflatten(-1, (self.dim, self.n_p))

    def forward(self, params, theta, x):
        total = torch.zeros(theta.shape[:-1], device=theta.device)
        h = theta
        for t in range(self.num_transforms):
            h = torch.index_select(h, -1, self.perms[t])
            p = self._params_for(params["blocks"][t], h, x)
            h, ld = self.transformer(params, t)(h, p)
            total = total + ld.sum(dim=-1)
        return h, total

    def log_prob(self, params, theta, x):
        h, total = self.forward(params, theta, x)
        return total - 0.5 * (h * h).sum(dim=-1) - 0.5 * self.dim * _LOG_2PI

    def draw_base(self, generator, shape):
        return _normal_base(self.dim, generator, shape)

    def inverse(self, params, z, x):
        """Base points (K, B, D) -> θ (K, B, D): per block, coordinate d by
        bisection once θ_<d is known."""
        h = z
        for t in reversed(range(self.num_transforms)):
            transformer = self.transformer(params, t)
            theta = torch.zeros_like(h)
            for d in range(self.dim):
                p = self._params_for(params["blocks"][t], theta, x)
                x_d = _bisect_inverse(transformer, h[..., d:d + 1],
                                      p[..., d:d + 1, :])
                theta = _set_column(theta, d, x_d[..., 0])
            h = torch.index_select(theta, -1, self.inv_perms[t])
        return h


class _NAF(_Autoregressive):
    """Deep sigmoidal flow: T(x) = logit(Σ_k w_k σ(s_k x + b_k)), w by
    softmax, s = softplus + 1e-6."""

    _EPS = 1.0e-6

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 n_layers, num_components, device):
        self.k = int(num_components)
        super().__init__(dim, context_dim, 3 * self.k, hidden_features,
                         num_transforms, n_layers, device)

    def _transform(self, xv, p):
        k, eps = self.k, self._EPS
        w = torch.softmax(p[..., :k], dim=-1)
        s = F.softplus(p[..., k:2 * k]) + eps
        arg = s * xv.unsqueeze(-1) + p[..., 2 * k:]
        sig, sig_neg = torch.sigmoid(arg), torch.sigmoid(-arg)
        # u and 1 − u each as its own sum, so that log(1 − u) keeps its
        # digits where u rounds to within a few ulps of 1
        u = torch.clamp((w * sig).sum(dim=-1), eps, 1.0 - eps)
        v = torch.clamp((w * sig_neg).sum(dim=-1), eps, 1.0 - eps)
        log_u, log_v = torch.log(u), torch.log(v)
        du = (w * s * sig * sig_neg).sum(dim=-1)
        return log_u - log_v, torch.log(du + 1.0e-20) - log_u - log_v

    def transformer(self, params, t):
        return self._transform


class _UNAF(_Autoregressive):
    """Unconstrained monotone network: T(x) = b₀ + ∫₀ˣ g(t, h) dt with g a
    positive tanh MLP per block, by fixed Gauss–Legendre quadrature. The
    MADE gives each coordinate an embedding h and the offset b₀."""

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 n_layers, embed_dim, integrand_hidden, n_quad, device):
        self.e, self.integrand_hidden = int(embed_dim), int(integrand_hidden)
        nodes, weights = np.polynomial.legendre.leggauss(int(n_quad))
        self.nodes = torch.as_tensor(nodes, dtype=torch.float32,
                                     device=device)
        self.weights = torch.as_tensor(weights, dtype=torch.float32,
                                       device=device)
        super().__init__(dim, context_dim, self.e + 1, hidden_features,
                         num_transforms, n_layers, device)

    def extra_init(self, generator, n_members) -> dict:
        sizes = [1 + self.e, self.integrand_hidden, self.integrand_hidden, 1]
        return {"g": [mlp_init(generator, sizes, n_members, zero_last=False)
                      for _ in range(self.num_transforms)]}

    @staticmethod
    def _g(gp, t, h):
        """Integrand at t (K, ..., Q) for embeddings h (K, ..., E):
        elu(MLP([t, h])) + 1 + 1e-4 > 0."""
        hq = h.unsqueeze(-2).expand(t.shape + h.shape[-1:])
        z = mlp_apply(gp, torch.cat([t.unsqueeze(-1), hq], dim=-1),
                      activation=torch.tanh)
        return F.elu(z[..., 0]) + 1.0 + 1.0e-4

    def transformer(self, params, t):
        gp = params["g"][t]

        def transform(xv, p):
            h, b0 = p[..., :self.e], p[..., self.e]
            half = 0.5 * xv
            # (..., Q) nodes spanning [0, x]
            tq = half.unsqueeze(-1) * (self.nodes + 1.0)
            integral = half * (self.weights * self._g(gp, tq, h)).sum(dim=-1)
            return (b0 + integral,
                    torch.log(self._g(gp, xv.unsqueeze(-1), h)[..., 0]))

        return transform


class _SOSPF(_Autoregressive):
    """Sum-of-squares polynomial flow: T(x) = c + λx + Σ_k ∫₀ˣ̃ P_k(u)² du on
    the saturating argument x̃ = 4·tanh(x/4), P_k of degree R with
    0.3·tanh-bounded coefficients, λ = softplus(clamp(raw, -10, 3)) + 1e-4."""

    _SAT = 4.0

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 n_layers, num_polys, poly_degree, device):
        self.k, self.r = int(num_polys), int(poly_degree)
        lpow = np.arange(self.r + 1)
        self.inv_lm = torch.as_tensor(
            1.0 / (lpow[:, None] + lpow[None, :] + 1.0), dtype=torch.float32,
            device=device)
        super().__init__(dim, context_dim, self.k * (self.r + 1) + 2,
                         hidden_features, num_transforms, n_layers, device)

    def _transform(self, xv, p):
        k, r1 = self.k, self.r + 1
        a = 0.3 * torch.tanh(p[..., :k * r1].unflatten(-1, (k, r1)))
        c = p[..., k * r1]
        lam = F.softplus(torch.clamp(p[..., k * r1 + 1], -10.0, 3.0)) + 1.0e-4
        t = torch.tanh(xv / self._SAT)
        xs = self._SAT * t
        pows = [torch.ones_like(xs)]
        for _ in range(self.r):
            pows.append(pows[-1] * xs)
        xpow = torch.stack(pows, dim=-1)  # (..., R+1): xs⁰..xsᴿ
        x_lm = (xpow.unsqueeze(-1) * xpow.unsqueeze(-2)
                * xs[..., None, None])  # xs^(l+m+1)
        # Σ_k Σ_lm a_kl a_km x^(l+m+1)/(l+m+1), elementwise products only
        quad = (a.unsqueeze(-1) * a.unsqueeze(-2)
                * (self.inv_lm * x_lm).unsqueeze(-3)).sum(dim=(-3, -2, -1))
        pk = (a * xpow.unsqueeze(-2)).sum(dim=-1)
        deriv = lam + (pk * pk).sum(dim=-1) * (1.0 - t * t)
        return c + lam * xv + quad, torch.log(deriv)

    def transformer(self, params, t):
        return self._transform


class _GF:
    """Gaussianization flow over (K, B, ·) tensors: per block, an
    elementwise mixture-of-logistics CDF, the probit, a 0.05 linear blend,
    then `n_householder` Householder reflections (log-det 0)."""

    _EPS = 1.0e-6
    _BETA = 0.05

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 n_layers, num_components, n_householder, device):
        self.dim, self.context_dim = int(dim), int(context_dim)
        self.hidden, self.n_layers = int(hidden_features), int(n_layers)
        self.num_transforms = int(num_transforms)
        self.k, self.n_householder = int(num_components), int(n_householder)
        self.n_p = 3 * self.k

    def init(self, generator: torch.Generator, n_members: int) -> dict:
        sizes = ([max(self.context_dim, 1)] + [self.hidden] * self.n_layers
                 + [self.dim * self.n_p])
        return {"layers": [
            {"hyper": mlp_init(generator, sizes, n_members),
             "v": [torch.randn((n_members, self.dim), generator=generator,
                               device=generator.device)
                   for _ in range(self.n_householder)]}
            for _ in range(self.num_transforms)]}

    def _hyper(self, hp, x):
        h = x if self.context_dim > 0 else torch.ones(
            x.shape[:-1] + (1,), device=x.device)
        return mlp_apply(hp, h).unflatten(-1, (self.dim, self.n_p))

    def _elementwise(self, xv, p):
        """MoL CDF then probit, blended with β·x; (y, logdet per
        coordinate). σ(1.702·x) ≈ Φ(x), so zero parameters start near the
        identity."""
        k, eps, beta = self.k, self._EPS, self._BETA
        w = torch.softmax(p[..., :k], dim=-1)
        inv_s = 1.702 * torch.exp(-torch.clamp(p[..., 2 * k:], -6.0, 6.0))
        arg = (xv.unsqueeze(-1) - p[..., k:2 * k]) * inv_s
        sig, sig_neg = torch.sigmoid(arg), torch.sigmoid(-arg)
        # the probit of u above one half from 1 − u, summed on its own: the
        # probit's slope near 1 − 1e-6 turns one float32 ulp of u into 1e-2
        u = (w * sig).sum(dim=-1)
        v = (w * sig_neg).sum(dim=-1)
        yg = torch.where(u < 0.5,
                         torch.special.ndtri(torch.clamp(u, eps, 1.0 - eps)),
                         -torch.special.ndtri(torch.clamp(v, eps, 1.0 - eps)))
        du = (w * inv_s * sig * sig_neg).sum(dim=-1)
        phi = torch.exp(-0.5 * yg * yg) / math.sqrt(2.0 * math.pi)
        dy = (1.0 - beta) * du / torch.clamp(phi, min=1.0e-30) + beta
        return (1.0 - beta) * yg + beta * xv, torch.log(dy)

    @staticmethod
    def _reflect(h, v):
        """h (K, B, D) reflected in the hyperplane normal to v (K, D)."""
        vn = (v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                   + 1.0e-8)).unsqueeze(-2)
        return h - 2.0 * (h * vn).sum(dim=-1, keepdim=True) * vn

    def forward(self, params, theta, x):
        total = torch.zeros(theta.shape[:-1], device=theta.device)
        h = theta
        for layer in params["layers"]:
            h, ld = self._elementwise(h, self._hyper(layer["hyper"], x))
            total = total + ld.sum(dim=-1)
            for v in layer["v"]:
                h = self._reflect(h, v)
        return h, total

    def log_prob(self, params, theta, x):
        h, total = self.forward(params, theta, x)
        return total - 0.5 * (h * h).sum(dim=-1) - 0.5 * self.dim * _LOG_2PI

    def draw_base(self, generator, shape):
        return _normal_base(self.dim, generator, shape)

    def inverse(self, params, z, x):
        """Base points -> θ: the reflections in reverse order (each is an
        involution), then the elementwise map by bisection."""
        h = z
        for layer in reversed(params["layers"]):
            for v in reversed(layer["v"]):
                h = self._reflect(h, v)
            h = _bisect_inverse(self._elementwise, h,
                                self._hyper(layer["hyper"], x))
        return h


def make_naf(dim: int, context_dim: int, hidden_features: int = 50,
             num_transforms: int = 3, n_layers: int = 2,
             num_components: int = 8, *, device):
    """Deep sigmoidal flow with the JAX package's defaults."""
    return _NAF(dim, context_dim, hidden_features, num_transforms, n_layers,
                num_components, torch.device(device))


def make_unaf(dim: int, context_dim: int, hidden_features: int = 50,
              num_transforms: int = 3, n_layers: int = 2,
              embed_dim: int = 8, integrand_hidden: int = 32,
              n_quad: int = 24, *, device):
    """Unconstrained monotone network flow with the JAX package's
    defaults."""
    return _UNAF(dim, context_dim, hidden_features, num_transforms, n_layers,
                 embed_dim, integrand_hidden, n_quad, torch.device(device))


def make_sospf(dim: int, context_dim: int, hidden_features: int = 50,
               num_transforms: int = 3, n_layers: int = 2,
               num_polys: int = 2, poly_degree: int = 2, *, device):
    """Sum-of-squares polynomial flow with the JAX package's defaults."""
    return _SOSPF(dim, context_dim, hidden_features, num_transforms,
                  n_layers, num_polys, poly_degree, torch.device(device))


def make_gf(dim: int, context_dim: int, hidden_features: int = 50,
            num_transforms: int = 4, n_layers: int = 2,
            num_components: int = 8, n_householder: int = 2, *, device):
    """Gaussianization flow with the JAX package's defaults."""
    return _GF(dim, context_dim, hidden_features, num_transforms, n_layers,
               num_components, n_householder, torch.device(device))
