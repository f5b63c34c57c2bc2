"""Mixture density network: a conditional mixture of full-covariance
Gaussians.

Counterpart of `synference_tpu/flows/mdn.py` (`make_mdn`, which serves
"mdn" and, with one component, "gaussian"). Each component's covariance is
given by its lower-triangular Cholesky factor, whose diagonal is
1e-3 + softplus(raw + softplus⁻¹(1)); `log_prob` is one triangular solve
per component. Sampling picks a component by the Gumbel-max rule from
uniforms and moves normals through its factor: both draws come in as one
base tensor, the D normals followed by one uniform per component, so that a
caller can pass the JAX package's draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .mlp import mlp_apply

__all__ = ["make_mdn"]

_LOG_2PI = math.log(2.0 * math.pi)
_D_OFFSET = float(np.log(np.expm1(1.0)))  # softplus⁻¹(1): unit diagonal at 0


class _MDN:
    """Conditional mixture of Gaussians over (K, B, ·) tensors."""

    def __init__(self, dim, context_dim, hidden_features, num_components,
                 n_layers, device):
        self.dim, self.context_dim = int(dim), int(context_dim)
        self.hidden, self.n_layers = int(hidden_features), int(n_layers)
        self.nc = int(num_components)
        self.n_tril = self.dim * (self.dim + 1) // 2
        self.n_out = self.nc * (1 + self.dim + self.n_tril)
        rows, cols = np.tril_indices(self.dim)
        self._flat = torch.as_tensor(rows * self.dim + cols, device=device)
        self._is_diag = torch.as_tensor(rows == cols, device=device)
        self._diag_pos = torch.as_tensor(np.where(rows == cols)[0],
                                         device=device)

    def init(self, generator: torch.Generator, n_members: int) -> dict:
        """He-initialised MLP with a zero head, whose mean biases are spread
        by N(0, 0.1²) so that the components can differentiate."""
        dev = generator.device
        sizes = [self.context_dim] + [self.hidden] * self.n_layers + [
            self.n_out]
        layers = []
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = math.sqrt(2.0 / a) * torch.randn(
                (n_members, b, a), generator=generator, device=dev)
            layers.append({"w": w, "b": torch.zeros((n_members, b),
                                                    device=dev)})
        layers[-1]["w"] = torch.zeros_like(layers[-1]["w"])
        spread = 0.1 * torch.randn((n_members, self.nc * self.dim),
                                   generator=generator, device=dev)
        layers[-1]["b"][:, self.nc:self.nc * (1 + self.dim)] = spread
        return {"mlp": layers}

    def _heads(self, params, x):
        """Mixture logits (K, B, nc), means (K, B, nc, D), the Cholesky
        factors (K, B, nc, D, D) and Σ log diag (K, B, nc)."""
        h = mlp_apply(params["mlp"], x)
        nc, d = self.nc, self.dim
        logits = h[..., :nc]
        mus = h[..., nc:nc * (1 + d)].unflatten(-1, (nc, d))
        tril_raw = h[..., nc * (1 + d):].unflatten(-1, (nc, self.n_tril))
        diag = 1.0e-3 + F.softplus(
            torch.index_select(tril_raw, -1, self._diag_pos) + _D_OFFSET)
        values = torch.where(
            self._is_diag,
            torch.zeros_like(tril_raw).index_copy(-1, self._diag_pos, diag),
            tril_raw)
        chol = torch.zeros(tril_raw.shape[:-1] + (d * d,), dtype=h.dtype,
                           device=h.device).index_copy(-1, self._flat, values)
        return (logits, mus, chol.unflatten(-1, (d, d)),
                torch.log(diag).sum(dim=-1))

    def log_prob(self, params, theta, x):
        logits, mus, chol, half_logdet = self._heads(params, x)
        diff = theta.unsqueeze(-2) - mus  # (K, B, nc, D)
        y = torch.linalg.solve_triangular(chol, diff.unsqueeze(-1),
                                          upper=False).squeeze(-1)
        log_comp = (-0.5 * (y * y).sum(dim=-1) - half_logdet
                    - 0.5 * self.dim * _LOG_2PI)
        return torch.logsumexp(torch.log_softmax(logits, dim=-1) + log_comp,
                               dim=-1)

    @property
    def base_dim(self) -> int:
        return self.dim + self.nc

    def draw_base(self, generator, shape):
        """D standard normals, then nc uniforms in [tiny, 1) for the
        component choice (the range of JAX's Gumbel draws)."""
        dev = generator.device
        eps = torch.randn(tuple(shape) + (self.dim,), generator=generator,
                          device=dev)
        u = torch.rand(tuple(shape) + (self.nc,), generator=generator,
                       device=dev).clamp_(min=torch.finfo(torch.float32).tiny)
        return torch.cat([eps, u], dim=-1)

    def inverse(self, params, base, x):
        """Base draws (K, B, D + nc) -> θ (K, B, D): component
        argmax(logits + Gumbel(u)), then μ + L ε."""
        eps, u = base[..., :self.dim], base[..., self.dim:]
        logits, mus, chol, _ = self._heads(params, x)
        comp = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        idx = comp[..., None, None]
        mu = torch.gather(mus, -2, idx.expand(*comp.shape, 1, self.dim))
        lower = torch.gather(chol, -3, idx.unsqueeze(-1).expand(
            *comp.shape, 1, self.dim, self.dim))
        return mu.squeeze(-2) + (lower.squeeze(-3)
                                 * eps.unsqueeze(-2)).sum(dim=-1)


def make_mdn(dim: int, context_dim: int, hidden_features: int = 50,
             num_components: int = 10, n_layers: int = 2, *, device):
    """Conditional mixture of `num_components` full-covariance Gaussians
    with the JAX package's head layout."""
    return _MDN(dim, context_dim, hidden_features, num_components, n_layers,
                torch.device(device))
