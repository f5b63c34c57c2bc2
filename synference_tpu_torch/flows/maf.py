"""Masked autoregressive flow (Papamakarios et al. 2017), conditional.

Counterpart of `synference_tpu/flows/maf.py` (`make_maf`, which serves
"maf" and "made"). `log_prob` is one MADE pass per block; sampling inverts
each block in `dim` sequential MADE passes, all on the device. Every tensor
carries a leading member axis K.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .made import made_apply, made_init, made_masks

__all__ = ["make_maf"]

_LOG_2PI = math.log(2.0 * math.pi)


def _reverse_perms(dim: int, num_transforms: int, device):
    """The JAX package's alternating reversals, and their inverses."""
    perms, p = [], np.arange(dim)
    for _ in range(num_transforms):
        p = p[::-1].copy()
        perms.append(p.copy())
    return ([torch.as_tensor(q, device=device) for q in perms],
            [torch.as_tensor(np.argsort(q), device=device) for q in perms])


def _set_column(theta, d: int, value):
    """θ with column d replaced by `value` (out of place, differentiable)."""
    return torch.cat([theta[..., :d], value.unsqueeze(-1),
                      theta[..., d + 1:]], dim=-1)


class _MAF:
    """Conditional MAF over (K, B, ·) tensors."""

    def __init__(self, dim, context_dim, hidden_features, num_transforms,
                 n_layers, clamp_log_scale, device):
        self.dim, self.context_dim = int(dim), int(context_dim)
        self.hidden = tuple([int(hidden_features)] * int(n_layers))
        self.num_transforms = int(num_transforms)
        self.clamp = float(clamp_log_scale)
        self.perms, self.inv_perms = _reverse_perms(
            self.dim, self.num_transforms, device)
        self.masks = [torch.as_tensor(m, device=device)
                      for m in made_masks(self.dim, self.hidden, 2)]

    def init(self, generator: torch.Generator, n_members: int) -> dict:
        return {"blocks": [made_init(generator, self.dim, self.context_dim,
                                     self.hidden, 2, n_members)
                           for _ in range(self.num_transforms)]}

    def _mu_log_s(self, block, theta, x):
        out = made_apply(block, self.masks, theta, x)
        log_s = torch.clamp(out[..., 1::2], -self.clamp, self.clamp)
        return out[..., 0::2], log_s

    def forward(self, params, theta, x):
        """θ (K, B, D), x (K, B, C) -> base point (K, B, D) and
        Σ log|det| (K, B)."""
        total = torch.zeros(theta.shape[:-1], device=theta.device)
        h = theta
        for t in range(self.num_transforms):
            h = torch.index_select(h, -1, self.perms[t])
            mu, log_s = self._mu_log_s(params["blocks"][t], h, x)
            h = (h - mu) * torch.exp(-log_s)
            total = total - log_s.sum(dim=-1)
        return h, total

    def log_prob(self, params, theta, x):
        h, total = self.forward(params, theta, x)
        return total - 0.5 * (h * h).sum(dim=-1) - 0.5 * self.dim * _LOG_2PI

    def draw_base(self, generator, shape):
        return torch.randn(tuple(shape) + (self.dim,), generator=generator,
                           device=generator.device)

    def inverse(self, params, z, x):
        """Base points (K, B, D) -> θ (K, B, D): `dim` MADE passes per
        block, θ_d from θ_<d."""
        h = z
        for t in reversed(range(self.num_transforms)):
            theta = torch.zeros_like(h)
            for d in range(self.dim):
                mu, log_s = self._mu_log_s(params["blocks"][t], theta, x)
                value = mu[..., d] + h[..., d] * torch.exp(log_s[..., d])
                theta = _set_column(theta, d, value)
            h = torch.index_select(theta, -1, self.inv_perms[t])
        return h


def make_maf(dim: int, context_dim: int, hidden_features: int = 50,
             num_transforms: int = 5, n_layers: int = 2,
             clamp_log_scale: float = 5.0, *, device):
    """Conditional MAF with the JAX package's masks, permutations and
    layer sizes."""
    return _MAF(dim, context_dim, hidden_features, num_transforms, n_layers,
                clamp_log_scale, torch.device(device))
