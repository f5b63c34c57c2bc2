"""Continuous normalizing flow (FFJORD-style), conditional.

Counterpart of `synference_tpu/flows/cnf.py` (`make_cnf`):
log p(θ|x) = log N(z(1)) + ∫₀¹ tr(∂f/∂h) dt with dh/dt = f(h, t, x), f a
tanh MLP of [h, x, sin/cos time features]. The integral is a fixed-step RK4
over [0, 1] and the trace is exact, not a Hutchinson estimate (which would
change the density): the D forward-mode products of the JAX package, here
carried in closed form through the tanh MLP as D tangent rows per point
(the Jacobian's columns, layer by layer), whose diagonal sums to the trace.
Training differentiates through it. Sampling integrates the negated,
time-reflected field from base normals. Every tensor carries a leading
member axis K.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .mlp import mlp_apply, mlp_init

__all__ = ["make_cnf"]

_LOG_2PI = math.log(2.0 * math.pi)


class _CNF:
    """Conditional CNF over (K, B, ·) tensors."""

    def __init__(self, dim, context_dim, hidden_features, n_layers,
                 num_steps, time_embed, device):
        self.dim, self.context_dim = int(dim), int(context_dim)
        self.hidden, self.n_layers = int(hidden_features), int(n_layers)
        self.num_steps, self.time_embed = int(num_steps), int(time_embed)
        self.freqs = torch.as_tensor(
            np.pi * 2.0 ** np.arange(self.time_embed // 2, dtype=np.float32)
            if self.time_embed > 0 else np.zeros(0, np.float32),
            dtype=torch.float32, device=device)
        self.t_feats = self.time_embed if self.time_embed > 0 else 1

    def init(self, generator: torch.Generator, n_members: int) -> dict:
        sizes = ([self.dim + self.context_dim + self.t_feats]
                 + [self.hidden] * self.n_layers + [self.dim])
        return {"layers": mlp_init(generator, sizes, n_members)}

    def _inputs(self, h, t: float, x):
        if self.time_embed > 0:
            ft = self.freqs * t
            e = torch.cat([torch.sin(ft), torch.cos(ft)])
        else:
            e = torch.full((1,), t, device=h.device)
        return torch.cat([h, x, e.expand(h.shape[:-1] + e.shape)], dim=-1)

    def field(self, params, h, t: float, x):
        """Velocity f(h, t, x): (K, B, D) -> (K, B, D)."""
        return mlp_apply(params["layers"], self._inputs(h, t, x),
                         activation=torch.tanh)

    def field_and_trace(self, params, h, t: float, x):
        """f and the exact tr(∂f/∂h) (K, B): the Jacobian columns (one
        tangent row per basis vector of h) go through every layer beside
        the values."""
        layers = params["layers"]
        a = self._inputs(h, t, x)
        # tangents of the first layer's output: its weights' first D columns
        tan = layers[0]["w"][..., :self.dim].transpose(1, 2).unsqueeze(1)
        for i, layer in enumerate(layers):
            w = layer["w"]
            a = torch.baddbmm(layer["b"].unsqueeze(1), a, w.transpose(1, 2))
            if i == 0:
                tan = tan.expand(-1, a.shape[1], -1, -1)  # (K, B, D, H)
            else:
                k, b, d, n_in = tan.shape
                tan = torch.bmm(tan.reshape(k, b * d, n_in),
                                w.transpose(1, 2)).reshape(k, b, d, -1)
            if i < len(layers) - 1:
                a = torch.tanh(a)
                tan = tan * (1.0 - a * a).unsqueeze(-2)
        return a, torch.diagonal(tan, dim1=-2, dim2=-1).sum(dim=-1)

    def _rk4(self, params, h0, x, reverse: bool):
        """Integrate (h, log-det) jointly with RK4 over the fixed grid; the
        reverse direction integrates g(h, t) = −f(h, 1 − t), without the
        trace (sampling needs none)."""
        dt = 1.0 / self.num_steps
        ts = (np.arange(self.num_steps, dtype=np.float32)
              * np.float32(dt)).tolist()

        def ft(h, t):
            if reverse:
                return -self.field(params, h, 1.0 - t, x), 0.0
            return self.field_and_trace(params, h, t, x)

        h, ld = h0, torch.zeros(h0.shape[:-1], device=h0.device)
        for t in ts:
            k1, tr1 = ft(h, t)
            k2, tr2 = ft(h + 0.5 * dt * k1, t + 0.5 * dt)
            k3, tr3 = ft(h + 0.5 * dt * k2, t + 0.5 * dt)
            k4, tr4 = ft(h + dt * k3, t + dt)
            h = h + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            ld = ld + (dt / 6.0) * (tr1 + 2 * tr2 + 2 * tr3 + tr4)
        return h, ld

    def forward(self, params, theta, x):
        return self._rk4(params, theta, x, reverse=False)

    def log_prob(self, params, theta, x):
        z, ld = self.forward(params, theta, x)
        return ld - 0.5 * (z * z).sum(dim=-1) - 0.5 * self.dim * _LOG_2PI

    def draw_base(self, generator, shape):
        return torch.randn(tuple(shape) + (self.dim,), generator=generator,
                           device=generator.device)

    def inverse(self, params, z, x):
        return self._rk4(params, z, x, reverse=True)[0]


def make_cnf(dim: int, context_dim: int, hidden_features: int = 64,
             n_layers: int = 3, num_steps: int = 16, time_embed: int = 4, *,
             device):
    """Conditional CNF with the JAX package's field, time features and
    fixed RK4 grid."""
    return _CNF(dim, context_dim, hidden_features, n_layers, num_steps,
                time_embed, torch.device(device))
