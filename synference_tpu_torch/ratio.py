"""Neural ratio estimation (NRE): a classifier logit as log r(θ, x).

Counterpart of `synference_tpu/ratio.py`. The estimator is an MLP ("mlp",
"resnet" with residual connections on same-width hidden layers, or "linear")
over the standardised [θ, x]; trained with the binary logistic loss on
joint against product-of-marginals pairs, its logit converges to
log p(x|θ)/p(x), so adding the prior's log-density gives the unnormalised
posterior that `RatioPosterior` samples by batched MCMC.

Parameters are `{"layers": [{"w", "b"}], "theta_mean", "theta_std",
"x_mean", "x_std"}` in the JAX package's layout; stacked parameters carry a
leading member axis on every leaf, and then `logit` returns (K, B), else
(B,). The marginal pairs roll θ by one place along the batch axis, the
second to last axis of a (K, B, P) minibatch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from .flows.base import tree_map

__all__ = ["RatioEstimator", "build_ratio_estimator", "nre_loss"]


@dataclass
class RatioEstimator:
    """MLP log-ratio estimator with input standardisation; `init`, `spec`
    and `from_spec` mirror `ConditionalFlow`, so `train_ensemble` trains it
    with `loss_fn=nre_loss(estimator)`."""

    theta_dim: int
    x_dim: int
    config: dict = field(default_factory=dict)
    device: object = field(kw_only=True)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.hidden_features = int(self.config.get("hidden_features", 64))
        self.num_layers = int(self.config.get("num_layers", 3))
        self.net = str(self.config.get("net", "mlp")).lower()
        if self.net not in ("mlp", "resnet", "linear"):
            raise ValueError(f"unknown NRE net {self.net!r}")
        if self.net == "linear":
            self.num_layers = 0

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def init(self, generator: torch.Generator, theta_data=None, x_data=None,
             n_members: int | None = None) -> dict:
        """He-initialised layers (no zero last layer) and standardisation
        statistics from the training data; `n_members=None` gives one
        member's parameters without the member axis."""
        k = 1 if n_members is None else int(n_members)
        dev = self.device

        def stats(data, dim):
            if data is None:
                mean, std = torch.zeros(dim), torch.ones(dim)
            else:
                data = self._tensor(data)
                mean = data.mean(0)
                std = torch.clamp(data.std(0, correction=0), min=1.0e-6)
            return (mean.to(dev).expand(k, dim).clone(),
                    std.to(dev).expand(k, dim).clone())

        tm, ts = stats(theta_data, self.theta_dim)
        xm, xs = stats(x_data, self.x_dim)
        sizes = ([self.theta_dim + self.x_dim]
                 + [self.hidden_features] * self.num_layers + [1])
        layers = []
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = math.sqrt(2.0 / a) * torch.randn(
                (k, b, a), generator=generator, device=dev)
            layers.append({"w": w, "b": torch.zeros((k, b), device=dev)})
        params = {"layers": layers, "theta_mean": tm, "theta_std": ts,
                  "x_mean": xm, "x_std": xs}
        return params if n_members is not None else tree_map(
            lambda a: a[0], params)

    def logit(self, params, theta, x):
        """log-ratio of θ (B, P) and x (B, C), shared by the members, or
        (K, B, ·) with one batch per member: (K, B) for stacked parameters,
        (B,) for one member's."""
        stacked = params["theta_mean"].ndim == 2
        if not stacked:
            params = tree_map(lambda a: a.unsqueeze(0), params)
        theta, x = self._tensor(theta), self._tensor(x)
        if theta.ndim < 3:
            theta = torch.atleast_2d(theta).unsqueeze(0)
        if x.ndim < 3:
            x = torch.atleast_2d(x).unsqueeze(0)
        z = ((theta - params["theta_mean"].unsqueeze(1))
             / params["theta_std"].unsqueeze(1))
        c = (x - params["x_mean"].unsqueeze(1)) / params["x_std"].unsqueeze(1)
        k = params["theta_mean"].shape[0]
        b = max(z.shape[1], c.shape[1])
        h = torch.cat([z.expand(k, b, -1), c.expand(k, b, -1)], dim=-1)
        layers = params["layers"]
        for i, layer in enumerate(layers):
            pre = h
            h = torch.baddbmm(layer["b"].unsqueeze(1), h,
                              layer["w"].transpose(1, 2))
            if i < len(layers) - 1:
                h = torch.relu(h)
                if self.net == "resnet" and pre.shape[-1] == h.shape[-1]:
                    h = h + pre
        out = h[..., 0]
        return out if stacked else out[0]

    log_prob = logit

    def spec(self) -> dict:
        return {"model": "nre", "theta_dim": self.theta_dim,
                "x_dim": self.x_dim,
                "config": {"hidden_features": self.hidden_features,
                           "num_layers": self.num_layers, "net": self.net}}

    @classmethod
    def from_spec(cls, spec: dict, device) -> "RatioEstimator":
        return cls(theta_dim=int(spec["theta_dim"]), x_dim=int(spec["x_dim"]),
                   config=dict(spec.get("config", {})), device=device)


def build_ratio_estimator(theta_dim: int, x_dim: int, *, device,
                          **config) -> RatioEstimator:
    return RatioEstimator(theta_dim=theta_dim, x_dim=x_dim, config=config,
                          device=device)


def nre_loss(estimator: RatioEstimator):
    """Binary logistic NRE loss over joint pairs and marginal pairs made by
    rolling θ one place along the batch:
    ½(mean softplus(−l(θᵢ, xᵢ)) + mean softplus(l(θᵢ₋₁, xᵢ))), (K,) for
    stacked parameters. Its optimum is the exact log density ratio (Hermans
    et al. 2020)."""

    def loss(params, tb, xb):
        tb = estimator._tensor(tb)
        l_joint = estimator.logit(params, tb, xb)
        l_marg = estimator.logit(params, torch.roll(tb, 1, dims=-2), xb)
        return 0.5 * (F.softplus(-l_joint).mean(dim=-1)
                      + F.softplus(l_marg).mean(dim=-1))

    return loss
