"""Priors: independent box-uniform over named parameters.

Counterpart of `synference_tpu/priors.py` (`BoxUniform`,
`priors_from_library`). The bounds live on an explicit device, and samples
come from a `torch.Generator` on it. `RestrictedPrior` waits for ROADMAP M12.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BoxUniform", "priors_from_library"]


class BoxUniform:
    """Independent uniform over [low, high]^D (closed bounds)."""

    def __init__(self, low, high, names: tuple = (), *, device):
        self.device = torch.device(device)
        self.low = torch.as_tensor(np.asarray(low, np.float32),
                                   device=self.device)
        self.high = torch.as_tensor(np.asarray(high, np.float32),
                                    device=self.device)
        if not bool((self.high > self.low).all()):
            raise ValueError("prior requires high > low in every dimension")
        self.names = tuple(names)
        self._log_vol = float(torch.log(self.high - self.low).sum())

    @property
    def dim(self) -> int:
        return int(self.low.shape[0])

    def _tensor(self, theta):
        return torch.atleast_2d(torch.as_tensor(
            theta, dtype=torch.float32, device=self.device))

    def sample(self, generator: torch.Generator, n: int):
        u = torch.rand((int(n), self.dim), generator=generator,
                       device=self.device)
        return self.low + u * (self.high - self.low)

    def log_prob(self, theta):
        inside = self.support_mask(theta)
        return torch.where(inside, -self._log_vol, -torch.inf)

    def support_mask(self, theta):
        theta = self._tensor(theta)
        return ((theta >= self.low) & (theta <= self.high)).all(dim=-1)

    def to_dict(self) -> dict:
        return {"low": self.low.cpu().numpy().tolist(),
                "high": self.high.cpu().numpy().tolist(),
                "names": list(self.names)}

    @classmethod
    def from_dict(cls, d: dict, device) -> "BoxUniform":
        return cls(d["low"], d["high"], tuple(d.get("names", ())),
                   device=device)


def priors_from_library(parameters: np.ndarray, parameter_names,
                        overrides: dict | None = None,
                        extend_pct: float = 0.0,
                        positive_params: tuple = (), *, device) -> BoxUniform:
    """Box prior from library parameter min/max.

    Args:
        parameters: (P, N) or (N, P) library θ array.
        overrides: {name: (lo, hi)} explicit ranges.
        extend_pct: extend each range by this fraction of its width on both
            sides.
        positive_params: names whose extended lower bound is clamped at 0.
    """
    parameters = np.asarray(parameters)
    names = list(parameter_names)
    if parameters.shape[0] != len(names):
        parameters = parameters.T
    overrides = overrides or {}
    low, high = [], []
    for i, name in enumerate(names):
        if name in overrides:
            lo, hi = overrides[name]
        else:
            lo, hi = float(parameters[i].min()), float(parameters[i].max())
            if extend_pct > 0:
                width = hi - lo
                lo -= extend_pct * width
                hi += extend_pct * width
                if name in positive_params:
                    lo = max(lo, 0.0)
        low.append(lo)
        high.append(hi)
    return BoxUniform(low, high, tuple(names), device=device)
