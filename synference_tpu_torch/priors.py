"""Priors: independent box-uniform over named parameters, and its
restriction to the region where simulations are valid.

Counterpart of `synference_tpu/priors.py` (`BoxUniform`, `RestrictedPrior`,
`priors_from_library`, `restricted_prior_from_simulations`). The bounds live
on an explicit device, and samples come from a `torch.Generator` on it.
`RestrictedPrior`'s validity classifier is `classifier.MLPClassifier` (the
JAX package's is sklearn's) on tensors of the prior's device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BoxUniform", "RestrictedPrior", "priors_from_library",
           "restricted_prior_from_simulations"]


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


class RestrictedPrior:
    """A base prior restricted to the region a classifier deems valid.

    `classifier.predict_proba(θ (N, P) tensor)` gives (N, 2) class
    probabilities; θ is valid where the second reaches `threshold`.
    `log_prob` keeps the base density on the valid region, unnormalised
    (−inf elsewhere), as sbi's restriction does."""

    def __init__(self, base: BoxUniform, classifier, threshold: float = 0.5):
        self.base = base
        self.classifier = classifier
        self.threshold = threshold
        self.names = base.names
        self.device = base.device

    @property
    def dim(self) -> int:
        return self.base.dim

    def _valid(self, theta):
        with torch.no_grad():
            proba = self.classifier.predict_proba(self.base._tensor(theta))
        return proba[:, 1] >= self.threshold

    def sample(self, generator: torch.Generator, n: int, max_tries: int = 50):
        """n valid draws: rounds of max(2n, 256) base draws, the valid ones
        kept; RuntimeError when `max_tries` rounds do not yield n."""
        out = torch.empty((0, self.dim), device=self.device)
        for _ in range(max_tries):
            cand = self.base.sample(generator, max(2 * n, 256))
            out = torch.cat([out, cand[self._valid(cand)]])
            if out.shape[0] >= n:
                return out[:n]
        raise RuntimeError("restricted prior acceptance too low")

    def log_prob(self, theta):
        return torch.where(self._valid(theta), self.base.log_prob(theta),
                           -torch.inf)

    def support_mask(self, theta):
        return self.base.support_mask(theta) & self._valid(theta)


class _Always:
    """The classifier of degenerate labels: every θ valid, or none."""

    def __init__(self, valid: bool):
        self.valid = valid

    def predict_proba(self, theta):
        p = torch.full((theta.shape[0],), float(self.valid),
                       device=theta.device)
        return torch.stack([1.0 - p, p], dim=1)


class _Standardised:
    """A classifier fitted on standardised θ."""

    def __init__(self, clf, mu, sd):
        self.clf, self.mu, self.sd = clf, mu, sd

    def predict_proba(self, theta):
        return self.clf.predict_proba((theta - self.mu) / self.sd)


def restricted_prior_from_simulations(base: BoxUniform, theta, x,
                                      threshold: float = 0.5,
                                      generator: torch.Generator | None = None
                                      ) -> RestrictedPrior:
    """Fit the validity classifier from simulations: θ is invalid when its
    simulation x has a non-finite value. With all labels equal the prior
    accepts everything or nothing. The classifier (`MLPClassifier`, 64
    hidden units, sklearn's defaults) trains on θ standardised by its mean
    and (population) standard deviation, on the base prior's device; its
    draws come from `generator` (seed 0 there when None)."""
    from .classifier import MLPClassifier

    dev = base.device
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    x = torch.as_tensor(x, device=dev)
    valid = torch.isfinite(x).all(dim=1)
    n_valid = int(valid.sum())
    if n_valid in (0, valid.shape[0]):
        return RestrictedPrior(base, _Always(n_valid > 0), threshold)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    mu = theta.mean(dim=0)
    sd = torch.clamp(theta.std(dim=0, correction=0), min=1e-8)
    clf = MLPClassifier(hidden=64, max_iter=300).fit(
        (theta - mu) / sd, valid.to(torch.float32), generator)
    return RestrictedPrior(base, _Standardised(clf, mu, sd), threshold)


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
