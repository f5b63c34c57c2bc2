"""Amortised posteriors: direct flow posteriors truncated to the prior box,
ensembles, and batched sampling.

Counterpart of `synference_tpu/posterior.py` (`DirectPosterior`,
`EnsemblePosterior`). The members of an ensemble are batched weights, so one
pass draws for every member and every object. Each sampling function takes a
`torch.Generator` on the flow's device or the base normals themselves
(`base=`), so that two runs, or two packages, can share their draws.

The NLE and NRE posteriors (`LikelihoodPosterior`, `RatioPosterior`) add the
prior's log-density to a likelihood or ratio term and sample it with the
batched ensemble MCMC (`mcmc.run_batched_mcmc`), every object at once.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from .flows.base import ConditionalFlow, tree_leaves, tree_map
from .mcmc import run_batched_mcmc
from .priors import BoxUniform

__all__ = ["DirectPosterior", "EnsemblePosterior", "LikelihoodPosterior",
           "RatioPosterior"]


def _draw_members(flow, stacked_params, prior, xs, n: int, rounds: int,
                  generator, base):
    """`rounds`·n raw flow draws per member and object, of which the first n
    are kept with the in-support ones first (in their drawn order), clipped
    to the box. Returns draws (K, M, n, D) and the in-support fraction of the
    raw draws (K, M). `base` is (K, M, rounds·n, D)."""
    draws = flow.sample_batch(stacked_params, xs, rounds * n, generator, base)
    valid = prior.support_mask(draws)
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    picked = torch.gather(
        draws, 2, order[..., :n, None].expand(-1, -1, -1, draws.shape[-1]))
    return (torch.clamp(picked, prior.low, prior.high),
            valid.to(torch.float32).mean(dim=-1))


class DirectPosterior:
    """q(θ|x) truncated to the prior support.

    `params` are one member's parameters (no member axis). `log_prob` gives
    the unnormalised truncated density by default; `normalize=True`
    estimates the leakage correction by Monte Carlo."""

    def __init__(self, flow: ConditionalFlow, params, prior: BoxUniform):
        self.flow = flow
        self.params = params
        self.prior = prior

    @property
    def _stacked(self):
        return tree_map(lambda a: a.unsqueeze(0), self.params)

    # -- density ---------------------------------------------------------
    def log_prob(self, theta, x, normalize: bool = False,
                 generator: torch.Generator | None = None, n_norm: int = 512):
        theta = torch.atleast_2d(self.flow._tensor(theta))
        x = torch.atleast_2d(self.flow._tensor(x))
        lp = self.flow.log_prob(self.params, theta, x)
        lp = torch.where(self.prior.support_mask(theta), lp, -torch.inf)
        if normalize:
            accept = self._acceptance(x, n_norm, generator)  # (B,)
            lp = lp - torch.log(torch.clamp(accept, min=1.0e-6))
        return lp

    def _acceptance(self, x, n: int, generator=None, base=None):
        """Monte-Carlo in-support fraction of the raw flow per condition."""
        s = self.flow.sample_batch(self.params, x, n, generator, base)
        return self.prior.support_mask(s).to(torch.float32).mean(dim=-1)

    # -- sampling --------------------------------------------------------
    def sample(self, x, n: int, generator: torch.Generator,
               max_tries: int = 20, oversample: float = 2.0):
        """n in-support draws for a single condition x (C,): rounds of
        `round_n` draws until n are valid; what is still missing after
        `max_tries` rounds is clipped into the box."""
        round_n = int(max(n * oversample, 256))
        out = torch.empty((0, self.prior.dim), device=self.flow.device)
        for _ in range(max_tries):
            s = self.flow.sample(self.params, x, round_n, generator)
            out = torch.cat([out, s[self.prior.support_mask(s)]])[:10 * n]
            if out.shape[0] >= n:
                return out[:n]
        s = self.flow.sample(self.params, x, n - out.shape[0], generator)
        return torch.cat(
            [out, torch.clamp(s, self.prior.low, self.prior.high)])[:n]

    def sample_batch(self, xs, n: int,
                     generator: torch.Generator | None = None,
                     batched_rounds: int = 4, base=None):
        """(M, C) conditions -> (M, n, D) in one pass; leakage outside the
        box is clipped silently (see `sample_batch_with_acceptance`)."""
        return self.sample_batch_with_acceptance(
            xs, n, generator, batched_rounds, base)[0]

    def sample_batch_with_acceptance(self, xs, n: int,
                                     generator: torch.Generator | None = None,
                                     batched_rounds: int = 4, base=None):
        """Like `sample_batch`, and the per-object in-support fraction (M,)
        of the raw flow draws. Values well below 1 mean that the flow leaks
        outside the prior box and returned samples were clipped onto its
        faces. `base` is (M, batched_rounds·n, D)."""
        if base is not None:
            base = self.flow._tensor(base).unsqueeze(0)
        s, acc = _draw_members(self.flow, self._stacked, self.prior, xs, n,
                               batched_rounds, generator, base)
        return s[0], acc[0]

    def map_estimate(self, x, generator: torch.Generator,
                     n_starts: int = 512):
        """The highest-density one of `n_starts` posterior draws."""
        s = self.sample(x, n_starts, generator)
        x = self.flow._tensor(x).reshape(1, -1).expand(n_starts, -1)
        return s[torch.argmax(self.log_prob(s, x))]


class EnsemblePosterior:
    """Uniform mixture of member posteriors; `stacked_params` carry a
    leading member axis (as `train_ensemble` returns them), whose length
    is the number of members."""

    def __init__(self, flow: ConditionalFlow, stacked_params,
                 prior: BoxUniform):
        self.flow = flow
        self.params = stacked_params
        self.prior = prior
        self.n_members = int(tree_leaves(stacked_params)[0].shape[0])

    def _member(self, i: int) -> DirectPosterior:
        return DirectPosterior(
            self.flow, tree_map(lambda a: a[i], self.params), self.prior)

    def log_prob(self, theta, x):
        theta = torch.atleast_2d(self.flow._tensor(theta))
        x = torch.atleast_2d(self.flow._tensor(x))
        lps = self.flow.log_prob(self.params, theta, x)  # (K, B)
        lp = torch.logsumexp(lps, dim=0) - math.log(self.n_members)
        return torch.where(self.prior.support_mask(theta), lp, -torch.inf)

    def sample(self, x, n: int, generator: torch.Generator, **kw):
        """n in-support draws for one condition: each draw picks a member
        uniformly; the result is shuffled."""
        dev = self.flow.device
        choice = torch.randint(0, self.n_members, (n,), generator=generator,
                               device=dev)
        counts = np.bincount(choice.cpu().numpy(), minlength=self.n_members)
        out = torch.cat([self._member(i).sample(x, int(c), generator, **kw)
                         for i, c in enumerate(counts) if c > 0])
        return out[torch.randperm(n, generator=generator, device=dev)]

    def sample_batch(self, xs, n: int,
                     generator: torch.Generator | None = None,
                     batched_rounds: int = 4, base=None):
        """(M, C) -> (M, n, D): every member draws per = ceil(n/K) samples
        in one pass, then the member axis is folded into the sample axis."""
        return self.sample_batch_with_acceptance(
            xs, n, generator, batched_rounds, base)[0]

    def sample_batch_with_acceptance(self, xs, n: int,
                                     generator: torch.Generator | None = None,
                                     batched_rounds: int = 4, base=None):
        """Like `sample_batch`, and the per-object in-support fraction of
        the raw draws averaged over members (M,). `base` is
        (K, M, batched_rounds·per, D)."""
        per = -(-n // self.n_members)
        s, acc = _draw_members(self.flow, self.params, self.prior, xs, per,
                               batched_rounds, generator, base)
        # interleave per-major, so that truncation to n drops at most one
        # sample per member
        s = s.permute(1, 2, 0, 3).reshape(s.shape[1], -1, s.shape[-1])
        return s[:, :n], acc.mean(dim=0)


class _MCMCPosterior:
    """An unnormalised log-density term (`_loglike(θ (B, P), x (B, C)) ->
    (B,)`) plus the prior, sampled by the batched stretch-move MCMC.

    `last_acceptance` (a float) and `last_diagnostics` ({"rhat", "ess"}
    numpy (M, P) arrays) describe the latest `sample_batch`; a chain set
    whose largest split-R̂ exceeds `rhat_warn` logs a warning on the
    "synference_tpu_torch.mcmc" logger, since its quantiles cannot be
    trusted."""

    def __init__(self, prior: BoxUniform, n_walkers: int = 64,
                 burn_in: int = 256, thin: int = 2, rhat_warn: float = 1.1):
        self.prior = prior
        self.n_walkers = n_walkers + (n_walkers % 2)
        self.burn_in = burn_in
        self.thin = thin
        self.rhat_warn = float(rhat_warn)
        self.last_acceptance: float | None = None
        self.last_diagnostics: dict | None = None

    @property
    def n_members(self) -> int:
        """The leading axis of stacked parameters; 1 for one member's."""
        mean = self.params["theta_mean"]
        return int(mean.shape[0]) if mean.ndim == 2 else 1

    def _ensemble(self, values):
        """(K, B) member values -> their mixture logsumexp − log K; (B,)
        values pass through."""
        if values.ndim == 1:
            return values
        return torch.logsumexp(values, dim=0) - math.log(values.shape[0])

    def log_prob(self, theta, x):
        """Unnormalised log posterior (log-likelihood or ratio + log prior),
        −inf outside the prior's support; not comparable across x."""
        theta = self.prior._tensor(theta)
        x = self.prior._tensor(x)
        lp = self.prior.log_prob(theta)
        ok = torch.isfinite(lp)
        ll = torch.where(ok, self._loglike(theta, x), 0.0)
        return torch.where(ok, ll + lp, -torch.inf)

    def sample_batch(self, xs, n: int,
                     generator: torch.Generator | None = None, draws=None):
        """(M, C) -> (M, n, D): the freshest n post-burn-in states per
        object of a chain of burn_in + ceil(n / walkers)·thin steps. The
        draws come from `generator` (seed 0 on the prior's device when
        None) or `draws` (see `run_batched_mcmc`)."""
        keep_steps = -(-n // self.n_walkers)
        kept, acc, diag = run_batched_mcmc(
            self._loglike, self.prior, xs, generator,
            n_walkers=self.n_walkers,
            n_steps=self.burn_in + keep_steps * self.thin,
            burn_in=self.burn_in, thin=self.thin, return_diagnostics=True,
            draws=draws)
        self.last_acceptance = float(acc)
        rhat, ess = diag["rhat"].cpu().numpy(), diag["ess"].cpu().numpy()
        self.last_diagnostics = {"rhat": rhat, "ess": ess}
        finite = np.isfinite(rhat)
        rhat_max = float(rhat[finite].max()) if finite.any() else float("nan")
        if np.isfinite(rhat_max) and rhat_max > self.rhat_warn:
            per_obj = np.where(finite, rhat, -np.inf).max(axis=1)
            logging.getLogger("synference_tpu_torch.mcmc").warning(
                "batched MCMC: %d/%d objects have split-R-hat > %.2f "
                "(max %.3f); their posterior quantiles are unreliable; "
                "raise burn_in/n_steps", int((per_obj > self.rhat_warn).sum()),
                kept.shape[0], self.rhat_warn, rhat_max)
        return kept[:, -n:]

    def sample(self, x, n: int, generator: torch.Generator | None = None,
               **kw):
        x = self.prior._tensor(x).reshape(1, -1)
        return self.sample_batch(x, n, generator, **kw)[0]


class LikelihoodPosterior(_MCMCPosterior):
    """NLE posterior: the flow likelihood q(x|θ) times the prior, sampled
    by MCMC. The flow was trained with the roles swapped: its "θ" slot holds
    the features and its context θ. Stacked `params` (a leading member axis)
    make the likelihood the uniform mixture of the members'."""

    def __init__(self, flow: ConditionalFlow, params, prior: BoxUniform,
                 **mcmc_kw):
        super().__init__(prior, **mcmc_kw)
        self.flow = flow
        self.params = params

    def _loglike(self, theta, x):
        return self._ensemble(self.flow.log_prob(self.params, x, theta))


class RatioPosterior(_MCMCPosterior):
    """NRE posterior: the classifier logit log r(θ, x) plus the log prior,
    sampled by MCMC; the members of stacked `params` are averaged in ratio
    space (logsumexp of the logits − log K)."""

    def __init__(self, estimator, params, prior: BoxUniform, **mcmc_kw):
        super().__init__(prior, **mcmc_kw)
        self.estimator = estimator
        self.params = params

    def _loglike(self, theta, x):
        return self._ensemble(self.estimator.logit(self.params, theta, x))
