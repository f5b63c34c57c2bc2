"""Online (sequential) SBI focused on one observation: TSNPE, SNLE, SNRE.

Counterpart of `synference_tpu/online.py`. Each round simulates θ draws
through `simulate_fn` on the device, appends them to the data of earlier
rounds and retrains from scratch on all of it.

- SNPE is truncated sequential NPE (Deistler et al. 2022): after the first
  round, θ is drawn uniformly from the prior restricted to the posterior's
  (1 − ε) highest-density region, which keeps the plain NPE loss valid.
  When that region's acceptance collapses, the rest of the round is prior
  draws: the algorithm's own fallback, kept as the JAX package has it.
- SNLE and SNRE losses are valid under any proposal, so after the first
  round θ comes from the current MCMC posterior itself.

Every round's θ, its simulations and the training draw from one
`torch.Generator` on the prior's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .flows.base import tree_map
from .posterior import DirectPosterior, LikelihoodPosterior, RatioPosterior
from .priors import BoxUniform
from .ratio import nre_loss
from .train import TrainConfig, train_ensemble, train_npe

__all__ = ["run_online_snpe", "run_online_snle", "run_online_snre"]


def _truncated_prior_sample(generator, prior: BoxUniform, posterior, x_obs,
                            n: int, epsilon: float = 1.0e-3,
                            max_tries: int = 200):
    """Uniform draws from the prior restricted to the posterior's (1 − ε)
    highest-density region: the log-prob threshold is the ε quantile over
    512 posterior draws, and prior draws are kept above it. Rounds that
    still lack draws after `max_tries` are filled with prior draws."""
    ref = posterior.sample(x_obs, 512, generator)
    with torch.no_grad():
        lp_ref = posterior.log_prob(ref, x_obs.expand(ref.shape[0], -1))
    lp_ref = lp_ref[torch.isfinite(lp_ref)]
    if lp_ref.numel() == 0:
        return prior.sample(generator, n)
    threshold = float(np.quantile(lp_ref.cpu().numpy(), epsilon))
    out = []
    count = 0
    for _ in range(max_tries):
        cand = prior.sample(generator, max(2 * n, 512))
        with torch.no_grad():
            lp = posterior.log_prob(cand, x_obs.expand(cand.shape[0], -1))
        out.append(cand[lp >= threshold])
        count += out[-1].shape[0]
        if count >= n:
            return torch.cat(out)[:n]
    return torch.cat(out + [prior.sample(generator, n - count)])


def _rounds(simulate_fn, prior: BoxUniform, x_obs, n_rounds: int,
            sims_per_round: int, generator, verbose: bool, propose,
            train_round):
    """The round loop: θ from the prior, then from `propose(posterior,
    generator)`; simulate; train on every round's finite rows with
    `train_round(θ, x, generator) -> (posterior, best validation loss)`."""
    all_theta, all_x, history = [], [], []
    posterior = None
    for rnd in range(n_rounds):
        theta = (prior.sample(generator, sims_per_round) if posterior is None
                 else propose(posterior, generator))
        with torch.no_grad():
            x = torch.as_tensor(simulate_fn(theta), dtype=torch.float32,
                                device=prior.device)
        all_theta.append(theta.cpu().numpy())
        all_x.append(x.cpu().numpy())
        theta_cat = np.concatenate(all_theta)
        x_cat = np.concatenate(all_x)
        good = (np.isfinite(x_cat).all(axis=1)
                & np.isfinite(theta_cat).all(axis=1))
        posterior, best_val = train_round(theta_cat[good], x_cat[good],
                                          generator)
        history.append({"round": rnd, "n_sims": int(good.sum()),
                        "best_val": best_val})
        if verbose:
            print(f"round {rnd}: n={good.sum()} val={best_val:.3f}",
                  flush=True)
    return posterior, {"theta": all_theta, "x": all_x}, history


def _generator(prior, generator):
    if generator is not None:
        return generator
    return torch.Generator(device=prior.device).manual_seed(0)


def run_online_snpe(simulate_fn, prior: BoxUniform, flow, x_obs,
                    n_rounds: int = 3, sims_per_round: int = 2000,
                    train_config: TrainConfig | None = None,
                    generator: torch.Generator | None = None,
                    verbose: bool = True):
    """Sequential NPE focused on `x_obs` (D,).

    `simulate_fn` maps θ (B, P) to features x (B, D), the feature transform
    included; `flow` is a `ConditionalFlow` q(θ|x), retrained from scratch
    each round. Returns (DirectPosterior, {"theta", "x"}: per-round numpy
    arrays, per-round history)."""
    cfg = train_config or TrainConfig()
    generator = _generator(prior, generator)
    x_obs = prior._tensor(x_obs)

    def propose(posterior, g):
        return _truncated_prior_sample(g, prior, posterior, x_obs,
                                       sims_per_round)

    def train_round(theta, x, g):
        res = train_npe(flow, theta, x, g, cfg)
        return (DirectPosterior(flow, res.params, prior),
                float(np.min(res.val_losses)))

    return _rounds(simulate_fn, prior, x_obs, n_rounds, sims_per_round,
                   generator, verbose, propose, train_round)


def run_online_snle(simulate_fn, prior: BoxUniform, flow, x_obs,
                    n_rounds: int = 3, sims_per_round: int = 2000,
                    train_config: TrainConfig | None = None,
                    generator: torch.Generator | None = None,
                    verbose: bool = True, n_walkers: int = 64,
                    mcmc_burn_in: int = 256):
    """Sequential NLE: the flow models q(x|θ) (built with θ-dim = the
    feature count and context-dim = the parameter count); the posterior
    ∝ q(x_obs|θ)·p(θ) is sampled by batched MCMC, also for the next round's
    proposals."""
    cfg = train_config or TrainConfig()
    generator = _generator(prior, generator)
    x_obs = prior._tensor(x_obs)

    def propose(posterior, g):
        return posterior.sample(x_obs, sims_per_round, g)

    def train_round(theta, x, g):
        res = train_npe(flow, x, theta, g, cfg)  # roles swap
        return (LikelihoodPosterior(flow, res.params, prior,
                                    n_walkers=n_walkers,
                                    burn_in=mcmc_burn_in),
                float(np.min(res.val_losses)))

    return _rounds(simulate_fn, prior, x_obs, n_rounds, sims_per_round,
                   generator, verbose, propose, train_round)


def run_online_snre(simulate_fn, prior: BoxUniform, estimator, x_obs,
                    n_rounds: int = 3, sims_per_round: int = 2000,
                    train_config: TrainConfig | None = None,
                    generator: torch.Generator | None = None,
                    verbose: bool = True, n_walkers: int = 64,
                    mcmc_burn_in: int = 256):
    """Sequential NRE: the classifier log-ratio is trained on joint against
    rolled-marginal pairs of every round's simulations; the posterior
    ∝ exp(logit)·p(θ) is sampled by batched MCMC."""
    cfg = train_config or TrainConfig()
    generator = _generator(prior, generator)
    x_obs = prior._tensor(x_obs)
    loss_fn = nre_loss(estimator)

    def propose(posterior, g):
        return posterior.sample(x_obs, sims_per_round, g)

    def train_round(theta, x, g):
        res = train_ensemble(estimator, theta, x, generator=g, config=cfg,
                             n_nets=1, loss_fn=loss_fn)
        return (RatioPosterior(estimator, tree_map(lambda a: a[0],
                                                   res.params), prior,
                               n_walkers=n_walkers, burn_in=mcmc_burn_in),
                float(np.min(res.val_losses)))

    return _rounds(simulate_fn, prior, x_obs, n_rounds, sims_per_round,
                   generator, verbose, propose, train_round)
