"""Batched affine-invariant ensemble MCMC and its convergence diagnostics.

Counterpart of `synference_tpu/mcmc.py`'s `run_batched_mcmc` and
`split_rhat_ess`: the sampler of the NLE and NRE posteriors. Every object's
walker ensemble advances in lockstep (Goodman & Weare stretch moves, two
half-ensembles per step), so each step's log-density is one (M·W, ·) batched
call. The step loop reads nothing back to the host: acceptance stays a
device tensor until the caller reads it, and only the steps that survive
`burn_in::thin` are kept. On a CUDA device the loop runs under
`torch.cuda.set_sync_debug_mode("error")`, as the trainer's epochs do, so a
`loglike_fn` that waits for the card raises there.

Randomness comes from a `torch.Generator` on the device, or every draw is
passed in (`draws=`): the initial walkers, the stretch uniforms, the partner
indices and the accept uniforms, so that a test can replay the JAX package's
key splits. The gradient fitters of the JAX module (`run_ensemble_mcmc`,
`run_smc`, HMC/MAP/VI) are not ported (ROADMAP M13-rest).
"""

from __future__ import annotations

import torch

from .train import _no_host_sync

__all__ = ["run_batched_mcmc", "split_rhat_ess"]


def split_rhat_ess(chain):
    """Split-R̂ and ESS of per-walker chains (T, M, W, P): (rhat (M, P),
    ess (M, P)) on the chain's device, NaN when T < 4.

    Split-R̂ treats the walkers as chains and halves each in time; ESS
    follows the emcee convention: the walker-averaged autocorrelation (FFT
    of length the next power of two above 2T − 1), Geyer's initial positive
    pair truncation, ess = W·T/τ."""
    chain = torch.as_tensor(chain)
    t, m, w, p = chain.shape
    if t < 4:
        nan = torch.full((m, p), float("nan"), device=chain.device)
        return nan, nan
    t2 = (t // 2) * 2
    c = chain[:t2].to(torch.float32)

    n = t2 // 2
    halves = torch.cat([c[:n], c[n:t2]], dim=2)  # (n, M, 2W, P)
    mean_c = halves.mean(dim=0)
    w_var = halves.var(dim=0, correction=1).mean(dim=1)  # (M, P)
    b_var = n * mean_c.var(dim=1, correction=1)
    var_hat = (n - 1) / n * w_var + b_var / n
    rhat = torch.sqrt(var_hat / torch.clamp(w_var, min=1.0e-30))

    x = c - c.mean(dim=0)
    nfft = 1 << (2 * t2 - 1).bit_length()
    f = torch.fft.rfft(x, n=nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:t2] / t2
    denom = torch.clamp(acov[0].mean(dim=1), min=1.0e-30)  # (M, P)
    rho = acov.mean(dim=2) / denom  # (t2, M, P)
    n_pairs = t2 // 2
    gamma = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    pos = torch.cumprod((gamma > 0.0).to(torch.float32), dim=0)
    tau = torch.clamp(2.0 * (gamma * pos).sum(dim=0) - 1.0, min=1.0)
    return rhat, w * t2 / tau


def run_batched_mcmc(loglike_fn, prior, xs,
                     generator: torch.Generator | None = None,
                     n_walkers: int = 64, n_steps: int = 600,
                     burn_in: int = 300, thin: int = 2,
                     stretch_a: float = 2.0,
                     return_diagnostics: bool = False, init_theta=None,
                     draws: dict | None = None):
    """Stretch-move MCMC for M conditions at once.

    Args:
        loglike_fn: (θ (B, P), x (B, C)) -> (B,) log-likelihood (or any
            unnormalised log-density term added to the prior's), on tensors
            of the prior's device.
        prior: `BoxUniform`.
        xs: (M, C) conditions.
        generator: source of every draw, on the prior's device (seed 0 when
            None and no `draws`).
        init_theta: optional (M, n_walkers, P) walker start, clipped just
            inside the box (1e-4 of its width).
        draws: optional replacement of the generator's draws, a dict of
            "walkers" (M, W, P), "stretch" and "accept" uniforms
            (n_steps, 2, M, W/2) and "partner" indices (n_steps, 2, M, W/2)
            in [0, W/2), the second axis the two half-steps.
        return_diagnostics: also return {"rhat", "ess"} (M, P) tensors of
            `split_rhat_ess` over the kept steps.
    Returns:
        samples (M, n_kept·W, P), in kept step then walker order, the mean
        acceptance as a 0-d device tensor [, diagnostics].
    """
    dev = prior.device
    xs = torch.atleast_2d(torch.as_tensor(xs, dtype=torch.float32,
                                          device=dev))
    m, dim = xs.shape[0], prior.dim
    if n_walkers % 2:
        n_walkers += 1
    half = n_walkers // 2
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def full_lp(theta):
        """θ (M, W', P) -> (M, W') log prior + log-likelihood."""
        w_ = theta.shape[1]
        lp = prior.log_prob(theta)
        ok = torch.isfinite(lp)
        ll = loglike_fn(theta.reshape(m * w_, dim),
                        xs.unsqueeze(1).expand(m, w_, -1).reshape(m * w_, -1)
                        ).reshape(m, w_)
        return torch.where(ok, torch.where(ok, ll, 0.0) + lp, -torch.inf)

    if draws is not None:
        draws = {k: torch.as_tensor(v, device=dev) for k, v in draws.items()}
        walkers = draws["walkers"].to(torch.float32)
    elif init_theta is None:
        walkers = prior.sample(generator, m * n_walkers).reshape(
            m, n_walkers, dim)
    else:
        walkers = torch.as_tensor(init_theta, dtype=torch.float32, device=dev)
        if walkers.shape != (m, n_walkers, dim):
            raise ValueError(f"init_theta must be ({m}, {n_walkers}, {dim}), "
                             f"got {tuple(walkers.shape)}")
        pad = 1.0e-4 * (prior.high - prior.low)
        walkers = torch.clamp(walkers, prior.low + pad, prior.high - pad)
    lp = full_lp(walkers)

    def step_draws(s: int, j: int):
        if draws is not None:
            return (draws["stretch"][s, j], draws["partner"][s, j],
                    draws["accept"][s, j])
        return (torch.rand((m, half), generator=generator, device=dev),
                torch.randint(0, half, (m, half), generator=generator,
                              device=dev),
                torch.rand((m, half), generator=generator, device=dev))

    def half_step(walkers, lp, s: int, j: int):
        """Move one half of every ensemble against the other (j = 0: the
        first half moves)."""
        mov = slice(0, half) if j == 0 else slice(half, n_walkers)
        fix = slice(half, n_walkers) if j == 0 else slice(0, half)
        movers, fixed, lp_m = walkers[:, mov], walkers[:, fix], lp[:, mov]
        u, partner, u_acc = step_draws(s, j)
        z = ((stretch_a - 1.0) * u + 1.0) ** 2 / stretch_a
        anchor = torch.gather(fixed, 1, partner.to(torch.int64).unsqueeze(
            -1).expand(-1, -1, dim))
        proposal = anchor + z.unsqueeze(-1) * (movers - anchor)
        lp_p = full_lp(proposal)
        accept = torch.log(u_acc) < (dim - 1) * torch.log(z) + lp_p - lp_m
        new = torch.where(accept.unsqueeze(-1), proposal, movers)
        lp_new = torch.where(accept, lp_p, lp_m)
        if j == 0:
            return (torch.cat([new, fixed], dim=1),
                    torch.cat([lp_new, lp[:, fix]], dim=1), accept)
        return (torch.cat([fixed, new], dim=1),
                torch.cat([lp[:, fix], lp_new], dim=1), accept)

    kept, acc_sum = [], torch.zeros((), device=dev)
    with _no_host_sync(dev):
        for s in range(n_steps):
            for j in range(2):
                walkers, lp, accept = half_step(walkers, lp, s, j)
                acc_sum = acc_sum + 0.5 * accept.to(torch.float32).mean()
            if s >= burn_in and (s - burn_in) % thin == 0:
                kept.append(walkers)
    acc = acc_sum / n_steps
    chain = (torch.stack(kept) if kept
             else walkers.new_zeros((0, m, n_walkers, dim)))
    samples = chain.transpose(0, 1).reshape(m, -1, dim)
    if return_diagnostics:
        rhat, ess = split_rhat_ess(chain)
        return samples, acc, {"rhat": rhat, "ess": ess}
    return samples, acc
