"""Likelihood-based fitting on the device: ensemble MCMC, SMC evidences and
the gradient fitters (HMC, MAP + Laplace, VI) through the simulator.

Counterpart of `synference_tpu/mcmc.py`. Every object's chains advance in
lockstep, so each step's log-density is one batched call:

- `run_batched_mcmc` / `run_ensemble_mcmc`: Goodman & Weare stretch moves,
  two half-ensembles per step, on one half-step code; the samplers of the
  NLE and NRE posteriors and of `fit_observation_mcmc`.
- `run_smc` / `model_comparison`: tempered SMC with red-black stretch moves
  on the device; the adaptive β bisection on the ESS and the systematic
  resampling run on the host once per stage, as in the JAX package.
- `fit_catalogue_hmc` (and its one-object wrappers), `fit_catalogue_map`,
  `fit_catalogue_vi`: gradient fitters in the prior box's logit space
  through `simulator.photometry`. They set the simulator's `_mega_off` for
  the call (restored in `finally`), so the photometry takes the plain,
  differentiable route; the kernels have no gradient.

Step loops read nothing back to the host: acceptances stay device tensors
until the caller reads them, and only the steps that are kept are stored.
On a CUDA device the loops run under `torch.cuda.set_sync_debug_mode("error")`,
as the trainer's epochs do, so a log-density that waits for the card raises
there. Randomness comes from a `torch.Generator` on the device, or every
draw is passed in (`draws=`), so that a test can replay the JAX package's
key splits.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .train import _no_host_sync, _optimizer_step

__all__ = [
    "run_ensemble_mcmc",
    "run_batched_mcmc",
    "split_rhat_ess",
    "run_smc",
    "model_comparison",
    "gaussian_loglike",
    "censored_gaussian_loglike_rows",
    "dirichlet_cumsum_transform",
    "fit_observation_mcmc",
    "fit_observation_hmc",
    "fit_catalogue_hmc",
    "fit_catalogue_map",
    "fit_catalogue_vi",
]


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def gaussian_loglike(sim_fn, x_obs, sigma, upper_limits=None, *, device):
    """Batched Gaussian χ² log-likelihood through a forward model:
    θ (B, P) -> (B,), with `sim_fn` θ -> model x (B, D) on `device`.

    x_obs and sigma are (D,); `upper_limits` an optional (D,) bool mask of
    bands treated as non-detections at limiting flux x_obs (the censored
    term of `censored_gaussian_loglike_rows`)."""
    x_obs = _f32(x_obs, device)
    sigma = torch.clamp(_f32(sigma, device), min=1.0e-12)
    lim = (None if upper_limits is None
           else torch.as_tensor(upper_limits, dtype=torch.bool,
                                device=device))

    def loglike(theta):
        return censored_gaussian_loglike_rows(sim_fn(theta), x_obs, sigma, lim)

    return loglike


def censored_gaussian_loglike_rows(model, x_obs, sigma, upper_limits=None):
    """(B, F) model against observed -> (B,) log-likelihood. Bands flagged
    in `upper_limits` carry only "flux below the limit",
    L = Φ((x_lim − model)/σ), as `log_ndtr`: finite and differentiable
    however far the model overshoots the limit."""
    resid = (model - x_obs) / sigma
    gauss = -0.5 * resid ** 2
    if upper_limits is None:
        return gauss.sum(dim=-1)
    cens = torch.special.log_ndtr(-resid)
    return torch.where(upper_limits, cens, gauss).sum(dim=-1)


def dirichlet_cumsum_transform(u):
    """Unit cube -> Dirichlet simplex by the order statistics of N−1
    uniforms: u (..., N−1) -> fractions (..., N)."""
    u = torch.as_tensor(u)
    sorted_u = torch.sort(u, dim=-1).values
    zeros = torch.zeros(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device)
    edges = torch.cat([zeros, sorted_u, zeros + 1.0], dim=-1)
    return torch.diff(edges, dim=-1)


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


def _stretch_chain(full_lp, walkers, n_steps: int, burn_in: int, thin: int,
                   stretch_a: float, step_draws):
    """The stretch-move loop shared by the ensemble samplers.

    `full_lp` maps walkers (M, W', P) to (M, W') log-densities;
    `step_draws(s, j)` gives step s, half j's stretch uniforms, partner
    indices and accept uniforms, each (M, W/2). Returns the kept walkers
    (T, M, W, P) and log-densities (T, M, W) of steps burn_in::thin, and the
    mean acceptance as a 0-d device tensor. Reads nothing back to the host.
    """
    m, n_walkers, dim = walkers.shape
    half = n_walkers // 2
    lp = full_lp(walkers)

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

    kept, kept_lp = [], []
    acc_sum = torch.zeros((), device=walkers.device)
    with _no_host_sync(walkers.device):
        for s in range(n_steps):
            for j in range(2):
                walkers, lp, accept = half_step(walkers, lp, s, j)
                acc_sum = acc_sum + 0.5 * accept.to(torch.float32).mean()
            if s >= burn_in and (s - burn_in) % thin == 0:
                kept.append(walkers)
                kept_lp.append(lp)
    chain = (torch.stack(kept) if kept
             else walkers.new_zeros((0, m, n_walkers, dim)))
    chain_lp = torch.stack(kept_lp) if kept_lp else lp.new_zeros((0, m, n_walkers))
    return chain, chain_lp, acc_sum / max(n_steps, 1)


def _stretch_draws(draws, generator, m: int, half: int, dev):
    """`step_draws` of `_stretch_chain`: from `draws` ("stretch", "partner",
    "accept" of shape (n_steps, 2, M, W/2)) or from the generator."""
    def step_draws(s: int, j: int):
        if draws is not None:
            return (draws["stretch"][s, j], draws["partner"][s, j],
                    draws["accept"][s, j])
        return (torch.rand((m, half), generator=generator, device=dev),
                torch.randint(0, half, (m, half), generator=generator,
                              device=dev),
                torch.rand((m, half), generator=generator, device=dev))

    return step_draws


def _draws_on(draws, dev):
    return (None if draws is None
            else {k: torch.as_tensor(v, device=dev) for k, v in draws.items()})


def run_ensemble_mcmc(log_prob_fn, prior, generator: torch.Generator | None = None,
                      n_walkers: int = 64, n_steps: int = 1000,
                      burn_in: int = 300, thin: int = 2,
                      stretch_a: float = 2.0, draws: dict | None = None):
    """Stretch-move ensemble sampler of one target.

    Args:
        log_prob_fn: θ (B, P) -> (B,) log-likelihood on the prior's device;
            the support of the prior box is applied here (−inf outside).
        prior: `BoxUniform`.
        generator: source of every draw on the prior's device (seed 0 when
            None and no `draws`).
        draws: optional replacement of the generator's draws: "walkers"
            (W, P), "stretch" and "accept" uniforms (n_steps, 2, W/2) and
            "partner" indices (n_steps, 2, W/2) in [0, W/2), the second
            axis the two half-steps.
    Returns:
        samples (n_kept·W, P) in kept step then walker order, their
        log-probabilities (n_kept·W,) (the log-likelihood inside the box),
        and the mean acceptance as a 0-d device tensor.
    """
    dev = prior.device
    dim = prior.dim
    if n_walkers % 2:
        n_walkers += 1
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    draws = _draws_on(draws, dev)

    def full_lp(theta):  # (1, W', P) -> (1, W')
        lp = prior.log_prob(theta[0])
        ok = torch.isfinite(lp)
        ll = torch.where(ok, log_prob_fn(theta[0]), 0.0)
        return torch.where(ok, ll, -torch.inf)[None]

    if draws is not None:
        walkers = draws["walkers"].to(torch.float32)
        draws = {k: v[:, :, None] for k, v in draws.items() if k != "walkers"}
    else:
        walkers = prior.sample(generator, n_walkers)
    chain, chain_lp, acc = _stretch_chain(
        full_lp, walkers[None], n_steps, burn_in, thin, stretch_a,
        _stretch_draws(draws, generator, 1, n_walkers // 2, dev))
    return chain.reshape(-1, dim), chain_lp.reshape(-1), acc


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
    xs = torch.atleast_2d(_f32(xs, dev))
    m, dim = xs.shape[0], prior.dim
    if n_walkers % 2:
        n_walkers += 1
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

    draws = _draws_on(draws, dev)
    if draws is not None:
        walkers = draws["walkers"].to(torch.float32)
    elif init_theta is None:
        walkers = prior.sample(generator, m * n_walkers).reshape(
            m, n_walkers, dim)
    else:
        walkers = _f32(init_theta, dev)
        if walkers.shape != (m, n_walkers, dim):
            raise ValueError(f"init_theta must be ({m}, {n_walkers}, {dim}), "
                             f"got {tuple(walkers.shape)}")
        pad = 1.0e-4 * (prior.high - prior.low)
        walkers = torch.clamp(walkers, prior.low + pad, prior.high - pad)
    chain, _, acc = _stretch_chain(
        full_lp, walkers, n_steps, burn_in, thin, stretch_a,
        _stretch_draws(draws, generator, m, n_walkers // 2, dev))
    samples = chain.transpose(0, 1).reshape(m, -1, dim)
    if return_diagnostics:
        rhat, ess = split_rhat_ess(chain)
        return samples, acc, {"rhat": rhat, "ess": ess}
    return samples, acc


def run_smc(loglike_fn, prior, generator: torch.Generator | None = None,
            n_particles: int = 1024, ess_target: float = 0.5,
            n_moves: int = 3, stretch_a: float = 2.0, max_stages: int = 100,
            seed: int | None = None, draws: dict | None = None):
    """Tempered sequential Monte Carlo: posterior samples and log-evidence.

    N particles anneal from the prior to the posterior through
    p_β ∝ prior × L^β. Each stage picks the next β on the host by bisection
    so that the incremental-weight ESS stays at `ess_target`·N, adds
    log E[exp(Δβ·ll)] to log Z, resamples systematically (host numpy, as in
    the JAX package: one read of the log-likelihoods per stage), then runs
    `n_moves` red-black stretch sweeps on the device.

    Args:
        loglike_fn: θ (B, P) -> (B,) log-likelihood on the prior's device.
        generator: source of the device draws (seed 0 when None and no
            `draws`), and of `seed` when that is None.
        seed: the integer seeding the host resampling generator
            (`numpy.random.default_rng(seed)`); the JAX package draws it
            from its key.
        draws: optional replacement of the device draws: "particles"
            (N, P), "stretch" and "accept" uniforms (max_stages, 2·n_moves,
            N/2) and "partner" indices of that shape in [0, N/2), the
            second axis the half-sweeps in order (first half moves first).
    Returns:
        (samples (N, P) tensor, log_z float, info {"betas", "acceptance",
        "ess", "n_stages"}).
    """
    dev = prior.device
    n = n_particles + (n_particles % 2)
    half = n // 2
    dim = prior.dim
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    draws = _draws_on(draws, dev)

    def eval_both(theta):
        plp = prior.log_prob(theta)
        ll = torch.where(torch.isfinite(plp), loglike_fn(theta), -torch.inf)
        return plp, ll

    def half_draws(stage: int, k: int):
        if draws is not None:
            return (draws["stretch"][stage, k], draws["partner"][stage, k],
                    draws["accept"][stage, k])
        return (torch.rand((half,), generator=generator, device=dev),
                torch.randint(0, half, (half,), generator=generator,
                              device=dev),
                torch.rand((half,), generator=generator, device=dev))

    def move(particles, plp, ll, beta: float, stage: int):
        """n_moves red-black stretch sweeps targeting prior × L^β."""
        acc_sum = torch.zeros((), device=dev)
        for k in range(2 * n_moves):
            mov = slice(0, half) if k % 2 == 0 else slice(half, n)
            fix = slice(half, n) if k % 2 == 0 else slice(0, half)
            u, partner, u_acc = half_draws(stage, k)
            z = ((stretch_a - 1.0) * u + 1.0) ** 2 / stretch_a
            anchor = particles[fix][partner.to(torch.int64)]
            cur = particles[mov]
            prop = anchor + z[:, None] * (cur - anchor)
            p_plp, p_ll = eval_both(prop)
            log_acc = ((dim - 1) * torch.log(z) + (p_plp + beta * p_ll)
                       - (plp[mov] + beta * ll[mov]))
            acc = torch.log(u_acc) < log_acc

            def merge(t, new):
                return (torch.cat([new, t[fix]]) if k % 2 == 0
                        else torch.cat([t[fix], new]))

            particles = merge(particles, torch.where(acc[:, None], prop, cur))
            plp, ll = (merge(plp, torch.where(acc, p_plp, plp[mov])),
                       merge(ll, torch.where(acc, p_ll, ll[mov])))
            acc_sum = acc_sum + acc.to(torch.float32).mean()
        return particles, plp, ll, acc_sum / (2 * n_moves)

    particles = (draws["particles"].to(torch.float32) if draws is not None
                 else prior.sample(generator, n))
    plp, ll = eval_both(particles)
    if seed is None:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=dev))
    rng = np.random.default_rng(int(seed))

    beta, log_z = 0.0, 0.0
    betas, ess_hist, acc_hist = [0.0], [], []
    for stage in range(max_stages):
        ll_host = ll.cpu().numpy().astype(np.float64)
        finite = np.isfinite(ll_host)

        def ess_frac(db):
            w = db * (ll_host - ll_host[finite].max())
            w[~finite] = -np.inf
            w = np.exp(w - w.max())
            return (w.sum() ** 2 / (w ** 2).sum()) / n

        if ess_frac(1.0 - beta) >= ess_target:
            dbeta = 1.0 - beta
        else:
            lo, hi = 0.0, 1.0 - beta
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if ess_frac(mid) >= ess_target:
                    lo = mid
                else:
                    hi = mid
            dbeta = max(lo, 1.0e-6)
        # evidence increment under the uniform weights left by resampling
        shift = ll_host[finite].max()
        inc = dbeta * (ll_host - shift)
        inc[~finite] = -np.inf
        log_z += float(np.log(np.mean(np.exp(inc - inc.max()))) + inc.max()
                       + dbeta * shift)
        beta += dbeta
        betas.append(float(beta))

        w = np.exp(inc - inc.max())
        cum = np.cumsum(w / w.sum())
        pos = (np.arange(n) + rng.random()) / n
        idx = torch.as_tensor(np.clip(np.searchsorted(cum, pos), 0, n - 1),
                              device=dev)
        particles, plp, ll = particles[idx], plp[idx], ll[idx]
        particles, plp, ll, acc = move(particles, plp, ll, beta, stage)
        ess_hist.append(ess_frac(dbeta))
        acc_hist.append(float(acc))
        if beta >= 1.0 - 1.0e-9:
            break
    info = {"betas": betas, "acceptance": acc_hist, "ess": ess_hist,
            "n_stages": len(acc_hist)}
    return particles, float(log_z), info


def model_comparison(simulators: dict, x_obs_njy, sigma_njy, priors: dict,
                     generator: torch.Generator | None = None, **smc_kwargs):
    """Bayesian model comparison by SMC evidences.

    Args:
        simulators: {name: simulator with `.photometry`}.
        priors: {name: `BoxUniform`} over each simulator's θ.
        generator: one generator drives every model's run, in the dict's
            order (seed 0 on the first prior's device when None).
    Returns:
        {name: {"log_z", "samples", "info"}}, plus "log_bayes_factors"
        relative to the best model and "best_model".
    """
    if generator is None:
        dev = next(iter(priors.values())).device
        generator = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, sim in simulators.items():
        loglike = gaussian_loglike(lambda th, s=sim: s.photometry(th),
                                   x_obs_njy, sigma_njy,
                                   device=priors[name].device)
        samples, log_z, info = run_smc(loglike, priors[name], generator,
                                       **smc_kwargs)
        out[name] = {"log_z": log_z, "samples": samples, "info": info}
    best = max(out, key=lambda k: out[k]["log_z"])
    out["log_bayes_factors"] = {k: out[k]["log_z"] - out[best]["log_z"]
                                for k in out}
    out["best_model"] = best
    return out


# ---------------------------------------------------------------------------
# gradient fitters through the simulator
# ---------------------------------------------------------------------------
_JAC_ROWS = 16384  # rows per forward-mode Jacobian pass


@contextlib.contextmanager
def _plain_route(simulator):
    """Set `simulator._mega_off` for the block and restore it after, also
    on an exception: the kernels have no gradient, the plain route does."""
    had = getattr(simulator, "_mega_off", False)
    simulator._mega_off = True
    try:
        yield
    finally:
        simulator._mega_off = had


def _observations(x_obs_njy, sigma_njy, upper_limits, dev):
    """(M, F) fluxes, σ broadcast to them and floored at 1e-12, and the
    upper-limit mask broadcast to them (or None)."""
    x = torch.atleast_2d(_f32(x_obs_njy, dev))
    sigma = torch.clamp(_f32(sigma_njy, dev).expand(x.shape), min=1.0e-12)
    lim = (None if upper_limits is None
           else torch.as_tensor(upper_limits, dtype=torch.bool,
                                device=dev).expand(x.shape))
    return x, sigma, lim


class _LogitBox:
    """The prior box's logit coordinates u: θ = lo + w·σ(u)."""

    def __init__(self, prior):
        self.lo = prior.low
        self.width = prior.high - prior.low
        self.log_width = torch.log(self.width)

    def theta(self, u):
        return self.lo + self.width * torch.sigmoid(u)

    def log_jac(self, u):
        """log |dθ/du| summed over parameters, as −softplus(u) −
        softplus(−u): the sigmoid saturates to exactly 0 or 1 in float32 at
        |u| ≳ 17, where log σ(u) + log(1 − σ(u)) would be −inf."""
        f = torch.nn.functional.softplus
        return (self.log_width - f(u) - f(-u)).sum(dim=-1)

    def u(self, theta):
        """Logit of θ, its box fraction clipped to [0.02, 0.98]."""
        frac = torch.clamp((theta - self.lo) / self.width, 0.02, 0.98)
        return torch.log(frac) - torch.log1p(-frac)


def _rep(t, k: int):
    return None if t is None else t.repeat_interleave(k, dim=0)


def _candidate_loglike(simulator, cand, x, sigma, lim):
    """(n, P) shared candidates -> (M, n) log-likelihood of every object."""
    with torch.no_grad():
        model = simulator.photometry(cand)
    return censored_gaussian_loglike_rows(
        model[None], x[:, None], sigma[:, None],
        None if lim is None else lim[:, None])


def _value_and_grad(fn, u):
    """(fn(u) (B,), ∂Σfn/∂u (B, P)) from one forward and one backward pass;
    rows are independent, so the gradient of the sum is each row's own."""
    with torch.enable_grad():
        u = u.detach().requires_grad_(True)
        val = fn(u)
        (grad,) = torch.autograd.grad(val.sum(), u)
    return val.detach(), grad


def _graphed_value_and_grad(fn, shape, device):
    """`_value_and_grad(fn, ·)` for u of one shape on a CUDA device, as the
    replay of one CUDA graph of the forward and backward pass.

    A pass of `photometry()` and its gradient is ~800 small kernels, and
    launched one by one from Python the host sets its pace (~12 ms a pass
    at 2048 rows or at 64 on an H100). Captured once, a pass is one replay.
    The capture runs on a side stream after two warm-up passes there, with
    no device synchronisation; `fn` must be capturable (static shapes, no
    host reads, no host-to-device copies), as the sync-guarded loops
    already require. The outputs are copies, the same values as the eager
    pass: the graph replays the same kernels."""
    static_u = torch.zeros(shape, device=device, requires_grad=True)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), torch.enable_grad():
        for _ in range(2):
            torch.autograd.grad(fn(static_u).sum(), static_u)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        static_val = fn(static_u)
        (static_grad,) = torch.autograd.grad(static_val.sum(), static_u)
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)

    def run(u):
        with torch.no_grad():
            static_u.copy_(u)
        graph.replay()
        return static_val.detach().clone(), static_grad.clone()

    return run


def photometry_jacobian(simulator, theta):
    """∂photometry/∂θ (B, F, P) by forward mode: P passes of forward-AD
    dual tensors, each with the tangent e_i on every row (rows are
    independent), over row chunks of `_JAC_ROWS`. The caller sets
    `_mega_off`."""
    from torch.autograd import forward_ad

    dim = theta.shape[1]
    out = []
    with forward_ad.dual_level():
        for r in range(0, theta.shape[0], _JAC_ROWS):
            rows = theta[r:r + _JAC_ROWS].detach()
            cols = []
            for i in range(dim):
                tangent = torch.zeros_like(rows)
                tangent[:, i] = 1.0
                phot = simulator.photometry(forward_ad.make_dual(rows,
                                                                 tangent))
                cols.append(forward_ad.unpack_dual(phot).tangent)
            out.append(torch.stack(cols, dim=-1))
    return torch.cat(out)


def _gauss_newton_sigma(jac, sigma):
    """Marginal 1σ from JᵀΣ⁻¹J (B, P, P): sqrt diag of its inverse (with
    1e-12 on the diagonal), NaN where not positive. Returns (F, σ)."""
    jw = jac / sigma[..., None]
    fisher = jw.transpose(-1, -2) @ jw
    eye = torch.eye(jac.shape[-1], dtype=fisher.dtype, device=fisher.device)
    # solve_ex: no singularity check, which would wait for the card; a
    # singular F gives non-finite or non-positive entries, hence NaN
    d = torch.diagonal(torch.linalg.solve_ex(fisher + 1.0e-12 * eye,
                                             eye.expand_as(fisher))[0],
                       dim1=-2, dim2=-1)
    return fisher, torch.where(d > 0, torch.sqrt(torch.clamp(d, min=0.0)),
                               torch.nan)


def fit_observation_mcmc(simulator, x_obs_njy, sigma_njy, prior,
                         generator: torch.Generator | None = None,
                         n_walkers: int = 64, n_steps: int = 1500,
                         burn_in: int = 500, draws: dict | None = None):
    """Likelihood fit of one observation through the simulator by
    `run_ensemble_mcmc` (gradient-free: the photometry takes its kernel
    route). Returns (samples, log-probabilities, acceptance tensor)."""
    loglike = gaussian_loglike(simulator.photometry, x_obs_njy, sigma_njy,
                               device=prior.device)
    return run_ensemble_mcmc(loglike, prior, generator, n_walkers=n_walkers,
                             n_steps=n_steps, burn_in=burn_in, draws=draws)


def fit_observation_hmc(simulator, x_obs_njy, sigma_njy, prior,
                        generator: torch.Generator | None = None,
                        n_chains: int = 16, n_warmup: int = 150,
                        n_samples: int = 400, n_leapfrog: int = 12,
                        target_accept: float = 0.8, upper_limits=None,
                        init_theta=None, draws: dict | None = None):
    """HMC of one object: `fit_catalogue_hmc` on a one-row catalogue.
    Returns samples (n_chains·n_samples, P), log-posteriors and the mean
    acceptance (0-d tensor)."""
    dev = prior.device
    samples, lps, acc = fit_catalogue_hmc(
        simulator, torch.atleast_2d(_f32(x_obs_njy, dev)), sigma_njy, prior,
        generator, n_chains=n_chains, n_warmup=n_warmup, n_samples=n_samples,
        n_leapfrog=n_leapfrog, target_accept=target_accept,
        upper_limits=(None if upper_limits is None else torch.as_tensor(
            upper_limits, dtype=torch.bool, device=dev)[None]),
        init_theta=None if init_theta is None else _f32(init_theta, dev)[None],
        draws=draws)
    return samples[0], lps[0], acc


def fit_catalogue_hmc(simulator, x_obs_njy, sigma_njy, prior,
                      generator: torch.Generator | None = None,
                      n_chains: int = 8, n_warmup: int = 150,
                      n_samples: int = 400, n_leapfrog: int = 12,
                      target_accept: float = 0.8, upper_limits=None,
                      init_theta=None, draws: dict | None = None):
    """Exact-likelihood HMC for a whole catalogue: M objects × C chains
    advance together, every leapfrog step one (M·C, P) photometry pass and
    its gradient.

    Chains sample in the prior box's logit space (softplus Jacobian) and
    start at each object's best candidates of a prior sweep of max(256, 8C)
    draws, or at `init_theta`. Warmup has two phases of per-object dual
    averaging (log ε capped at log 0.5): first with unit mass while
    accumulating each chain's u variance (Welford), then against a
    per-object diagonal mass from within- plus between-chain variance,
    normalised by its geometric mean and clipped to [1/30, 30]. A proposal
    whose Hamiltonian difference is NaN, or that leaves |u| ≤ 12, is
    rejected; +inf is accepted. Each leapfrog trajectory makes
    n_leapfrog + 1 value-and-gradient passes, the last one also giving the
    proposal's log-posterior; on a CUDA device each pass is the replay of
    one captured CUDA graph (`_graphed_value_and_grad`).

    Args:
        x_obs_njy: (M, F) fluxes; sigma_njy: (F,) or (M, F) 1σ errors;
            upper_limits: optional (F,) or (M, F) bool censoring mask.
        init_theta: optional (M, K, P) chain starts, K ≥ n_chains; with
            K > n_chains the C of highest likelihood start the chains.
        generator: source of every draw on the prior's device (seed 0 when
            None and no `draws`).
        draws: optional replacement of the generator's draws:
            "candidates" (max(256, 8C), P) prior draws (unused with
            `init_theta`), "momenta" (steps, M·C, P) normals and "accept"
            (steps, M·C) uniforms, steps = warmup A, warmup B, then the
            samples (n_warmup // 2, n_warmup − that, n_samples; at least 1
            each for warmup).
    Returns:
        samples (M, C·S, P) and log-posteriors (M, C·S) (chain-major), and
        the mean acceptance probability as a 0-d tensor, all on the
        prior's device. The step loop reads nothing back to the host.
    """
    dev = prior.device
    x, sigma, lim = _observations(x_obs_njy, sigma_njy, upper_limits, dev)
    m, c, dim = x.shape[0], int(n_chains), prior.dim
    x_rep, sg_rep, lim_rep = _rep(x, c), _rep(sigma, c), _rep(lim, c)
    n_wa = max(n_warmup // 2, 1)
    n_wb = max(n_warmup - n_wa, 1)
    if init_theta is not None:
        theta0 = _f32(init_theta, dev)
        if (theta0.ndim != 3 or theta0.shape[0] != m
                or theta0.shape[1] < c or theta0.shape[2] != dim):
            raise ValueError(f"init_theta must be ({m}, >= {c}, {dim}), got "
                             f"{tuple(theta0.shape)}")
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    draws = _draws_on(draws, dev)
    box = _LogitBox(prior)

    def logpost(u):
        model = simulator.photometry(box.theta(u))
        return (censored_gaussian_loglike_rows(model, x_rep, sg_rep, lim_rep)
                + box.log_jac(u))

    def leapfrog(u, p, eps):
        # eps (M·C, P): per-coordinate step sizes are a diagonal mass
        _, g = value_and_grad(u)
        p = p + 0.5 * eps * g
        for _ in range(n_leapfrog - 1):
            u = u + eps * p
            _, g = value_and_grad(u)
            p = p + eps * g
        u = u + eps * p
        lp_new, g = value_and_grad(u)
        return u, p + 0.5 * eps * g, lp_new

    def hmc_step(u, lp, step: int, eps):
        if draws is not None:
            p0, u_acc = draws["momenta"][step], draws["accept"][step]
        else:
            p0 = torch.randn(u.shape, generator=generator, device=dev)
            u_acc = torch.rand((u.shape[0],), generator=generator, device=dev)
        u_new, p_new, lp_new = leapfrog(u, p0, eps)
        dh = ((lp_new - 0.5 * (p_new ** 2).sum(dim=-1))
              - (lp - 0.5 * (p0 ** 2).sum(dim=-1)))
        diverged = torch.isnan(dh) | (u_new.abs().amax(dim=-1) > 12.0)
        log_alpha = torch.where(diverged, -torch.inf,
                                torch.clamp(dh, max=0.0))
        accept = torch.log(u_acc) < log_alpha
        u = torch.where(accept[:, None], u_new, u)
        lp = torch.where(accept, lp_new, lp)
        # per-object mean acceptance: step sizes adapt per object
        return u, lp, torch.exp(log_alpha).reshape(m, c).mean(dim=1)

    def expand(log_eps):  # (M,) -> (M·C, 1)
        return torch.exp(log_eps).repeat_interleave(c)[:, None]

    def run_warm(u, lp, s_vec, log_eps0, mu0, n_steps: int, first: int):
        """Dual averaging of log ε per object; Welford u mean and M2."""
        log_eps, log_eps_bar = log_eps0, log_eps0
        h_bar = torch.zeros((m,), device=dev)
        mean, m2 = torch.zeros_like(u), torch.zeros_like(u)
        for i in range(n_steps):
            u, lp, a_obj = hmc_step(u, lp, first + i, expand(log_eps) * s_vec)
            h_bar = ((1.0 - 1.0 / (i + 11.0)) * h_bar
                     + (target_accept - a_obj) / (i + 11.0))
            log_eps = torch.clamp(mu0 - math.sqrt(i + 1.0) / 0.05 * h_bar,
                                  max=math.log(0.5))
            w = (i + 1.0) ** -0.75
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            d = u - mean
            mean = mean + d / (i + 1.0)
            m2 = m2 + d * (u - mean)
        return u, lp, log_eps_bar, float(n_steps), mean, m2

    with _plain_route(simulator), _no_host_sync(dev):
        if init_theta is not None and theta0.shape[1] > c:
            kk = theta0.shape[1]
            with torch.no_grad():
                ll0 = censored_gaussian_loglike_rows(
                    simulator.photometry(theta0.reshape(m * kk, dim)),
                    _rep(x, kk), _rep(sigma, kk), _rep(lim, kk)).reshape(m, kk)
            top = torch.argsort(-ll0, dim=1, stable=True)[:, :c]
            theta0 = torch.gather(theta0, 1, top[..., None].expand(-1, -1, dim))
        elif init_theta is None:
            n_cand = max(256, 8 * c)
            cand = (draws["candidates"].to(torch.float32) if draws is not None
                    else prior.sample(generator, n_cand))
            ll_c = _candidate_loglike(simulator, cand, x, sigma, lim)
            top = torch.argsort(-ll_c, dim=1, stable=True)[:, :c]
            theta0 = cand[top]
        u = box.u(theta0.reshape(m * c, dim))
        with torch.no_grad():
            lp = logpost(u)
        if dev.type == "cuda":
            value_and_grad = _graphed_value_and_grad(logpost, u.shape, dev)
        else:
            def value_and_grad(u):
                return _value_and_grad(logpost, u)

        mvec = torch.full((m,), math.log(0.1), device=dev)
        ones = torch.ones((1, dim), device=dev)
        u, lp, log_eps_a, cnt, mean, m2 = run_warm(
            u, lp, ones, mvec, mvec + math.log(10.0), n_wa, 0)
        var_w = (m2 / max(cnt - 1.0, 1.0)).reshape(m, c, dim)
        mean_o = mean.reshape(m, c, dim)
        s_obj = torch.sqrt(var_w.mean(dim=1)
                           + mean_o.var(dim=1, correction=0) + 1.0e-8)
        s_obj = s_obj / torch.exp(torch.log(s_obj).mean(dim=-1, keepdim=True))
        s_vec = torch.clamp(s_obj, 1.0 / 30.0, 30.0).repeat_interleave(c, 0)
        u, lp, log_eps_bar, _, _, _ = run_warm(
            u, lp, s_vec, log_eps_a, math.log(10.0) + log_eps_a, n_wb, n_wa)
        eps = expand(log_eps_bar) * s_vec

        chain_u, chain_lp = [], []
        acc_sum = torch.zeros((), device=dev)
        for i in range(n_samples):
            u, lp, a_obj = hmc_step(u, lp, n_wa + n_wb + i, eps)
            chain_u.append(u)
            chain_lp.append(lp)
            acc_sum = acc_sum + a_obj.mean()
        # (S, M·C, P) -> (M, C·S, P)
        theta_chain = box.theta(torch.stack(chain_u)).reshape(
            n_samples, m, c, dim)
        samples = theta_chain.permute(1, 2, 0, 3).reshape(m, c * n_samples,
                                                          dim)
        lps = torch.stack(chain_lp).reshape(n_samples, m, c).permute(
            1, 2, 0).reshape(m, c * n_samples)
    return samples, lps, acc_sum / max(n_samples, 1)


def fit_catalogue_map(simulator, x_obs_njy, sigma_njy, prior,
                      generator: torch.Generator | None = None,
                      n_steps: int = 400, n_restarts: int = 4,
                      learning_rate: float = 0.05, upper_limits=None,
                      draws: dict | None = None):
    """MAP and Laplace fits of a catalogue through the simulator: Adam in
    the prior box's logit space for every object and restart at once, each
    step one (M·R, P) photometry pass and its gradient.

    Each object's R restarts start at its best R of max(64, 8R) candidates
    shared by all objects (`draws["candidates"]` or prior draws from the
    generator). The Laplace σ is sqrt diag of (JᵀΣ⁻¹J)⁻¹ at the MAP, the
    Gauss–Newton Hessian of the χ² term with J by forward mode
    (`photometry_jacobian`).

    Returns:
        {"theta_map" (M, P), "laplace_sigma" (M, P) (NaN where not
        positive definite), "neg_logpost" (M,) at the best restart,
        "log_like" (M,) at the MAP}, tensors on the prior's device.
    """
    dev = prior.device
    x, sigma, lim = _observations(x_obs_njy, sigma_njy, upper_limits, dev)
    m, dim, r = x.shape[0], prior.dim, int(n_restarts)
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    draws = _draws_on(draws, dev)
    box = _LogitBox(prior)
    x_rep, sg_rep, lim_rep = _rep(x, r), _rep(sigma, r), _rep(lim, r)

    def neg_logpost(u):
        model = simulator.photometry(box.theta(u))
        return -(censored_gaussian_loglike_rows(model, x_rep, sg_rep, lim_rep)
                 + box.log_jac(u))

    with _plain_route(simulator):
        cand = (draws["candidates"].to(torch.float32) if draws is not None
                else prior.sample(generator, max(64, 8 * r)))
        ll_c = _candidate_loglike(simulator, cand, x, sigma, lim)
        top = torch.argsort(-ll_c, dim=1, stable=True)[:, :r]
        u = box.u(cand[top]).reshape(m * r, dim)
        mom, vel = torch.zeros_like(u), torch.zeros_like(u)
        lrs = torch.full((m * r,), float(learning_rate), device=dev)
        with _no_host_sync(dev):
            for step in range(1, n_steps + 1):
                _, g = _value_and_grad(neg_logpost, u)
                _optimizer_step(u, g, mom, vel, step, lrs, 0.0, 0.0)
            with torch.no_grad():
                nlp = neg_logpost(u).reshape(m, r)
            best = torch.argmin(nlp, dim=1)
            rows = torch.arange(m, device=dev)
            theta_map = box.theta(u.reshape(m, r, dim)[rows, best])
            _, lap = _gauss_newton_sigma(
                photometry_jacobian(simulator, theta_map), sigma)
            with torch.no_grad():
                ll = censored_gaussian_loglike_rows(
                    simulator.photometry(theta_map), x, sigma, lim)
    return {"theta_map": theta_map, "laplace_sigma": lap,
            "neg_logpost": nlp[rows, best], "log_like": ll}


def fit_catalogue_vi(simulator, x_obs_njy, sigma_njy, prior,
                     generator: torch.Generator | None = None,
                     n_steps: int = 500, n_mc: int = 8,
                     learning_rate: float = 0.03, upper_limits=None,
                     draws: dict | None = None):
    """Full-rank Gaussian variational inference through the simulator for
    every object at once: q(u) = N(m, LLᵀ) in the prior box's logit space,
    L = strictly lower triangle + diag(softplus(raw)), fitted by Adam on
    the reparameterised ELBO (n_mc draws per object and step).

    q starts at each object's best of 256 prior candidates with
    raw = −1. `draws` may replace the generator's draws: "candidates"
    (256, P), "eps" (n_steps, M, n_mc, P) normals of the steps and
    "eps_samples" (M, 256, P) normals of the returned samples.

    Returns:
        {"mean", "sigma" (M, P): θ-space mean and (population) standard
        deviation of q's samples, "samples" (M, 256, P), "elbo" (M,) the
        last step's per-object ELBO (up to the base normal's constant
        entropy)}, tensors on the prior's device.
    """
    dev = prior.device
    x, sigma, lim = _observations(x_obs_njy, sigma_njy, upper_limits, dev)
    m, dim = x.shape[0], prior.dim
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    draws = _draws_on(draws, dev)
    box = _LogitBox(prior)
    x_rep, sg_rep, lim_rep = _rep(x, n_mc), _rep(sigma, n_mc), _rep(lim, n_mc)
    sizes = [dim, dim * dim, dim]

    def unpack(flat):
        mean, tril, raw = flat.split(sizes, dim=1)
        return mean, tril.reshape(m, dim, dim), raw

    def chol(tril, raw):
        return (torch.tril(tril, -1)
                + torch.diag_embed(torch.nn.functional.softplus(raw)))

    def draw(flat, eps):  # eps (M, n, P) -> u (M, n, P)
        mean, tril, raw = unpack(flat)
        return mean[:, None, :] + torch.einsum("mij,mnj->mni",
                                               chol(tril, raw), eps)

    def neg_elbo(flat, eps):
        u = draw(flat, eps)
        lp = (censored_gaussian_loglike_rows(
            simulator.photometry(box.theta(u.reshape(m * n_mc, dim))),
            x_rep, sg_rep, lim_rep) + box.log_jac(u.reshape(m * n_mc, dim)))
        ent = torch.log(torch.nn.functional.softplus(unpack(flat)[2])).sum(-1)
        return lp.reshape(m, n_mc).mean(dim=1) + ent

    with _plain_route(simulator):
        cand = (draws["candidates"].to(torch.float32) if draws is not None
                else prior.sample(generator, 256))
        ll_c = _candidate_loglike(simulator, cand, x, sigma, lim)
        flat = torch.cat([box.u(cand[torch.argmax(ll_c, dim=1)]),
                          torch.zeros((m, dim * dim), device=dev),
                          torch.full((m, dim), -1.0, device=dev)], dim=1)
        mom, vel = torch.zeros_like(flat), torch.zeros_like(flat)
        lrs = torch.full((m,), float(learning_rate), device=dev)
        elbo = torch.full((m,), torch.nan, device=dev)
        with _no_host_sync(dev):
            for step in range(n_steps):
                eps = (draws["eps"][step] if draws is not None
                       else torch.randn((m, n_mc, dim), generator=generator,
                                        device=dev))
                with torch.enable_grad():
                    p = flat.detach().requires_grad_(True)
                    elbo = neg_elbo(p, eps)
                    (g,) = torch.autograd.grad(-elbo.sum(), p)
                elbo = elbo.detach()
                _optimizer_step(flat, g, mom, vel, step + 1, lrs, 0.0, 0.0)
            eps = (draws["eps_samples"] if draws is not None
                   else torch.randn((m, 256, dim), generator=generator,
                                    device=dev))
            with torch.no_grad():
                th = box.theta(draw(flat, eps))
    return {"mean": th.mean(dim=1), "sigma": th.std(dim=1, correction=0),
            "samples": th, "elbo": elbo}
