"""Simformer: a score-based transformer over joint (θ, x) tokens.

Counterpart of `synference_tpu/simformer.py`. Parameters and observations
become one token sequence; a transformer denoiser is trained by VPSDE score
matching under random condition masks, so one model serves the posterior,
the likelihood and any partial conditional (a missing band is an
unconditioned token). Defaults: d_model 128, 4 heads, 4 layers, VPSDE β in
[0.1, 20].

`Simformer` is an `nn.Module` whose parameters carry the JAX package's names
(`value_in`, `node_embed`, `cond_embed`, `t_proj`, `layers[i].{qkv,
attn_out, ff1, ff2, ln1, ln2}`, `out`; a dense layer's `w` is (n_out,
n_in)); `params()` gives them as the JAX tree and `load_params` takes one
(numpy or tensors), so weights and saved models go both ways.

The arithmetic follows the JAX code: GELU is the tanh approximation
(`jax.nn.gelu`'s default), layer norm and the token standardiser take the
population variance, masked attention logits are filled with -1e9, σ(t) is
clamped at 1e-8 under the square root and the score divides by max(σ,
1e-4). The optimiser is the port's AdamW (`train._optimizer_step`) with
optax's defaults: `clip_by_global_norm(5) ∘ adamw(lr)`, weight decay 1e-4.

Draws come from a `torch.Generator` (seed 0 on the model's device when
None); `simformer_loss` takes the condition masks, diffusion times and
noise by name, so a test can hold it to the JAX loss on the JAX package's
draws. The validation pass uses one fixed set of draws (a generator seeded
with 0), as the JAX package re-draws the same ones from `PRNGKey(0)` every
epoch. `SimformerPosterior.sample_batch` draws all objects' rows from one
generator in one batch, where the JAX package splits one key per object.

On a CUDA device one reverse-SDE step and one probability-flow ODE step are
each the replay of a captured CUDA graph (`graphed=False` runs the same
kernels eagerly, to the same bits); the noise of each step is drawn before
the replay into a buffer the graph reads. The training step is eager.
"""

from __future__ import annotations

import math
import pickle
from dataclasses import asdict, dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd import forward_ad

from .classifier import _graphed
from .flows.base import (load_module_params, module_params,
                         params_to_numpy, tree_map)
from .train import _no_host_sync, _optimizer_step

__all__ = ["SimformerConfig", "Simformer", "VPSDE", "train_simformer",
           "SimformerPosterior", "simformer_loss",
           "train_noise_model_simformer", "block_attn_mask"]

_CLIP, _WEIGHT_DECAY = 5.0, 1.0e-4  # clip_by_global_norm(5), optax.adamw


def _as_f32(a, device=None):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# VPSDE
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VPSDE:
    """Variance-preserving SDE: β(t) = β_min + t (β_max − β_min);
    x_t = e^{-½∫β} x_0 + sqrt(1 − e^{-∫β}) ε."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def _int_beta(self, t):
        return self.beta_min * t + 0.5 * (self.beta_max - self.beta_min) * t**2

    def alpha(self, t):
        return torch.exp(-0.5 * self._int_beta(_as_f32(t)))

    def sigma(self, t):
        return torch.sqrt(torch.clamp(
            1.0 - torch.exp(-self._int_beta(_as_f32(t))), min=1.0e-8))

    def beta(self, t):
        return self.beta_min + _as_f32(t) * (self.beta_max - self.beta_min)

    def marginal(self, x0, t, generator: torch.Generator | None = None,
                 eps=None):
        """x_t | x_0 with noise `eps` (drawn from `generator` when None);
        returns (x_t, eps)."""
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator,
                              device=x0.device)
        return (self.alpha(t)[..., None] * x0
                + self.sigma(t)[..., None] * eps), eps


# ---------------------------------------------------------------------------
# score transformer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimformerConfig:
    n_tokens: int  # P + F
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 256
    t_embed_dim: int = 64


def _time_embedding(t, dim: int):
    """Sinusoidal embedding of diffusion time t in [0, 1]."""
    freqs = torch.exp(torch.linspace(0.0, math.log(1000.0), dim // 2,
                                     dtype=torch.float32, device=t.device))
    ang = t[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_out, n_in, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x):
        return x @ self.w.T + self.b


class _Norm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, device=device))
        self.b = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        return (x - mu) * torch.rsqrt(var + 1.0e-6) * self.g + self.b


class _Block(nn.Module):
    def __init__(self, d: int, d_ff: int, device):
        super().__init__()
        self.qkv = _Dense(d, 3 * d, device)
        self.attn_out = _Dense(d, d, device)
        self.ff1 = _Dense(d, d_ff, device)
        self.ff2 = _Dense(d_ff, d, device)
        self.ln1 = _Norm(d, device)
        self.ln2 = _Norm(d, device)


class Simformer(nn.Module):
    """Token-wise score network s(v_t, t, condition_mask) on `device`."""

    def __init__(self, config: SimformerConfig, sde: VPSDE = VPSDE(), *,
                 device):
        super().__init__()
        self.cfg = config
        self.sde = sde
        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # raises where the device is absent
        d, dev = config.d_model, self.device
        self.value_in = _Dense(1, d, dev)
        self.node_embed = nn.Parameter(torch.zeros(config.n_tokens, d,
                                                   device=dev))
        self.cond_embed = nn.Parameter(torch.zeros(2, d, device=dev))
        self.t_proj = _Dense(config.t_embed_dim, d, dev)
        self.layers = nn.ModuleList(
            [_Block(d, config.d_ff, dev) for _ in range(config.n_layers)])
        self.out = _Dense(d, 1, dev)

    def init(self, generator: torch.Generator) -> "Simformer":
        """Fresh weights: dense w ~ N(0, 1/n_in), b = 0, the node and
        condition embeddings N(0, 1) (O(1), so that tokens are told apart
        from the first step), layer norms identity, the output layer zero."""
        def normal(shape):
            return torch.randn(shape, generator=generator, device=self.device)

        with torch.no_grad():
            dense = [self.value_in, self.t_proj]
            for layer in self.layers:
                dense += [layer.qkv, layer.attn_out, layer.ff1, layer.ff2]
                for ln in (layer.ln1, layer.ln2):
                    ln.g.fill_(1.0)
                    ln.b.zero_()
            for p in dense:
                p.w.copy_(normal(p.w.shape) / math.sqrt(p.w.shape[1]))
                p.b.zero_()
            self.node_embed.copy_(normal(self.node_embed.shape))
            self.cond_embed.copy_(normal(self.cond_embed.shape))
            self.out.w.zero_()
            self.out.b.zero_()
        return self

    def params(self):
        """The parameters as the JAX package's tree (the tensors
        themselves)."""
        return module_params(self)

    def load_params(self, tree) -> None:
        """Copy a JAX-layout parameter tree (numpy or tensors) in."""
        load_module_params(self, tree)

    def score(self, v_t, t, condition_mask, attn_mask=None):
        """Score of latent tokens.

        Args:
            v_t: (B, T) noisy token values (standardised space).
            t: (B,) diffusion times in (0, 1].
            condition_mask: (B, T) 1 = observed token.
            attn_mask: optional (T, T) boolean tensor, True = attend.
        Returns:
            (B, T) score estimate −ε̂/σ.
        """
        cfg = self.cfg
        h = self.value_in(v_t[..., None])  # (B, T, d)
        h = h + self.node_embed[None]
        h = h + self.cond_embed[condition_mask.long()]
        h = h + self.t_proj(_time_embedding(t, cfg.t_embed_dim))[:, None, :]
        d_head = cfg.d_model // cfg.n_heads
        for layer in self.layers:
            q, k, v = layer.qkv(layer.ln1(h)).chunk(3, dim=-1)
            q, k, v = (a.reshape(*a.shape[:-1], cfg.n_heads, d_head)
                       for a in (q, k, v))
            logits = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d_head)
            if attn_mask is not None:
                logits = logits.masked_fill(~attn_mask[None, None], -1.0e9)
            o = torch.einsum("bhts,bshd->bthd", torch.softmax(logits, -1), v)
            h = h + layer.attn_out(o.reshape(*o.shape[:-2], cfg.d_model))
            x = F.gelu(layer.ff1(layer.ln2(h)), approximate="tanh")
            h = h + layer.ff2(x)
        eps_hat = self.out(h)[..., 0]  # (B, T)
        return -eps_hat / torch.clamp(self.sde.sigma(t)[..., None],
                                      min=1.0e-4)

    def eps_pred(self, v_t, t, condition_mask, attn_mask=None):
        return -self.score(v_t, t, condition_mask, attn_mask) * (
            self.sde.sigma(t)[..., None])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _random_condition_masks(generator: torch.Generator, batch: int,
                            n_theta: int, n_x: int, device):
    """Mix of task masks per row (the Simformer recipe): the posterior mask
    (x observed), the joint (nothing observed) and Bernoulli(0.3) masks."""
    n_tok = n_theta + n_x
    rand = (torch.rand((batch, n_tok), generator=generator, device=device)
            < 0.3).to(torch.float32)
    choice = torch.randint(0, 3, (batch,), generator=generator,
                           device=device)[:, None]
    posterior = torch.cat([torch.zeros(n_theta, device=device),
                           torch.ones(n_x, device=device)])
    return torch.where(choice == 0, posterior,
                       torch.where(choice == 1, 0.0, rand))


def _draws(generator: torch.Generator, batch: int, n_theta: int, n_x: int,
           device):
    """One training step's draws: condition masks, t ~ U[1e-3, 1), ε."""
    cond = _random_condition_masks(generator, batch, n_theta, n_x, device)
    t = torch.rand(batch, generator=generator, device=device) * (
        1.0 - 1.0e-3) + 1.0e-3
    eps = torch.randn((batch, n_theta + n_x), generator=generator,
                      device=device)
    return cond, t, eps


def simformer_loss(model: Simformer, vb, cond, t, eps, attn_mask=None):
    """Denoising score-matching loss on the latent tokens of standardised
    rows `vb` (B, T) with condition masks `cond` (B, T), times `t` (B,)
    and noise `eps` (B, T); observed tokens stay clean."""
    v_t, _ = model.sde.marginal(vb, t, eps=eps)
    v_t = torch.where(cond == 1.0, vb, v_t)
    eps_hat = model.eps_pred(v_t, t, cond, attn_mask)
    w = 1.0 - cond
    return (w * (eps_hat - eps) ** 2).sum() / torch.clamp(w.sum(), min=1.0)


def _flat_view(model: nn.Module):
    """Make every parameter of `model` a view of one (1, P) buffer, the
    layout the port's optimiser steps; returns (buffer, parameters)."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])[None]
    offset = 0
    for p in params:
        p.data = flat[0, offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat, params


def train_simformer(model: Simformer, theta, x,
                    generator: torch.Generator | None = None,
                    batch_size: int = 256, learning_rate: float = 1.0e-4,
                    max_epochs: int = 100, stop_after_epochs: int = 15,
                    validation_fraction: float = 0.1, attn_mask=None):
    """Denoising score-matching training over joint (θ, x) tokens on the
    model's device.

    Tokens are z-scored with the training statistics (population standard
    deviation floored at 1e-6), stored beside the weights. Returns
    (best-validation parameters as the JAX tree of tensors, standardiser
    dict, history {"train": [...], "val": [...]}); the model holds the best
    parameters afterwards. One readback per epoch; on a CUDA device the
    epoch runs under the sync debug mode "error".
    """
    dev = model.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    theta = torch.atleast_2d(_as_f32(theta, dev))
    x = torch.atleast_2d(_as_f32(x, dev))
    v = torch.cat([theta, x], dim=1)  # (N, T)
    n_theta, n_x = theta.shape[1], x.shape[1]
    if v.shape[1] != model.cfg.n_tokens:
        raise ValueError(f"{v.shape[1]} tokens for a model of "
                         f"{model.cfg.n_tokens}")
    mu = v.mean(0)
    sd = torch.clamp(v.std(0, correction=0), min=1.0e-6)
    v = (v - mu) / sd

    n = v.shape[0]
    perm = torch.rand(n, generator=generator, device=dev).argsort()
    n_val = max(int(n * validation_fraction), 1)
    v_val, v_tr = v[perm[:n_val]], v[perm[n_val:]]
    n_tr = v_tr.shape[0]
    bs = min(batch_size, n_tr)
    steps = max(n_tr // bs, 1)

    model.init(generator)
    mask = (None if attn_mask is None
            else torch.as_tensor(np.asarray(attn_mask), dtype=torch.bool,
                                 device=dev))
    val_draws = _draws(torch.Generator(device=dev).manual_seed(0), n_val,
                       n_theta, n_x, dev)
    flat, leaves = _flat_view(model)
    m, vv = torch.zeros_like(flat), torch.zeros_like(flat)
    lrs = torch.full((1,), float(learning_rate), device=dev)
    best_flat, best_val, since_best, step = flat.clone(), np.inf, 0, 0
    hist = {"train": [], "val": []}
    for _ in range(max_epochs):
        with _no_host_sync(dev):
            order = torch.rand(n_tr, generator=generator,
                               device=dev).argsort()[:steps * bs]
            order = order.view(steps, bs)
            total = torch.zeros((), device=dev)
            for s in range(steps):
                cond, t, eps = _draws(generator, bs, n_theta, n_x, dev)
                loss = simformer_loss(model, v_tr[order[s]], cond, t, eps,
                                      mask)
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    step += 1
                    _optimizer_step(
                        flat, torch.cat([g.reshape(1, -1) for g in grads],
                                        dim=1),
                        m, vv, step, lrs, _CLIP, _WEIGHT_DECAY)
                    total += loss.detach()
            with torch.no_grad():
                report = torch.stack([total / steps, simformer_loss(
                    model, v_val, *val_draws, mask)])
        tr, val = report.tolist()  # the epoch's one readback
        hist["train"].append(tr)
        hist["val"].append(val)
        if val < best_val:
            best_val, since_best = val, 0
            best_flat.copy_(flat)
        else:
            since_best += 1
            if since_best >= stop_after_epochs:
                break
    with torch.no_grad():
        flat.copy_(best_flat)
    params = tree_map(lambda p: p.detach().clone(), model.params())
    standardizer = {"mu": mu.cpu().numpy(), "sd": sd.cpu().numpy(),
                    "n_theta": int(n_theta), "n_x": int(n_x)}
    return params, standardizer, hist


# ---------------------------------------------------------------------------
# posterior sampling via reverse diffusion
# ---------------------------------------------------------------------------


class SimformerPosterior:
    """Conditional sampling by reverse-SDE diffusion of the latent tokens,
    observed tokens clamped; `log_prob` by the probability-flow ODE.
    `params` (a JAX-layout tree, or None to keep the model's) is loaded
    into `model`."""

    def __init__(self, model: Simformer, params, standardizer: dict,
                 attn_mask=None, n_steps: int = 500):
        self.model = model
        if params is not None:
            model.load_params(params)
        self.std = dict(standardizer)
        self.attn_mask = (None if attn_mask is None
                          else np.asarray(attn_mask, dtype=bool))
        self._mask = (None if attn_mask is None
                      else torch.as_tensor(self.attn_mask,
                                           device=model.device))
        self.n_steps = int(n_steps)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def params(self):
        return self.model.params()

    def _stats(self):
        return (_as_f32(self.std["mu"], self.device),
                _as_f32(self.std["sd"], self.device))

    def _condition(self, condition_mask):
        """(T,) float mask, 1 = observed; default: x observed, θ latent."""
        if condition_mask is not None:
            return _as_f32(np.asarray(condition_mask), self.device)
        n_theta, n_tok = self.std["n_theta"], self.model.cfg.n_tokens
        return torch.cat([torch.zeros(n_theta, device=self.device),
                          torch.ones(n_tok - n_theta, device=self.device)])

    def _use_graph(self, graphed) -> bool:
        return self.device.type == "cuda" if graphed is None else bool(graphed)

    def sample(self, x_obs, n: int, generator: torch.Generator | None = None,
               condition_mask=None, graphed: bool | None = None):
        """n θ draws given one observation x (F,). Returns (n, P)."""
        x_obs = _as_f32(x_obs, self.device).reshape(1, -1)
        return self.sample_batch(x_obs, n, generator, condition_mask,
                                 graphed)[0]

    def sample_batch(self, xs, n: int,
                     generator: torch.Generator | None = None,
                     condition_mask=None, graphed: bool | None = None):
        """n θ draws for each of M observations (M, F): (M, n, P). All M·n
        rows diffuse together from one generator (seed 0 on the device
        when None); a CUDA device replays one captured graph per step."""
        model, sde, dev = self.model, self.model.sde, self.device
        n_theta, n_tok = self.std["n_theta"], model.cfg.n_tokens
        xs = torch.atleast_2d(_as_f32(xs, dev))
        rows = xs.shape[0] * n
        mu, sd = self._stats()
        cond = self._condition(condition_mask).expand(rows, n_tok)
        v_obs = (torch.cat([torch.zeros(xs.shape[0], n_theta, device=dev),
                            xs], dim=1) - mu) / sd
        v_obs = v_obs.repeat_interleave(n, dim=0)
        observed = cond == 1.0
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dt = 1.0 / self.n_steps
        with torch.no_grad():
            v = torch.randn((rows, n_tok), generator=generator, device=dev)
            state = {"v": torch.where(observed, v_obs, v),
                     "t": torch.zeros((), device=dev),
                     "noise": torch.zeros((rows, n_tok), device=dev)}

            def step():
                v, t = state["v"], state["t"]
                score = model.score(v, t.expand(rows), cond, self._mask)
                beta = sde.beta(t)
                drift = -0.5 * beta * v - beta * score
                v_new = v - drift * dt + torch.sqrt(beta * dt) * state["noise"]
                v.copy_(torch.where(observed, v_obs, v_new))

            run = _graphed(step, state, dev) if self._use_graph(
                graphed) else step
            for i in range(self.n_steps):
                state["t"].fill_(1.0 - i * dt)
                state["noise"].normal_(generator=generator)
                run()
            theta = state["v"][:, :n_theta] * sd[:n_theta] + mu[:n_theta]
        return theta.reshape(xs.shape[0], n, n_theta)

    def log_prob(self, theta, xs, condition_mask=None,
                 n_steps: int | None = None, graphed: bool | None = None):
        """Conditional log p(θ | x) via the probability-flow ODE.

        dv/dt = −½β(t)(v + s_θ(v, t)) shares the reverse SDE's marginals;
        integrating a (θ, x) point from t = 1e-3 to 1 with the
        instantaneous change of variables gives its log-density under the
        learned score. Observed tokens are frozen; the divergence is the
        exact trace over latent tokens, one forward-mode JVP per LATENT
        token (observed tokens' drift rows are zero, so their directions are
        skipped): all directions go through the network as one batch of
        L·n rows of dual tensors.

        Args:
            theta: (n, P) parameter points (original units).
            xs: (n, F) paired observations.
            condition_mask: optional (T,) override, 1 = observed token;
                default x observed, θ latent.
        Returns:
            (n,) log densities in original θ units.
        """
        model, sde, dev = self.model, self.model.sde, self.device
        theta = torch.atleast_2d(_as_f32(theta, dev))
        xs = torch.atleast_2d(_as_f32(xs, dev))
        n, n_tok = theta.shape[0], model.cfg.n_tokens
        cond = self._condition(condition_mask)
        lat_idx = np.where(cond.cpu().numpy() == 0)[0]
        if not len(lat_idx):
            raise ValueError("condition_mask marks every token observed — "
                             "there is no latent density to evaluate")
        n_lat = len(lat_idx)
        steps = int(n_steps if n_steps is not None else self.n_steps)
        mu, sd = self._stats()
        lat = 1.0 - cond
        basis = torch.zeros(n_lat, n_tok, device=dev)
        basis[torch.arange(n_lat), torch.as_tensor(lat_idx)] = 1.0
        tangent = basis.repeat_interleave(n, dim=0)  # (L·n, T)
        cond_rep = cond.expand(n_lat * n, n_tok)
        eps0 = 1.0e-3
        dt = (1.0 - eps0) / steps
        with torch.no_grad():
            state = {"v": (torch.cat([theta, xs], dim=1) - mu) / sd,
                     "ld": torch.zeros(n, device=dev),
                     "t": torch.zeros((), device=dev)}

            def step():
                v, t = state["v"], state["t"]
                with forward_ad.dual_level():
                    u = forward_ad.make_dual(v.repeat(n_lat, 1), tangent)
                    s = model.score(u, t.expand(n_lat * n), cond_rep,
                                    self._mask)
                    drift, ddrift = forward_ad.unpack_dual(
                        -0.5 * sde.beta(t) * (u + s) * lat)
                div = (ddrift * tangent).sum(1).view(n_lat, n).sum(0)
                state["ld"].copy_(state["ld"] + div * dt)
                v.copy_(v + drift[:n] * dt)

            run = _graphed(step, state, dev) if self._use_graph(
                graphed) else step
            for i in range(steps):
                state["t"].fill_(eps0 + i * dt)
                run()
            v1 = state["v"]
            # the t = 1 marginal of the VPSDE is (numerically) standard normal
            logp1 = (lat * (-0.5 * v1**2 - 0.5 * math.log(2.0 * math.pi))
                     ).sum(1)
            return logp1 + state["ld"] - (lat * torch.log(sd)).sum()

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        """The JAX package's layout: plain Python and numpy."""
        return {
            "kind": "simformer",
            "config": asdict(self.model.cfg),
            "sde": {"beta_min": self.model.sde.beta_min,
                    "beta_max": self.model.sde.beta_max},
            "params": params_to_numpy(self.model.params()),
            "standardizer": {
                "mu": np.asarray(self.std["mu"], np.float32),
                "sd": np.asarray(self.std["sd"], np.float32),
                "n_theta": int(self.std["n_theta"]),
                "n_x": int(self.std["n_x"]),
            },
            "attn_mask": self.attn_mask,
            "n_steps": int(self.n_steps),
        }

    @classmethod
    def from_state_dict(cls, state: dict, *, device) -> "SimformerPosterior":
        model = Simformer(SimformerConfig(**state["config"]),
                          VPSDE(**state["sde"]), device=device)
        return cls(model, state["params"], dict(state["standardizer"]),
                   attn_mask=state["attn_mask"], n_steps=state["n_steps"])

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.state_dict(), f)

    @classmethod
    def load(cls, path: str, *, device) -> "SimformerPosterior":
        """A saved model of either package. Load only files you trust:
        unpickling can run code."""
        with open(path, "rb") as f:
            return cls.from_state_dict(pickle.load(f), device=device)


def train_noise_model_simformer(mags, log_errs,
                                generator: torch.Generator | None = None, *,
                                device, **train_kwargs):
    """Learn p(log σ | mag) as a simformer task: θ tokens are the per-band
    log-errors, x tokens the magnitudes, with full attention. Returns
    (model, posterior); `posterior.sample(mags, n)` draws error vectors
    conditioned on a magnitude vector."""
    mags = np.atleast_2d(np.asarray(mags, np.float32))
    log_errs = np.atleast_2d(np.asarray(log_errs, np.float32))
    n_theta, n_x = log_errs.shape[1], mags.shape[1]
    model = Simformer(SimformerConfig(n_tokens=n_theta + n_x, d_model=64,
                                      n_heads=4, n_layers=2), device=device)
    params, std, _ = train_simformer(model, log_errs, mags, generator,
                                     **train_kwargs)
    return model, SimformerPosterior(model, params, std, n_steps=300)


def block_attn_mask(n_theta: int, n_x: int, kind: str = "full"):
    """Attention masks over [θ | x] tokens: "full" or "causal" (x tokens
    attend to θ and earlier x; θ attends to θ)."""
    t = n_theta + n_x
    if kind == "full":
        return np.ones((t, t), dtype=bool)
    if kind == "causal":
        m = np.zeros((t, t), dtype=bool)
        m[:n_theta, :n_theta] = True
        for i in range(n_x):
            m[n_theta + i, : n_theta + i + 1] = True
        return m
    raise ValueError(kind)
