"""Plain neural posterior estimator: a support-aware coupling
rational-quadratic-spline flow (Durkan et al. 2019), its NPE loss, and the
optimiser step the configuration trains it with (global-norm clip per
member, then AdamW).

A frozen, plain-PyTorch statement of the model, in any dtype the caller
passes (the benchmark replays steps in float64). Parameters are nested
dicts and lists of tensors with a leading member axis K:
{"flow": {"blocks": [[{"w": (K, out, in), "b": (K, out)}, ...] per
transform]}, "theta_mean", "theta_std", "x_mean", "x_std": (K, D) or
(K, C)}. Imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MIN_W = 1.0e-3
MIN_D = 1.0e-3
D_OFFSET = float(np.log(np.expm1(1.0 - MIN_D)))
SUPPORT_EPS = 1.0e-6
PERM_SEED = 7


def leaves(tree) -> list:
    """Tensors of a nested dict/list tree in key order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def rqs_forward(x, raw, n_bins: int, tail: float):
    """Elementwise RQ spline with linear tails: (y, log|dy/dx|)."""
    sizes = raw[..., :2 * n_bins].unflatten(-1, (2, n_bins))
    sizes = MIN_W + (1.0 - MIN_W * n_bins) * torch.softmax(sizes, dim=-1)
    zero = torch.zeros_like(sizes[..., :1])
    knots = torch.cat([zero, torch.cumsum(sizes, dim=-1)], dim=-1)
    cumw, cumh = (2.0 * tail * knots - tail).unbind(dim=-2)
    widths, heights = (2.0 * tail * sizes).unbind(dim=-2)
    d = MIN_D + F.softplus(raw[..., 2 * n_bins:] + D_OFFSET)
    one = torch.ones_like(d[..., :1])
    d = torch.cat([one, d[..., 1:-1], one], dim=-1)
    inside = (x > -tail) & (x < tail)
    xc = torch.clamp(x, -tail, tail)
    idx = torch.searchsorted(cumw.detach().contiguous(),
                             xc.detach().unsqueeze(-1).contiguous(),
                             right=True) - 1
    idx = idx.clamp(0, n_bins - 1)

    def pick(t):
        return torch.gather(t, -1, idx).squeeze(-1)

    xk, wk, hk, yk = (pick(cumw[..., :-1]), pick(widths), pick(heights),
                      pick(cumh[..., :-1]))
    dk, dk1 = pick(d[..., :-1]), pick(d[..., 1:])
    sk = hk / wk
    xi = torch.clamp((xc - xk) / wk, 0.0, 1.0)
    xi1m = 1.0 - xi
    denom = sk + (dk1 + dk - 2.0 * sk) * xi * xi1m
    y = yk + hk * (sk * xi * xi + dk * xi * xi1m) / denom
    logdet = (2.0 * torch.log(sk)
              + torch.log(dk1 * xi * xi + 2.0 * sk * xi * xi1m
                          + dk * xi1m * xi1m)
              - 2.0 * torch.log(denom))
    return torch.where(inside, y, x), torch.where(inside, logdet, 0.0)


class NSF:
    """q(θ | x) of a coupling NSF with `num_transforms` blocks (each a
    permutation, then the second half splined with parameters from a ReLU
    MLP of the first half and the standardised context), over the logit of
    θ in the support box [lo, hi], standardised."""

    def __init__(self, theta_dim: int, context_dim: int, num_transforms: int,
                 num_bins: int, tail_bound: float, support, device,
                 round_fn=None):
        # round_fn: applied to both operands of every matrix product (the
        # control's lower precision), with the gradient passed straight
        self.round_fn = round_fn
        self.dim, self.ctx = int(theta_dim), int(context_dim)
        self.n_t, self.n_bins = int(num_transforms), int(num_bins)
        self.tail = float(tail_bound)
        self.half_a = self.dim // 2
        self.half_b = self.dim - self.half_a
        rng = np.random.default_rng(PERM_SEED)
        perms = []
        for t in range(self.n_t):
            perms.append(rng.permutation(self.dim) if t % 2 == 0
                         else perms[-1][::-1].copy())
        self.perms = [torch.as_tensor(p, device=device) for p in perms]
        self.lo, self.hi = (torch.as_tensor(np.asarray(v, np.float32),
                                            device=device) for v in support)

    def log_prob(self, params, theta, x):
        """θ (K, B, D), x (K, B, C) -> (K, B) log q(θ|x) in θ's units."""
        dt = params["theta_mean"].dtype
        lo, hi = self.lo.to(dt), self.hi.to(dt)
        p = torch.clamp((theta.to(dt) - lo) / (hi - lo), SUPPORT_EPS,
                        1.0 - SUPPORT_EPS)
        ldj = (-torch.log(hi - lo) - torch.log(p) - torch.log1p(-p)).sum(-1)
        u = torch.log(p) - torch.log1p(-p)
        h = ((u - params["theta_mean"].unsqueeze(1))
             / params["theta_std"].unsqueeze(1))
        xs = ((x.to(dt) - params["x_mean"].unsqueeze(1))
              / params["x_std"].unsqueeze(1))
        total = torch.zeros(h.shape[:-1], dtype=dt, device=h.device)
        for t in range(self.n_t):
            h = h[..., self.perms[t]]
            ta, tb = h[..., :self.half_a], h[..., self.half_a:]
            a = torch.cat([ta, xs], dim=-1)
            layers = params["flow"]["blocks"][t]
            for i, layer in enumerate(layers):
                w = layer["w"]
                if self.round_fn is not None:
                    a = a + (self.round_fn(a.detach()) - a.detach())
                    w = w + (self.round_fn(w.detach()) - w.detach())
                a = torch.baddbmm(layer["b"].unsqueeze(1), a,
                                  w.transpose(1, 2))
                if i < len(layers) - 1:
                    a = torch.relu(a)
            raw = a.reshape(a.shape[:-1] + (self.half_b, -1))
            yb, ld = rqs_forward(tb, raw, self.n_bins, self.tail)
            h = torch.cat([ta, yb], dim=-1)
            total = total + ld.sum(-1)
        lp = (total - 0.5 * (h * h).sum(-1)
              - 0.5 * self.dim * math.log(2.0 * math.pi))
        return lp - torch.log(params["theta_std"]).sum(-1,
                                                       keepdim=True) + ldj


def npe_loss(flow: NSF, params, theta, x):
    """(K,) −mean log q(θ|x) per member."""
    return -flow.log_prob(params, theta, x).mean(dim=-1)


class AdamW:
    """Global-norm clip per member, then AdamW (β 0.9, 0.999, ε 1e-8),
    over a parameter tree; one learning rate per member."""

    def __init__(self, params, lrs, clip: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1.0e-8):
        self.lrs, self.clip, self.wd = lrs, float(clip), float(weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in leaves(params)]
        self.v = [torch.zeros_like(p) for p in leaves(params)]
        self.t = 0

    def clipped(self, grads: list) -> list:
        k = grads[0].shape[0]
        norm = torch.sqrt(sum(g.reshape(k, -1).square().sum(1)
                              for g in grads))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        return [g * scale.reshape(-1, *([1] * (g.ndim - 1))) for g in grads]

    def step(self, params_leaves: list, grads: list) -> list:
        """New leaves after one step; `grads` already clipped."""
        self.t += 1
        out = []
        for i, (p, g) in enumerate(zip(params_leaves, grads)):
            self.m[i] = self.b1 * self.m[i] + (1.0 - self.b1) * g
            self.v[i] = self.b2 * self.v[i] + (1.0 - self.b2) * g * g
            upd = ((self.m[i] / (1.0 - self.b1 ** self.t))
                   / (torch.sqrt(self.v[i] / (1.0 - self.b2 ** self.t))
                      + self.eps))
            if self.wd:
                upd = upd + self.wd * p
            lr = self.lrs.to(p.dtype).reshape(-1, *([1] * (p.ndim - 1)))
            out.append(p - lr * upd)
        return out


def unflatten(template, flat: list):
    """`template`'s tree with its leaves replaced, in `leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(template)
