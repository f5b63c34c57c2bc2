"""Flow wrapper: standardisation, the prior-box support transform, and the
parameter tree.

Counterpart of `synference_tpu/flows/base.py`. `ConditionalFlow` z-scores θ
and x with statistics taken from the training set (population standard
deviation, floored at 1e-6) and folds the Jacobian into `log_prob`; with
`support_low`/`support_high` the flow models u = logit((θ−lo)/(hi−lo)), so
every sample lies inside the prior box.

Parameters are a nested dict/list of tensors in the JAX package's layout:
`{"flow": ..., "theta_mean", "theta_std", "x_mean", "x_std"}`, where "flow"
is the family's own tree (`{"blocks": [...]}` for the coupling, MAF and
monotone flows, with "g" beside it for "unaf"; `{"mlp": [...]}` for "mdn";
`{"layers": [...]}` for "gf" and "cnf"), plus `"embed": [{"w", "b"}, ...]` with an embedding
net (`embedding_dim`, `embedding_hidden`, `embedding_layers`): a He-initialised
ReLU MLP that maps the standardised context to `embedding_dim` features
before the flow's conditioners (for high-dimensional contexts such as
spectra). Stacked parameters carry a leading member axis on every
leaf (`theta_mean` is then 2-D); methods given stacked parameters return
results with that axis in front, methods given one member's parameters
return them without it. `params_from_numpy` / `params_to_numpy` carry a tree
between the packages.

Every name of the JAX zoo is built, with its defaults: "maf", "made" (one
MAF block), "nsf", "realnvp" / "affine_coupling", "nice" (affine coupling
with the log-scale clamped to 0), "mdn", "gaussian" (one component), "ncsf",
"naf", "unaf", "sospf", "gf" and "cnf". Sampling moves base draws through
the flow's inverse: standard normals, uniforms on the box for "ncsf", and for
"mdn"/"gaussian" normals followed by one uniform per mixture component.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .cnf import make_cnf
from .maf import make_maf
from .mdn import make_mdn
from .mlp import mlp_apply, mlp_init
from .monotone import make_gf, make_naf, make_sospf, make_unaf
from .nsf import make_affine_coupling, make_ncsf, make_nsf

__all__ = ["ConditionalFlow", "build_flow", "flatten_params",
           "unflatten_params", "params_from_numpy", "params_to_numpy",
           "tree_map", "tree_leaves", "tree_unflatten", "module_params",
           "load_module_params"]

# the JAX package's registry (`ConditionalFlow.__post_init__`)
_MAKERS = {"maf": make_maf, "made": make_maf, "nsf": make_nsf,
           "realnvp": make_affine_coupling,
           "affine_coupling": make_affine_coupling,
           "nice": make_affine_coupling, "mdn": make_mdn, "gaussian": make_mdn,
           "ncsf": make_ncsf, "naf": make_naf, "unaf": make_unaf,
           "sospf": make_sospf, "gf": make_gf, "cnf": make_cnf}


def _make_net(model: str, dim: int, context_dim: int, cfg: dict, device):
    """The density estimator of a registry name, with the JAX package's
    defaults ("made" one block, "gaussian" one component, "nice" no
    scale)."""
    if model not in _MAKERS:
        raise ValueError(f"unknown flow model {model!r}")
    cfg = dict(cfg, device=device)
    if model == "made":
        cfg.setdefault("num_transforms", 1)
    elif model == "gaussian":
        cfg.setdefault("num_components", 1)
    elif model == "nice":
        cfg["clamp_log_scale"] = 0.0
    return _MAKERS[model](dim, context_dim, **cfg)


# -- parameter trees ----------------------------------------------------
def tree_map(fn, tree, *rest):
    """Apply `fn` to every leaf of a nested dict/list (and to the matching
    leaves of `rest`), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _leaves_with_path(tree, path=()):
    """(path string, leaf) pairs in the JAX package's order: dict keys
    sorted, list items in sequence."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (f"['{k}']",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in _leaves_with_path(tree)]


def flatten_params(params) -> dict:
    """Tree -> {path: np.ndarray}, with the JAX package's key strings."""
    return {key: np.asarray(leaf.detach().cpu())
            for key, leaf in _leaves_with_path(params)}


def tree_unflatten(template, leaves):
    """A tree of `template`'s structure from leaves in `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), _sorted(template))


def _sorted(tree):
    """The tree with dict keys in sorted order, the order of the leaves."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted(v) for v in tree]
    return tree


def unflatten_params(template, flat: dict):
    """Inverse of `flatten_params` given a tree of the same structure; the
    leaves land on the template leaves' device."""
    return tree_unflatten(template, [
        torch.as_tensor(flat[key], dtype=leaf.dtype, device=leaf.device)
        for key, leaf in _leaves_with_path(template)])


def params_from_numpy(tree, device):
    """The JAX package's parameter tree (nested dicts/lists of arrays, with
    or without the leading member axis) as float32 tensors on `device`
    (copies: the tensors never alias the arrays)."""
    return tree_map(lambda a: torch.tensor(
        np.asarray(a), dtype=torch.float32, device=device), tree)


def params_to_numpy(tree):
    """Inverse of `params_from_numpy`: the same tree of numpy arrays."""
    return tree_map(lambda a: np.asarray(a.detach().cpu()), tree)


def module_params(module: torch.nn.Module):
    """An `nn.Module`'s parameters as the JAX package's tree: a module is a
    dict of its parameters and submodules by attribute name, a
    `ModuleList` a list. The leaves are the parameters themselves."""
    if isinstance(module, torch.nn.ModuleList):
        return [module_params(m) for m in module]
    tree = dict(module._parameters)
    tree.update({name: module_params(m)
                 for name, m in module._modules.items()})
    return tree


def load_module_params(module: torch.nn.Module, tree) -> None:
    """Copy the JAX package's parameter tree (numpy arrays or tensors, in
    the layout `module_params` gives) into `module`'s parameters."""
    mine = list(_leaves_with_path(module_params(module)))
    theirs = list(_leaves_with_path(tree))
    if [k for k, _ in mine] != [k for k, _ in theirs]:
        raise ValueError("parameter tree does not match the module's layout")
    with torch.no_grad():
        for (_, p), (_, a) in zip(mine, theirs):
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu()
            a = torch.as_tensor(np.array(a), dtype=p.dtype)
            if a.shape != p.shape:
                raise ValueError(f"shape {tuple(a.shape)} for a parameter "
                                 f"of shape {tuple(p.shape)}")
            p.copy_(a)


# -- the flow -----------------------------------------------------------
@dataclass
class ConditionalFlow:
    """A conditional density estimator q(θ | x) with input standardisation.

    Attributes:
        model: a name of the registry (see the module docstring).
        theta_dim / context_dim: dimensions.
        config: the model's hyperparameters (hidden_features,
            num_transforms, ... as the JAX package names them), the optional
            support bounds and the optional embedding net (embedding_dim,
            embedding_hidden = 128, embedding_layers = 2).
        device: where the flow's constants live and its samples are drawn.
    """

    model: str
    theta_dim: int
    context_dim: int
    config: dict = field(default_factory=dict)
    device: object = field(kw_only=True)

    _SUPPORT_EPS = 1.0e-6

    def __post_init__(self):
        self.device = torch.device(self.device)
        cfg = dict(self.config)
        self._embed_dim = cfg.pop("embedding_dim", None)
        self._embed_hidden = int(cfg.pop("embedding_hidden", 128))
        self._embed_layers = int(cfg.pop("embedding_layers", 2))
        lo = cfg.pop("support_low", None)
        hi = cfg.pop("support_high", None)
        if (lo is None) != (hi is None):
            raise ValueError("support_low/support_high must come together")
        self._support = None
        if lo is not None:
            lo = np.asarray(lo, np.float32)
            hi = np.asarray(hi, np.float32)
            if lo.shape != (self.theta_dim,) or hi.shape != (self.theta_dim,):
                raise ValueError("support bounds must be (theta_dim,)")
            if not (lo < hi).all():
                raise ValueError("support_low must be < support_high")
            self._support = (torch.as_tensor(lo, device=self.device),
                             torch.as_tensor(hi, device=self.device))
        flow_ctx = int(self._embed_dim or self.context_dim)
        self._net = _make_net(self.model, self.theta_dim, flow_ctx, cfg,
                              self.device)

    # -- support (prior box) transform -----------------------------------
    def _unit(self, theta):
        lo, hi = self._support
        return torch.clamp((theta - lo) / (hi - lo), self._SUPPORT_EPS,
                           1.0 - self._SUPPORT_EPS)

    def _to_unbounded(self, theta):
        p = self._unit(theta)
        return torch.log(p) - torch.log1p(-p)

    def _from_unbounded(self, u):
        lo, hi = self._support
        return lo + (hi - lo) * torch.sigmoid(u)

    def _support_log_det(self, theta):
        """Σ log|du/dθ|, the logit Jacobian."""
        lo, hi = self._support
        p = self._unit(theta)
        return (-torch.log(hi - lo) - torch.log(p) - torch.log1p(-p)).sum(-1)

    # ------------------------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def init(self, generator: torch.Generator, theta_data=None, x_data=None,
             n_members: int | None = None) -> dict:
        """Initial parameters, standardisation statistics from the training
        data. `n_members=None` gives one member's parameters without the
        member axis, an int gives stacked parameters."""
        k = 1 if n_members is None else int(n_members)

        def stats(data, dim):
            if data is None or dim == 0:
                mean, std = torch.zeros(dim), torch.ones(dim)
            else:
                data = self._tensor(data)
                mean = data.mean(0)
                std = torch.clamp(data.std(0, correction=0), min=1.0e-6)
            return (mean.to(self.device).expand(k, dim).clone(),
                    std.to(self.device).expand(k, dim).clone())

        if theta_data is not None and self._support is not None:
            theta_data = self._to_unbounded(self._tensor(theta_data))
        tm, ts = stats(theta_data, self.theta_dim)
        xm, xs = stats(x_data, self.context_dim)
        params = {"flow": self._net.init(generator, k), "theta_mean": tm,
                  "theta_std": ts, "x_mean": xm, "x_std": xs}
        if self._embed_dim is not None:
            sizes = ([self.context_dim]
                     + [self._embed_hidden] * self._embed_layers
                     + [int(self._embed_dim)])
            params["embed"] = mlp_init(generator, sizes, k, zero_last=False)
        return params if n_members is not None else _member(params, 0)

    @staticmethod
    def _stacked(params):
        """(stacked parameters, whether they came stacked)."""
        if params["theta_mean"].ndim == 2:
            return params, True
        return tree_map(lambda a: a.unsqueeze(0), params), False

    def _context(self, params, x):
        """x (B, C) or (K, B, C) -> the flow's (K, B, ·) context: x
        standardised and, with an embedding net, embedded."""
        x = self._tensor(x)
        if x.ndim < 3:
            x = torch.atleast_2d(x).unsqueeze(0)
        xs = (x - params["x_mean"].unsqueeze(1)) / params["x_std"].unsqueeze(1)
        if self._embed_dim is None:
            return xs
        layers = params["embed"]
        return mlp_apply(layers, xs.expand(layers[0]["w"].shape[0],
                                           *xs.shape[1:]))

    def _to_base(self, params, theta, x):
        theta = self._tensor(theta)
        if theta.ndim < 3:
            theta = torch.atleast_2d(theta).unsqueeze(0)
        ldj = 0.0
        if self._support is not None:
            ldj = self._support_log_det(theta)
            theta = self._to_unbounded(theta)
        z = ((theta - params["theta_mean"].unsqueeze(1))
             / params["theta_std"].unsqueeze(1))
        xs = self._context(params, x)
        k = z.shape[0]
        return z, xs.expand(k, *xs.shape[1:]), ldj

    def log_prob(self, params, theta, x):
        """log q(θ|x) in raw θ units. θ (B, D) and x (B, C), shared by the
        members, or (K, B, ·) with one batch per member. Returns (K, B) for
        stacked parameters, (B,) for one member's."""
        params, stacked = self._stacked(params)
        z, xs, ldj = self._to_base(params, theta, x)
        lp = (self._net.log_prob(params["flow"], z, xs)
              - torch.log(params["theta_std"]).sum(-1, keepdim=True) + ldj)
        return lp if stacked else lp[0]

    def to_base(self, params, theta, x):
        """The base-space point of each θ: what `sample` maps back to θ (a
        mixture density network has none)."""
        if not hasattr(self._net, "forward"):
            raise ValueError(f"model {self.model!r} has no base-space map")
        params, stacked = self._stacked(params)
        z, xs, _ = self._to_base(params, theta, x)
        h, _ = self._net.forward(params["flow"], z, xs)
        return h if stacked else h[0]

    def sample_batch(self, params, xs, n: int,
                     generator: torch.Generator | None = None, base=None):
        """xs (M, C) -> (M, n, D) draws in raw θ units, or (K, M, n, D) for
        stacked parameters. The base draws come from `generator` (on the
        flow's device) or are given as `base`, (K, M, n, ·) or (M, n, ·):
        D standard normals per draw, uniforms on [-tail_bound, tail_bound)
        for "ncsf", and for "mdn"/"gaussian" D normals followed by one
        uniform per component. With a support transform every draw lies
        strictly inside the prior box."""
        params, stacked = self._stacked(params)
        k = params["theta_mean"].shape[0]
        ctx = self._context(params, xs)  # (K, M, C)
        m, n = ctx.shape[1], int(n)
        shape = (k, m, n, self.theta_dim)
        if base is None:
            if generator is None:
                raise ValueError("sampling needs a generator or base draws")
            base = self._net.draw_base(generator, (k, m * n))
        else:
            base = self._tensor(base).reshape(k, m * n, -1)
        ctx = ctx.expand(k, m, -1).unsqueeze(2).expand(-1, -1, n, -1)
        z = self._net.inverse(params["flow"], base,
                              ctx.reshape(k, m * n, -1))
        u = (z * params["theta_std"].unsqueeze(1)
             + params["theta_mean"].unsqueeze(1))
        if self._support is not None:
            u = self._from_unbounded(u)
        u = u.reshape(shape)
        return u if stacked else u[0]

    def sample(self, params, x, n: int,
               generator: torch.Generator | None = None, base=None):
        """n draws conditioned on a single x (C,): (n, D), or (K, n, D) for
        stacked parameters."""
        x = self._tensor(x).reshape(1, -1)
        return self.sample_batch(params, x, n, generator, base).squeeze(-3)

    # -- serialisation ---------------------------------------------------
    def spec(self) -> dict:
        return {"model": self.model, "theta_dim": self.theta_dim,
                "context_dim": self.context_dim, "config": dict(self.config)}

    @classmethod
    def from_spec(cls, spec: dict, device) -> "ConditionalFlow":
        return cls(model=spec["model"], theta_dim=int(spec["theta_dim"]),
                   context_dim=int(spec["context_dim"]),
                   config=dict(spec.get("config", {})), device=device)


def _member(params, i: int):
    """Member i of stacked parameters, without the member axis."""
    return tree_map(lambda a: a[i], params)


def build_flow(model: str, theta_dim: int, context_dim: int, *, device,
               **config) -> ConditionalFlow:
    """Registry constructor with the JAX package's model names."""
    return ConditionalFlow(model=model, theta_dim=theta_dim,
                           context_dim=context_dim, config=config,
                           device=device)
