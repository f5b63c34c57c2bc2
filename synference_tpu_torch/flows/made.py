"""MADE: masked autoregressive dense networks (Germain et al. 2015).

Counterpart of `synference_tpu/flows/made.py`: the autoregressive
conditioner of the MAF and of the monotone flows. The masks are the JAX
package's, degree for degree, so its weights load unchanged. A block's
parameters are `{"w": [(K, out, in)], "b": [(K, out)], "cw": [(K, out, C)]}`
for K members; each layer is one `torch.baddbmm` over the masked weights and
the context weights side by side, applied to θ and the context side by side.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["made_masks", "made_init", "made_apply"]


def made_masks(dim: int, hidden: tuple, n_out_per_dim: int) -> list:
    """MADE masks for input degrees 1..dim and hidden degrees cycling
    1..dim-1; the output mask is strict, so output d depends only on inputs
    before d. Returns one float32 (out, in) numpy mask per layer."""
    degrees = [np.arange(1, dim + 1)]
    for h in hidden:
        degrees.append((np.arange(h) % max(dim - 1, 1)) + 1)
    masks = []
    for d_in, d_out in zip(degrees[:-1], degrees[1:]):
        masks.append((d_out[:, None] >= d_in[None, :]).astype(np.float32))
    out_deg = np.repeat(np.arange(1, dim + 1), n_out_per_dim)
    masks.append((out_deg[:, None] > degrees[-1][None, :]).astype(np.float32))
    return masks


def made_init(generator: torch.Generator, dim: int, context_dim: int,
              hidden: tuple, n_out_per_dim: int, n_members: int) -> dict:
    """One MADE block for `n_members` members on the generator's device:
    weights ~ N(0, 1/(fan_in + context_dim + 1)), zero biases, and a zero
    last layer (the flow starts near the identity)."""
    dev = generator.device
    sizes = [dim] + list(hidden) + [dim * n_out_per_dim]
    params = {"w": [], "b": [], "cw": []}
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        scale = 1.0 / math.sqrt(n_in + context_dim + 1)
        params["w"].append(scale * torch.randn(
            (n_members, n_out, n_in), generator=generator, device=dev))
        params["b"].append(torch.zeros((n_members, n_out), device=dev))
        params["cw"].append(scale * torch.randn(
            (n_members, n_out, context_dim), generator=generator, device=dev))
    params["w"][-1] = torch.zeros_like(params["w"][-1])
    params["cw"][-1] = torch.zeros_like(params["cw"][-1])
    return params


def made_apply(params: dict, masks: list, theta, context):
    """θ (K, B, dim), context (K, B, C) -> (K, B, dim·n_out_per_dim);
    `masks` are tensors on θ's device."""
    n_layers = len(params["w"])
    with_ctx = context is not None and params["cw"][0].shape[-1] > 0
    h = theta
    for i in range(n_layers):
        w = params["w"][i] * masks[i]
        if with_ctx:
            w = torch.cat([w, params["cw"][i]], dim=-1)
            h = torch.cat([h, context], dim=-1)
        h = torch.baddbmm(params["b"][i].unsqueeze(1), h, w.transpose(1, 2))
        if i < n_layers - 1:
            h = torch.relu(h)
    return h
