"""He-initialised dense stacks with a leading member axis.

Counterpart of `synference_tpu/flows/mlp.py`. A stack is a list of
`{"w": (K, out, in), "b": (K, out)}` layers for K ensemble members; it is
applied to `(K, B, in)` inputs with one `torch.baddbmm` per layer, so K
members cost K times the arithmetic of one but the launches of one. K = 1 is
the same code. The last layer starts at zero, which makes every flow built on
these stacks start at the identity map.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mlp_init", "mlp_apply"]


def mlp_init(generator: torch.Generator, sizes, n_members: int,
             zero_last: bool = True) -> list:
    """Dense stack for `n_members` members on the generator's device;
    `sizes` = [in, hidden..., out]. Weights ~ N(0, 2/fan_in), zero biases."""
    dev = generator.device
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = math.sqrt(2.0 / a) * torch.randn(
            (n_members, b, a), generator=generator, device=dev)
        layers.append({"w": w, "b": torch.zeros((n_members, b), device=dev)})
    if zero_last:
        layers[-1]["w"] = torch.zeros_like(layers[-1]["w"])
    return layers


def mlp_apply(layers: list, x: torch.Tensor,
              activation=torch.relu) -> torch.Tensor:
    """(K, B, in) -> (K, B, out); `activation` on every layer but the last.
    Inputs with more than one batch axis, (K, ..., in), are applied as
    (K, B, in) and given back in their shape."""
    shape = x.shape
    h = x.reshape(shape[0], -1, shape[-1])
    for i, layer in enumerate(layers):
        h = torch.baddbmm(layer["b"].unsqueeze(1), h,
                          layer["w"].transpose(1, 2))
        if i < len(layers) - 1:
            h = activation(h)
    return h.reshape(shape[:-1] + h.shape[-1:])
