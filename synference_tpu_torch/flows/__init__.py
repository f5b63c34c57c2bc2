"""Normalizing-flow density estimators of the port.

Counterpart of `synference_tpu/flows/`. Only the neural spline flow ("nsf")
is ported; the other names of the zoo raise NotImplementedError naming
ROADMAP M11. A flow's parameters are a nested dict/list of tensors in the
JAX package's layout, each leaf with a leading member axis, so an ensemble is
one set of batched weights.
"""

from .base import (ConditionalFlow, build_flow, flatten_params,
                   params_from_numpy, params_to_numpy, unflatten_params)
from .nsf import make_nsf, rqs_forward, rqs_inverse

__all__ = ["ConditionalFlow", "build_flow", "flatten_params",
           "unflatten_params", "params_from_numpy", "params_to_numpy",
           "make_nsf", "rqs_forward", "rqs_inverse"]
