"""Normalizing-flow density estimators of the port.

Counterpart of `synference_tpu/flows/`: the whole model zoo of the JAX
package ("maf", "made", "nsf", "realnvp"/"affine_coupling", "nice", "mdn",
"gaussian", "ncsf", "naf", "unaf", "sospf", "gf", "cnf"). A flow's parameters
are a nested dict/list of tensors in the JAX package's layout, each leaf with
a leading member axis, so an ensemble is one set of batched weights.
"""

from .base import (ConditionalFlow, build_flow, flatten_params,
                   params_from_numpy, params_to_numpy, unflatten_params)
from .cnf import make_cnf
from .made import made_apply, made_init, made_masks
from .maf import make_maf
from .mdn import make_mdn
from .monotone import make_gf, make_naf, make_sospf, make_unaf
from .nsf import (make_affine_coupling, make_ncsf, make_nsf, rqs_forward,
                  rqs_inverse)

__all__ = ["ConditionalFlow", "build_flow", "flatten_params",
           "unflatten_params", "params_from_numpy", "params_to_numpy",
           "make_maf", "make_nsf", "make_ncsf", "make_affine_coupling",
           "make_mdn", "make_naf", "make_unaf", "make_sospf", "make_gf",
           "make_cnf", "made_masks", "made_init", "made_apply",
           "rqs_forward", "rqs_inverse"]
