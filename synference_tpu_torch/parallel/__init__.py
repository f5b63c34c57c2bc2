"""Multi-process generation, training and sampling on `torch.distributed`.

Counterpart of `synference_tpu/parallel/`. One process drives one device;
the processes form one process group (NCCL for "cuda", gloo for "cpu",
following the explicit device: `initialize_multihost`) and a `DeviceMesh`
(`make_mesh`) whose axes carry the JAX package's names, "data" and
"ensemble". Where the JAX package shards one global array over a mesh, a
rank here computes its own rows and the results are all-gathered, so every
rank ends with the whole result:

- generation: the θ batch splits along the sample axis; each rank runs the
  simulator on its rows (with their global row offset) and the outputs are
  all-gathered (`make_sharded_photometry_fn`, the z-sorted window engine
  with one global window plan in `make_sharded_zsorted_fn`,
  `sharded_generate`, whose library is bitwise the single-process one);
- training: members split over "ensemble", each minibatch over "data", the
  gradients averaged by `all_reduce` over "data" (`init_sharded_ensemble`,
  `make_sharded_train_step`);
- sampling: objects split over "data", padded to a multiple of its size
  (`sharded_sample_batch`, `sharded_fit_catalogue`).
"""

from .generate import (make_sharded_photometry_fn, make_sharded_zsorted_fn,
                       sharded_generate)
from .mesh import make_mesh, shard_along
from .multihost import global_mesh, initialize_multihost
from .sample import (make_sharded_sampler, pad_objects,
                     sharded_fit_catalogue, sharded_sample_batch)
from .train import (init_opt_state, init_sharded_ensemble,
                    make_sharded_train_step, place_batch)

__all__ = [
    "make_mesh",
    "shard_along",
    "make_sharded_photometry_fn",
    "make_sharded_zsorted_fn",
    "sharded_generate",
    "make_sharded_train_step",
    "init_sharded_ensemble",
    "init_opt_state",
    "place_batch",
    "make_sharded_sampler",
    "pad_objects",
    "sharded_sample_batch",
    "sharded_fit_catalogue",
    "initialize_multihost",
    "global_mesh",
]
