"""Data parallelism over GPUs, one process per GPU (counterpart of
nonrigid_nerf_tpu/parallel/). The process group that
`multihost.maybe_initialize()` brings up takes the place of the JAX
package's `make_mesh()`: the step and the renderers run over its ranks."""

from nonrigid_nerf_torch.parallel import multihost
from nonrigid_nerf_torch.parallel.mesh import (make_auto_renderer,
                                               make_parallel_renderer,
                                               make_parallel_train_step,
                                               parallel_train_step_from_batch)

__all__ = ["make_parallel_train_step", "parallel_train_step_from_batch",
           "make_parallel_renderer", "make_auto_renderer", "multihost"]
