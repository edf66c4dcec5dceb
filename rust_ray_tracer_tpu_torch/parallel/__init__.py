"""Multi-process rendering over ``torch.distributed``: the sharded
renderer, its process group and render checkpoints.

Counterpart of ``rust_ray_tracer_tpu/parallel/``. Each rank renders its
round-robin share of every wave's pixel chunks on its own device through
the per-chunk path (``ops/integrator.render_chunk``: TPU kernel D on the
trace kernel's scenes), the slices are all-gathered, and under autograd
the scene cotangents are all-reduced — what JAX's ``shard_map`` transpose
generates.
"""

from rust_ray_tracer_tpu_torch.parallel.mesh import (  # noqa: F401
    RayMesh, make_mesh, multihost_init)
from rust_ray_tracer_tpu_torch.parallel.render import (  # noqa: F401
    render_image_sharded, render_waves_sharded, replicate_scene)
from rust_ray_tracer_tpu_torch.parallel.checkpoint import (  # noqa: F401
    RenderState, load_state, render_with_checkpoints, save_state)
