"""PyTorch + CUDA port of ``rust_ray_tracer_tpu``.

A wavefront path tracer whose whole-wave bounce loop runs in one CUDA
kernel written for Hopper (``csrc/trace_wave.cu``, built at first use by
``kernels/``). Plain PyTorch versions of every kernel sit beside them and
run for tensors on the CPU; they are what the tests hold against the JAX
package. The package imports torch and numpy, never JAX.

    from rust_ray_tracer_tpu_torch import compile_scene, render_image
    from rust_ray_tracer_tpu_torch.models import builders
    from rust_ray_tracer_tpu_torch.utils import rng
    scene = compile_scene(builders.cornell_box(1.0))   # on the card
    img = render_image(scene, 128, 128, 16, rng.key(0))

Scene gradients flow through ``torch.autograd``: the trace's backward is
a second Hopper kernel (``csrc/trace_wave_bwd.cu``).

    from rust_ray_tracer_tpu_torch.models.scene import combine, partition
    params, static = partition(scene)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    render_waves(combine(leaves, static), 64, 64, rng.key(0), 0, 1).mean() \
        .backward()

The entry points place their tensors on the card unless ``device="cpu"``
is passed, and raise when there is no card.
"""

from rust_ray_tracer_tpu_torch.models.scene import SceneData, compile_scene
from rust_ray_tracer_tpu_torch.ops.integrator import render_image

__all__ = ["SceneData", "compile_scene", "render_image"]
