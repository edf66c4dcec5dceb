"""Sample-wave accumulation: the renderer's entry points.

Counterpart of ``rust_ray_tracer_tpu/ops/integrator.py``
(``render_waves`` and ``render_image``, ``integrator.py:545-622``) on the
whole-wave trace route only: every wave goes through
:func:`ops.uber.trace_wave_uber`, which runs the Hopper trace kernel for a
scene on a CUDA device and its plain version for a scene on the CPU.
The render is differentiable: the scene tables are built inside the
autograd graph, and when a scene leaf requires grad each wave's trace
runs as :class:`ops.uber.TraceWave`, whose backward is the trace's
adjoint (a second kernel on the card).
"""

from __future__ import annotations

import torch

from rust_ray_tracer_tpu_torch.ops import camera as cam_ops
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.utils import rng as rngu

MAX_DEPTH = 4   # main.rs:56


def render_waves(scene, width: int, height: int, key, wave_start: int,
                 n_waves: int, depth: int = MAX_DEPTH,
                 chunk_size: int = 32768, acc0=None, compact: bool = False):
    """Sum of ``n_waves`` one-sample-per-pixel radiance images added onto
    ``acc0`` (zeros if None), [H, W, 3] on the scene's device.

    Wave w uses ``fold_in(key, w)``, and the waves are added in the order
    ``(((acc0 + w0) + w1) + ...)``, so continuing from a partial sum with
    ``wave_start=k`` reproduces the monolithic sum bitwise.
    """
    if compact:
        raise NotImplementedError(
            "compact wavefront not ported yet (ROADMAP queue 1 item 14)")
    n = width * height
    ctx = uber.make_ctx(scene)
    key = key.to(scene.device)

    def one_wave(wave_i):
        wkey = rngu.wave_key(key, wave_i)
        rows = uber.trace_wave_uber(scene, wkey, width, height, depth,
                                    chunk_size, ctx=ctx)[:n]
        return cam_ops.image_from_positions(rows, width, height)

    acc = acc0
    if acc is None:
        acc = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=scene.device)
    for i in range(n_waves):
        acc = acc + one_wave(wave_start + i)
    return acc


def render_image(scene, width: int, height: int, spp: int, key,
                 depth: int = MAX_DEPTH, chunk_size: int = 32768):
    """Mean radiance image [H, W, 3] (pre-tonemap), row y=0 at the top of
    the camera frame; utils.image applies the reference's vertical flip
    at write time (main.rs:108)."""
    acc = render_waves(scene, width, height, key, 0, spp, depth, chunk_size)
    return acc / spp
