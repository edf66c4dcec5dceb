"""final_scene's image, the port against the JAX package, both against a
float64 replay.

The CLI's final_scene at 128x128, 4 spp reads a mean radiance of 0.22754
from the port and 0.22553 from the JAX package (0.89% apart): a handful of
paths fork onto the lamp (radiance 7 a sample) in one package and not the
other. A fork is float32 rounding of an ill-conditioned ray (a grazing
hit, a root's ``b*b - a*c`` from ~1000 units away), so neither package is
the reference: the float64 replay of the port (the same code on float64
tables and rays) is. At 64x36, 2 spp, chunk 1152, a pixel counts as off
when a channel differs from the replay's by more than 1e-3. Measured over
seeds 0-7: the port 59 pixels off, JAX 59 (per seed 7/6, 7/5, 5/5, 9/9,
8/9, 7/8, 7/7, 9/10); the image means scatter either way (seed 0: port
0.2135, JAX 0.2167, float64 0.2190; seed 7: 0.2444, 0.2484, 0.2316). So
the port is no farther from float64 than JAX is, and the CLI's 0.89% is
that scatter. The test holds the port's count over seeds 0-3 (28 and 25
pixels) to JAX's plus one pixel a render, the slack
``tests/test_torch_split.py`` allows at 32x18. JAX's render is jitted
once for the four keys (the same image, bit for bit, as the unjitted
call).
"""

import jax
import numpy as np

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.ops.integrator import render_waves as jax_render
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import jax_compile
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

W, H, SPP, CHUNK = 64, 36, 2, 1152
SEEDS = range(4)


def _off(img, ref):
    return int((np.abs(img - ref) > 1e-3).any(-1).sum())


def test_final_scene_no_farther_from_float64_than_jax(monkeypatch):
    js = jax_compile(jb.get_scene("final_scene", W / H), monkeypatch)
    ts = compile_scene(tb.get_scene("final_scene", W / H), device="cpu")
    params, static = partition(ts)
    t64 = combine({k: v.double() for k, v in params.items()}, static)
    jax_image = jax.jit(lambda sc, key: jax_render(sc, W, H, key, 0, SPP,
                                                   chunk_size=CHUNK))
    port = ref = 0
    for seed in SEEDS:
        got = render_waves(ts, W, H, rng.key(seed, "cpu"), 0, SPP,
                           chunk_size=CHUNK).numpy()
        exact = render_waves(t64, W, H, rng.key(seed, "cpu"), 0, SPP,
                             chunk_size=CHUNK).numpy()
        jx = np.asarray(jax_image(js, jax.random.PRNGKey(seed)))
        assert np.isfinite(got).all() and got.mean() > 0.1
        port += _off(got, exact)
        ref += _off(jx, exact)
    assert 0 < port <= ref + len(SEEDS), (port, ref)
