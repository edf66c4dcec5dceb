"""The split route past the trace kernel's 4,096 rows, against the JAX
package on the CPU: the slice of the unified search (TPU kernels K, M) and
the fused bounce (F, F').

  * A 4,608-triangle mesh (``torch_parity.mesh``: the flagship's draws and
    total area, 36 clusters of 128, and its sphere lamp; 4,609 rows) at
    32x18, 2 spp, depth 4, chunk 576 (two whole 256-ray tiles and a short
    one a chunk): the image against the JAX package's render under the
    flip budget of ``tests/test_uber.py`` (measured: no flip, 4.5e-7), and
    the gradient of ``mean(render_waves(...))`` by ``jax.vjp`` against
    torch autograd:
    every leaf within 1e-5 of the leaf's largest |gradient|, entry by
    entry (measured: at most 1.8e-6, on ``tex_color``), ``tri_v0``,
    ``tex_color``, the light's centre and radius and the camera non-zero.
    JAX runs its XLA route, the same function as its TPU route
    (``integrator.py:96-99``: the unified search and the fused bounce
    select and shade alike).
  * The fog scene with solid textures (``torch_parity.solid_fog``: media,
    a checker of solids), on M and F: the image against JAX's XLA route,
    32x32, 2 spp (its kernels M and F are held in interpret mode by
    ``tests/test_torch_search.py`` and ``tests/test_torch_bounce_fused.py``).
  * The two scenes that the split route refused before M and F were
    ported: a triangle beside a fog (unified search) and 4,100 quads (the
    quads by kernel O, the bounce by F); each against JAX's XLA route at
    8x8, 2 spp.
  * ``split_reason`` is None for all four.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.models.scene import combine as jcombine
from rust_ray_tracer_tpu.models.scene import partition as jpartition
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops.integrator import render_waves as jax_render
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import uber
from rust_ray_tracer_tpu_torch.ops.integrator import (make_split_tables,
                                                      render_waves,
                                                      split_reason)
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import assert_flip_budget, both, jax_compile, mesh
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

NONZERO = ("tri_v0", "tex_color", "light_c", "light_r", "camera.c2w")


def _split_scene(ts):
    assert not uber.uber_eligible(ts) and split_reason(ts) is None
    return make_split_tables(ts)


def test_mesh_image_and_grads_match_jax(monkeypatch):
    w, h, spp, chunk = 32, 18, 2, 576
    js = jax_compile(mesh(JS, jcam, 4608), monkeypatch)
    ts = compile_scene(mesh(TS, tcam, 4608), device="cpu")
    tables = _split_scene(ts)
    assert ts.n_tris + ts.n_spheres > uber.ROWS_MAX
    assert tables.search is not None and tables.fused
    # one forward and backward in each package: the image and the
    # gradient of its mean
    diff, static = jpartition(js)
    ref, vjp = jax.vjp(lambda d: jax_render(
        jcombine(d, static), w, h, jax.random.PRNGKey(0), 0, spp,
        chunk_size=chunk), diff)
    (g,) = vjp(jnp.full_like(ref, 1.0 / ref.size))
    g_ref = {k: np.asarray(getattr(g, k)) for k in g._fields
             if k != "camera"}
    g_ref.update({f"camera.{k}": np.asarray(v)
                  for k, v in g.camera._asdict().items()})
    params, static_t = partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    img = render_waves(combine(leaves, static_t), w, h, rng.key(0, "cpu"),
                       0, spp, chunk_size=chunk)
    img.mean().backward()
    got = img.detach().numpy()
    assert got.mean() > 0.05
    assert_flip_budget(got, np.asarray(ref))
    g_got = {k: (torch.zeros_like(v) if v.grad is None else v.grad).numpy()
             for k, v in leaves.items()}
    for k, g in g_got.items():
        assert np.isfinite(g).all(), k
        scale = np.abs(g_ref[k]).max(initial=0.0)
        np.testing.assert_array_less(np.abs(g - g_ref[k]),
                                     1e-5 * scale + 1e-12, err_msg=k)
    for k in NONZERO:
        assert np.abs(g_ref[k]).max() > 0 and np.abs(g_got[k]).max() > 0, k


def test_solid_fog_matches_jax_routes(monkeypatch):
    w, h, spp, chunk = 32, 32, 2, 512
    js, ts = both("solid_fog", monkeypatch)
    tables = _split_scene(ts)
    assert tables.search is not None and tables.fused
    got = render_waves(ts, w, h, rng.key(0, "cpu"), 0, spp,
                       chunk_size=chunk).numpy()
    ref = np.asarray(jax_render(js, w, h, jax.random.PRNGKey(0), 0, spp,
                                chunk_size=chunk))
    assert got.mean() > 0.05
    assert_flip_budget(got, ref)


def _lifted(S, cam_mod, name):
    """The scenes ``test_split_route_refuses_naming_what_is_missing``
    refused while TPU kernels M and F were not ported."""
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    grey = S.Lambertian.from_rgb(0.5, 0.5, 0.5)
    if name == "triangle_in_fog":
        fog = S.ConstantMedium.from_color(
            S.Sphere((0, 0, -4), 2.0, S.Dielectric(1.5)), 0.5, (1, 1, 1))
        world = [fog, S.Triangle((-1, -1, -5), (1, -1, -5), (0, 1, -5),
                                 grey)]
    else:
        world = [S.XYRect(i, i + 1, 0, 1, -9, grey) for i in range(4100)]
    return S.Scene(cam, world, [], (0.2, 0.3, 0.5))


@pytest.mark.parametrize("name", ["triangle_in_fog", "quads_4100"])
def test_lifted_refusals_render_as_jax(name, monkeypatch):
    js = jax_compile(_lifted(JS, jcam, name), monkeypatch)
    ts = compile_scene(_lifted(TS, tcam, name), device="cpu")
    tables = _split_scene(ts)
    assert (tables.search is not None) == (name == "triangle_in_fog")
    got = render_waves(ts, 8, 8, rng.key(0, "cpu"), 0, 2,
                       chunk_size=64).numpy()
    ref = np.asarray(jax_render(js, 8, 8, jax.random.PRNGKey(0), 0, 2,
                                chunk_size=64))
    assert got.mean() > 0.05
    assert_flip_budget(got, ref)
