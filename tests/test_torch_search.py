"""The split route's triangle search (TPU kernels K and M) against the JAX
package on the CPU, its Pallas kernels in interpret mode.

  * K: ``ops/search.tile_enter_plain`` against
    ``pallas_intersect.tile_cluster_enter_pallas`` on the inputs the port's
    route gives it over two bounces of a 4,608-triangle mesh (36 clusters)
    at 32x18: the finite/+inf pattern equal and every entry within 1 ulp
    (measured: equal);
  * M: ``ops/search.fused_search_plain`` (after the plain K) against
    ``pallas_intersect.fused_search`` with ``on_tpu`` patched, on both of
    its grids (``RRT_PAIR=0``: the dense tile x cluster grid with its
    front-to-back survivor order; ``RRT_PAIR=1``: the pair list) and with
    its coefficients streamed or assembled in-kernel (``packed``), on a
    scene with 300 triangles in three clusters, spheres and quads, rays
    from the camera and from random points in random directions, dead
    lanes (t_max = -1), a ray count that is not a multiple of the 256-ray
    tile, and exact ties: a triangle copied into a second cluster (the
    lowest index wins), a triangle, a sphere and a quad at t = 4 exactly
    (the triangle wins), a sphere and a quad at t = 4 (the sphere wins).
    Kinds and indices are equal on every ray, and equal to a float64
    replay's (the same plain search on float64 tables and rays): no ray
    flips here. t within 1e-5 relative of JAX's and of the float64
    replay's. JAX takes its Plücker dots as an f32 matmul at HIGHEST
    precision, the port sums ten products in feature order; both carry the
    cancellation of a ray that starts near a triangle's plane (measured:
    the port 2.5e-6 from JAX, 5.0e-6 from float64; JAX 4.4e-6 from
    float64).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.scene import compile_scene
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import search
from rust_ray_tracer_tpu_torch.ops.integrator import render_waves
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import jax_compile, mesh, split_recorder
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

T_RTOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pim, "INTERPRET", True)
    monkeypatch.setattr(pim, "on_tpu", lambda: True)


def _pad(x, value):
    n = x.shape[0]
    target = -(-n // pim.BC) * pim.BC
    return np.concatenate([x, np.full((target - n,) + x.shape[1:], value,
                                      x.dtype)])


def test_tile_enter_matches_kernel_k(interpret):
    ts = compile_scene(mesh(TS, tcam, 4608), device="cpu")
    with split_recorder() as rec:
        render_waves(ts, 32, 18, rng.key(0, "cpu"), 0, 1, depth=2,
                     chunk_size=576)
    assert len(rec["enter"]) == 2
    for rays, cl_min, cl_max, chunk in rec["enter"]:
        got = search.tile_enter_plain(rays, cl_min, cl_max, chunk).numpy()
        r = rays.numpy()
        o, d = _pad(r[0:3].T, 0.0), _pad(r[3:6].T, 0.0)
        tmin, tmax = _pad(r[7], 0.0), _pad(r[8], -1.0)
        ref = np.asarray(pim.tile_cluster_enter_pallas(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(cl_min.numpy()),
            jnp.asarray(cl_max.numpy()), jnp.asarray(tmin),
            jnp.asarray(np.where(tmax < 0, -np.inf, tmax))))
        assert got.shape == ref.shape == (3, 36)
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert 0 < fin.mean() < 1
        ulps = np.abs(got[fin].view(np.int32).astype(np.int64)
                      - ref[fin].view(np.int32).astype(np.int64))
        assert ulps.max() <= 1


TIE_O = ((10.0, 0.0, 0.0), (12.5, 0.0, 0.0))


def _tie_host(S, cam_mod):
    """300 mesh triangles (three clusters of 128), a triangle, a sphere
    and a quad that the ray from (10, 0, 0) along -z meets at t = 4
    exactly, a sphere and a quad the ray from (12.5, 0, 0) meets at t = 4,
    and two more spheres and quads."""
    host = mesh(S, cam_mod, 300)
    grey = S.Lambertian.from_rgb(0.5, 0.5, 0.5)
    world = list(host.world) + [
        S.Triangle((9.5, -0.5, -4.0), (11.5, -0.5, -4.0), (9.5, 1.5, -4.0),
                   grey),
        S.Sphere((10.0, 0.0, -5.0), 1.0, grey),
        S.Quad((9.5, -0.5, -4.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), grey),
        S.Sphere((12.5, 0.0, -5.0), 1.0, grey),
        S.Quad((12.0, -0.5, -4.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), grey),
        S.Sphere((0.0, 0.0, -6.0), 0.5, grey),
        S.Sphere((0.5, 0.3, -3.0), 0.05, grey),
        S.Quad((-1.0, -1.0, -5.5), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), grey),
    ]
    return S.Scene(host.camera, world, host.lights, host.background)


def _boxes(v0, e1, e2, width):
    corners = np.stack([v0, v0 + e1, v0 + e2], 1)
    lo = corners.min(1).reshape(-1, width, 3).min(1)
    hi = corners.max(1).reshape(-1, width, 3).max(1)
    return lo.astype(np.float32), hi.astype(np.float32)


def _tie_scenes(monkeypatch):
    """(JAX SceneData, torch SceneData, (a, b)): the tie scene with the
    triangle at row a of cluster 0 copied to row b of cluster 1 (a < b),
    the cluster boxes recomputed."""
    js = jax_compile(_tie_host(JS, jcam), monkeypatch)
    ts = compile_scene(_tie_host(TS, tcam), device="cpu")
    tri = {k: np.asarray(getattr(js, k)).copy()
           for k in ("tri_v0", "tri_e1", "tri_e2")}
    for k, v in tri.items():
        np.testing.assert_array_equal(v, getattr(ts, k).numpy())
    a, b = 5, 130
    for v in tri.values():
        v[b] = v[a]
    lo, hi = _boxes(tri["tri_v0"], tri["tri_e1"], tri["tri_e2"], 128)
    lo[2], hi[2] = np.asarray(js.tri_cluster_min)[2], \
        np.asarray(js.tri_cluster_max)[2]        # its pad rows' inversion
    js = js._replace(tri_cluster_min=jnp.asarray(lo),
                     tri_cluster_max=jnp.asarray(hi),
                     **{k: jnp.asarray(v) for k, v in tri.items()})
    ts = dataclasses.replace(
        ts, tri_cluster_min=torch.from_numpy(lo),
        tri_cluster_max=torch.from_numpy(hi),
        **{k: torch.from_numpy(v) for k, v in tri.items()})
    return js, ts, (a, b)


def _tie_rays(ts, a):
    """Rays: at the copied triangle's centroid from just in front of it,
    the three-way and two-way ties, 400 from the camera into the mesh's
    box, 297 from random points in random directions; every 7th dead (t_max
    = -1). 700 rays: two whole tiles and a short one."""
    g = np.random.default_rng(3)
    v0, e1, e2 = (getattr(ts, k).numpy()[a].astype(np.float64)
                  for k in ("tri_v0", "tri_e1", "tri_e2"))
    cen = v0 + (e1 + e2) / 3.0
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm)
    # from just in front of the copied triangle, along its normal
    o = [cen + 0.05 * nrm, np.array(TIE_O[0]), np.array(TIE_O[1])]
    d = [-nrm, np.array([0.0, 0.0, -1.0]), np.array([0.0, 0.0, -1.0])]
    for _ in range(400):
        o.append(np.zeros(3))
        d.append(g.uniform([-1, -1, -5], [1, 1, -3]))
    for _ in range(297):
        o.append(g.uniform([-1.5, -1.5, -5.5], [1.5, 1.5, -2.5]))
        d.append(g.normal(size=3))
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    n = o.shape[0]
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(np.arange(n) % 7 == 6, -1.0, np.inf).astype(np.float32)
    t_max[:3] = np.inf
    time = g.uniform(0, 1, n).astype(np.float32)
    return o, d, time, t_min, t_max


@pytest.mark.parametrize("pair,packed", [("0", False), ("0", True),
                                         ("1", False), ("1", True)])
def test_fused_search_matches_kernel_m(pair, packed, interpret, monkeypatch):
    js, ts, (a, b) = _tie_scenes(monkeypatch)
    assert ts.n_tris == 384 and ts.tri_cluster_min.shape[0] == 3
    assert ts.n_spheres < 128 and ts.n_quads < 128 and search.unified(ts)
    o, d, time, t_min, t_max = _tie_rays(ts, a)
    monkeypatch.setenv("RRT_PAIR", pair)
    monkeypatch.setattr(pim, "INKERNEL_COEFFS", packed)
    ref_t, ref_k, ref_i = (np.asarray(x) for x in pim.fused_search(
        js, *(jnp.asarray(x) for x in (o, d, time, t_min, t_max))))
    rays = search.ray_planes(*(torch.from_numpy(x) for x in
                               (o, d, time, t_min, t_max)))
    tabs = search.search_tables(ts)
    got_t, got_k, got_i = (x.numpy() for x in search.search(rays, tabs))
    ex_t, ex_k, ex_i = (x.numpy() for x in search.search(
        rays.double(), search.SearchTables(**{
            k: v.double() if torch.is_tensor(v) else v
            for k, v in dataclasses.asdict(tabs).items()})))
    for k, i in ((ref_k, ref_i), (ex_k, ex_i)):
        np.testing.assert_array_equal(got_k, k)
        np.testing.assert_array_equal(got_i, i)
    fin = np.isfinite(ref_t)
    np.testing.assert_array_equal(np.isfinite(got_t), fin)
    for t in (ref_t, ex_t):
        np.testing.assert_allclose(got_t[fin], t[fin], rtol=T_RTOL, atol=0)
    # the ties: the lowest of the two copies; triangle > sphere > quad
    assert (got_k[0], got_i[0]) == (1, a)
    assert got_k[1] == 1 and got_t[1] == 4.0
    assert got_k[2] == 2 and got_t[2] == 4.0
    # every kind, several clusters, dead lanes found nothing
    assert set(got_k.tolist()) == {0, 1, 2, 3}
    assert len(np.unique(got_i[got_k == 1] // 128)) == 3
    assert (got_k[t_max < 0] == 0).all()
