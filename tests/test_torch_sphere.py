"""The split route's per-kind searches, TPU kernels N (the cluster-culled
sphere search) and L (the triangle search alone), against the JAX package
on the CPU, its Pallas kernels in interpret mode.

  * N: ``ops/sphere.sph_search_plain`` against ``pallas_sphere.sph_search``
    on the inputs the port's route gives it over two bounces of a 32x16
    wave of ``random`` with a 64x32 earth map (1,024 sphere rows in eight
    clusters, moving spheres among them; two 256-ray tiles a bounce; dead
    lanes on bounce 1), and on a scene of 104 spheres (the kernel pads 24
    far rows that give a NaN discriminant) with rays aimed at the origin,
    random times and dead lanes, 300 of them (a short last tile). Indices
    equal on every ray (measured: equal, and equal to a float64 replay's
    but on 4 of 481 hits, where both float32 packages find the ground
    sphere a hair past t_min). t cannot be held to an ulp of JAX's here:
    the discriminant ``b*b - a*c`` cancels (by ~1000x for a ray from 15
    units at a 0.4 sphere, by far more at random's radius-1000 ground),
    and XLA's CPU code contracts it into an FMA where the port rounds each
    product, as the kernel does. Measured: the port 3.0e-5 from JAX on the
    origin rays, 2.7e-4 on random's; from a float64 replay the port's
    largest and mean relative distances are 3.9e-5 and 2.3e-6 against
    JAX's 3.4e-5 and 2.2e-6 (origin rays), 3.7e-4 and 1.3e-5 against 3.7e-4
    and 1.2e-5 (random). So t is held to the float64 arbiter: the port no
    farther from it than 1.25x JAX, in the largest and the mean. On the
    card the kernel equals this plain version bitwise (``chip_smoke.py``).
  * L: ``ops/search.tri_search_plain`` (after the plain K) against
    ``pallas_intersect.tri_search`` on the inputs the port's route gives
    it over two bounces of a 32x16 wave of ``torch_parity.random_tris``
    (random's world and the flagship's 968 triangles in eight clusters,
    beside the 1,024 sphere rows). The same winners on every ray, t within
    1e-5 relative: JAX takes its Plücker dots as an f32 matmul, the port
    sums ten products in feature order (``tests/test_torch_search.py``
    measured 2.5e-6 for M, whose triangle test this is).
  * The scene with triangles beside the spheres rendered through
    ``render_waves`` (K, L, N, J, H a bounce) against JAX's TPU route in
    interpret mode at 32x18, 1 spp, depth 2, under
    ``torch_parity.assert_flips_arbitrated``: the flip budget of
    ``tests/test_uber.py`` with a float64 render of the port as the
    arbiter. random's marble ground amplifies a hit point's last ulp
    (ROADMAP queue 3), so paths fork in either package. Measured at
    seeds 0-3: flips counted 0, 1, 1, 1 of 576 pixels; pixels off float64
    (rtol 3e-4 / atol 3e-5) port 4, 10, 6, 7 against JAX 4, 9, 6, 7. At
    depth 3 the two packages leave float64 alike (32/31, 40/40, 38/34,
    43/42 pixels), but at seeds 1-3 they differ on 3-6 pixels where the
    port is not on float64's side, past the 0.5% budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_ray_tracer_tpu.models import builders as jb
from rust_ray_tracer_tpu.models import scene as JS
from rust_ray_tracer_tpu.ops import camera as jcam
from rust_ray_tracer_tpu.ops import intersect as jis
from rust_ray_tracer_tpu.ops import pallas_intersect as pim
from rust_ray_tracer_tpu.ops import pallas_sphere
from rust_ray_tracer_tpu.ops.integrator import render_waves as jax_render
from rust_ray_tracer_tpu_torch.models import builders as tb
from rust_ray_tracer_tpu_torch.models import scene as TS
from rust_ray_tracer_tpu_torch.models.scene import (combine, compile_scene,
                                                    partition)
from rust_ray_tracer_tpu_torch.ops import camera as tcam
from rust_ray_tracer_tpu_torch.ops import search, sphere, uber
from rust_ray_tracer_tpu_torch.ops.integrator import (render_waves,
                                                      split_reason)
from rust_ray_tracer_tpu_torch.utils import rng

from tests.torch_parity import (assert_flips_arbitrated, jax_compile,
                                random_tris, split_kernel_inputs,
                                write_earth_map)
from tests.torch_threads import torch_one_thread  # noqa: F401 (autouse)

T_RTOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pim, "INTERPRET", True)
    monkeypatch.setattr(pim, "on_tpu", lambda: True)


@pytest.fixture
def earth_dir(tmp_path, monkeypatch):
    """A working directory holding a 64x32 ``earthmap.jpg``."""
    write_earth_map(tmp_path, 64, 32)
    monkeypatch.chdir(tmp_path)
    return tmp_path



def _jax_sph(js, rays):
    r = jnp.asarray(rays.numpy())
    t, i = pallas_sphere.sph_search(js, r[0:3].T, r[3:6].T, r[6], r[7],
                                    r[8])
    return np.asarray(t), np.asarray(i)


def _assert_same_hits(got, ref, exact):
    """N's (t, index) ``got`` against JAX's ``ref``, with the float64
    replay ``exact`` as the arbiter of t: the indices equal on every ray,
    the same rays find a hit, and over the rays whose float64 winner is
    the same sphere the port's relative distance from float64 is at most
    1.25x JAX's, in the largest and in the mean. Returns the hit mask."""
    got_t, got_i = (x.numpy() for x in got)
    ref_t, ref_i = ref
    et, ei = (x.numpy() for x in exact)
    np.testing.assert_array_equal(got_i, ref_i)
    fin = np.isfinite(ref_t)
    np.testing.assert_array_equal(np.isfinite(got_t), fin)
    m = fin & np.isfinite(et) & (ei == got_i)
    assert m.sum() >= 0.95 * fin.sum()
    dg = np.abs(got_t[m] - et[m]) / np.abs(et[m])
    dr = np.abs(ref_t[m] - et[m]) / np.abs(et[m])
    assert dg.max() <= 1.25 * dr.max() and dg.mean() <= 1.25 * dr.mean()
    return fin


def _exact(rays, tab, cl_min, cl_max, n_sph, chunk=None):
    return sphere.sph_search_plain(rays.double(), tab.double(),
                                   cl_min.double(), cl_max.double(), n_sph,
                                   chunk)


def test_sph_search_matches_kernel_n(interpret, earth_dir, monkeypatch):
    js = jax_compile(jb.get_scene("random", 2.0), monkeypatch)
    ts = compile_scene(tb.get_scene("random", 2.0), device="cpu")
    assert ts.n_spheres == 1024 and ts.img_data.shape[0] == 1
    assert not uber.uber_eligible(ts) and split_reason(ts) is None
    rays, tab, cl_min, cl_max, n_sph, chunk, _ = split_kernel_inputs(
        ts, 32, 16, 2)["sph"]
    assert rays.shape == (9, 1024) and chunk == 512
    assert cl_min.shape == (8, 3)
    assert bool((rays[8] < rays[7]).any())            # dead lanes
    assert bool((ts.sph_c0 != ts.sph_c1).any())       # moving spheres
    got_t, got_i = sphere.sph_search_plain(rays, tab, cl_min, cl_max, n_sph,
                                           chunk)
    fin = _assert_same_hits((got_t, got_i), _jax_sph(js, rays),
                            _exact(rays, tab, cl_min, cl_max, n_sph, chunk))
    assert 0.3 < fin.mean() < 1.0
    # the cull skipped clusters: some tile enters fewer than all eight
    ent = search.tile_enter_plain(rays, cl_min, cl_max, chunk)
    assert bool((~torch.isfinite(ent)).any())


def _origin_host(S, cam_mod):
    """104 spheres (a whole number of the compiler's 8-row pads, so no
    zero-radius pad row sits at the origin), every third one moving,
    around the origin."""
    g = np.random.default_rng(3)
    grey = S.Lambertian.from_rgb(0.5, 0.5, 0.5)
    world = []
    for i in range(104):
        c = g.uniform(-6.0, 6.0, 3).astype(np.float32)
        if i % 3 == 0:
            world.append(S.MovingSphere(c, c + g.uniform(-0.5, 0.5, 3)
                                        .astype(np.float32), 0.0, 1.0, 0.4,
                                        grey))
        else:
            world.append(S.Sphere(c, float(g.uniform(0.2, 0.6)), grey))
    cam = cam_mod.make_camera(np.eye(3, 4, dtype=np.float32), 60.0, 1.0)
    return S.Scene(cam, world, [], (0.0, 0.0, 0.0))


def test_sph_search_pad_rows_and_dead_lanes(monkeypatch):
    """Rays aimed at the origin through a table that the kernel pads with
    far rows (104 rows, one cluster): no pad row is ever hit (a pad of
    radius 0 at the origin would give rays through it a phantom root);
    dead lanes find nothing."""
    monkeypatch.setattr(pim, "INTERPRET", True)
    js = jax_compile(_origin_host(JS, jcam), monkeypatch)
    ts = compile_scene(_origin_host(TS, tcam), device="cpu")
    assert ts.n_spheres == 104
    g = np.random.default_rng(5)
    n = 300
    o = g.normal(size=(n, 3)).astype(np.float32) * 9.0
    d = (-o * g.uniform(0.5, 2.0, (n, 1))).astype(np.float32)
    time = g.uniform(0.0, 1.0, n).astype(np.float32)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(np.arange(n) % 7 == 0, -1.0, np.inf).astype(np.float32)
    rays = torch.from_numpy(np.concatenate(
        [o.T, d.T, time[None], t_min[None], t_max[None]]))
    tab = sphere.sph_table(ts)
    assert tab.shape == (128, 12) and bool((tab[104:, 0] == sphere.FAR).all())
    got_t, got_i = sphere.sph_search_plain(
        rays, tab, ts.sph_cluster_min, ts.sph_cluster_max, ts.n_spheres)
    fin = _assert_same_hits((got_t, got_i), _jax_sph(js, rays),
                            _exact(rays, tab, ts.sph_cluster_min,
                                   ts.sph_cluster_max, ts.n_spheres))
    assert 0.1 < fin.mean() < 1.0
    assert not fin[t_max < 0].any() and (got_i.numpy()[t_max < 0] == 0).all()
    assert got_i.numpy().max() < 104                  # no pad row wins


def test_tri_search_matches_kernel_l(interpret, earth_dir, monkeypatch):
    js = jax_compile(random_tris(JS, jb, 2.0), monkeypatch)
    ts = compile_scene(random_tris(TS, tb, 2.0), device="cpu")
    assert ts.n_tris == 1024 and ts.n_spheres == 1024
    assert split_reason(ts) is None and not search.unified(ts)
    x = split_kernel_inputs(ts, 32, 16, 2)
    rays, ent, tabs, chunk = x["tri"]
    assert x["sph"] is not None and ent.shape == (4, 8)
    got_t, got_i = search.tri_search_plain(rays, ent, tabs, chunk)
    r = rays.numpy()
    o, d = jnp.asarray(r[0:3].T), jnp.asarray(r[3:6].T)
    det_c, u_c, v_c, t_c = jis._tri_coeffs(js.tri_v0, js.tri_e1, js.tri_e2)
    ref_t, ref_i = pim.tri_search(
        jis._ray_features(o, d), det_c, u_c, v_c, t_c, js.tri_double,
        jnp.asarray(r[7]), jnp.asarray(r[8]), o, d, js.tri_cluster_min,
        js.tri_cluster_max)
    ref_t, ref_i = np.asarray(ref_t), np.asarray(ref_i)
    fin = np.isfinite(ref_t)
    np.testing.assert_array_equal(np.isfinite(got_t.numpy()), fin)
    np.testing.assert_array_equal(got_i.numpy()[fin], ref_i[fin])
    np.testing.assert_allclose(got_t.numpy()[fin], ref_t[fin], rtol=T_RTOL)
    assert 0.02 < fin.mean() < 0.5


def test_tri_scene_renders_as_jax(interpret, earth_dir, monkeypatch):
    w, h = 32, 18
    js = jax_compile(random_tris(JS, jb, w / h), monkeypatch)
    ts = compile_scene(random_tris(TS, tb, w / h), device="cpu")
    got = render_waves(ts, w, h, rng.key(0, "cpu"), 0, 1, depth=2,
                       chunk_size=w * h).numpy()
    ref = np.asarray(jax_render(js, w, h, jax.random.PRNGKey(0), 0, 1,
                                depth=2, chunk_size=w * h))
    params, static = partition(ts)
    exact = render_waves(combine({k: v.double() for k, v in params.items()},
                                 static), w, h, rng.key(0, "cpu"), 0, 1,
                         depth=2, chunk_size=w * h).numpy()
    assert got.shape == (h, w, 3) and got.mean() > 0.05
    assert_flips_arbitrated(got, ref, exact)
